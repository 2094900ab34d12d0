"""Canned test scenarios (role of reference ``src/sasktran2/test_util/
scenarios.py:8``; profiles are synthetic, not copied).

(Copy of ``sasktran2_tpu/test_util/scenarios.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from ..atmosphere import Atmosphere
from ..util.interpolation import linear_interpolating_matrix


def default_pure_scattering_atmosphere(config, geometry, ssa=1.0, albedo=0.0):
    """Rayleigh-like scattering atmosphere in raw-input mode: exponential
    extinction profile with ~7 km scale height, Rayleigh phase, constant
    SSA and albedo."""
    atmosphere = Atmosphere(
        geometry,
        config,
        numwavel=1,
        calculate_derivatives=True,
    )
    alts = geometry.altitudes()
    extinction = 7e-5 * np.exp(-alts / 7000.0)

    atmosphere.storage.total_extinction[:] = extinction[:, None]
    atmosphere.storage.ssa[:] = ssa
    a1 = atmosphere.leg_coeff.a1
    a1[0] = 1.0
    a1[2] = 0.5
    atmosphere.surface.albedo[:] = albedo
    return atmosphere


def test_aerosol_constituent(altitude_grid_m, extinction_space=False):
    """A Gaussian stratospheric aerosol layer extinction profile [1/m]."""
    alts = np.asarray(altitude_grid_m, dtype=np.float64)
    return 1e-7 * np.exp(-(((alts - 22000.0) / 3000.0) ** 2))
