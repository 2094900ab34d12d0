"""VMR-specified absorbing species (reference
``rust/sasktran2-rs/src/constituent/types/vmr_alt_absorber.rs``).

Extinction = vmr(z) * N_air(z) * cross_section(lambda, z); pure absorption
(no ssa/legendre contribution). Registers ``wf_<name>`` = d radiance / d vmr
on the constituent's own altitude grid via a linear interpolation matrix.

(Numpy copy of ``sasktran2_tpu/constituent/vmr_absorber.py:1-102`` for
the PyTorch port, pinned to the original by a test; ``VMRAbsorber2D``
waits for the port's 2D geometry.)
"""

from __future__ import annotations

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from ..util.state import EquationOfState
from .base import Constituent


class VMRAltitudeAbsorber(Constituent):
    def __init__(self, optical_property, altitudes_m, vmr):
        self.optical_property = optical_property
        self._altitudes = np.asarray(altitudes_m, dtype=np.float64)
        self.vmr = np.asarray(vmr, dtype=np.float64)

    @property
    def altitudes_m(self):
        return self._altitudes

    def _cross_section(self, atmo):
        """[A, W] cross section on the model grid."""
        return self.optical_property.cross_sections(
            atmo.wavelengths_nm,
            altitudes_m=atmo.model_geometry.altitudes(),
            pressure_pa=atmo.pressure_pa,
            temperature_k=atmo.temperature_k,
        )

    def _vmr_on_grid(self, atmo):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), "extend"
        )
        return interp @ self.vmr, interp

    def add_to_atmosphere(self, atmo):
        eos = EquationOfState(
            atmo.pressure_pa, atmo.temperature_k, atmo.specific_humidity
        )
        nd = eos.air_numberdensity["N"]
        xs = self._cross_section(atmo)  # [A, W]
        vmr_grid, _ = self._vmr_on_grid(atmo)
        k = vmr_grid[:, None] * nd[:, None] * xs
        atmo.storage.total_extinction += k

    def register_derivative(self, atmo, name: str):
        eos = EquationOfState(
            atmo.pressure_pa, atmo.temperature_k, atmo.specific_humidity
        )
        nd = eos.air_numberdensity["N"]
        xs = self._cross_section(atmo)
        vmr_grid, interp = self._vmr_on_grid(atmo)
        k_total = atmo.storage.total_extinction
        ssa = atmo.storage.ssa

        m = atmo.storage.get_derivative_mapping(f"wf_{name}")
        dk = nd[:, None] * xs  # d extinction / d vmr at model levels
        m.d_extinction[:] = dk
        # absorber: dssa/dvmr = -ssa dk / k
        with np.errstate(divide="ignore", invalid="ignore"):
            m.d_ssa[:] = np.where(k_total > 0, -ssa * dk / k_total, 0.0)
        # map model-level derivative onto the constituent's own grid:
        # wf on constituent grid = interp^T applied to level WFs
        m.interpolator = interp.T  # [n_const, n_model] after transpose
        m.interp_dim = f"{name}_altitude"

        # pressure/temperature weighting functions when the optical property
        # is parameter-dependent (reference vmr_alt_absorber.rs propagates
        # d xs/dT, d xs/dP from the database): d k / d T = vmr * (dN/dT * xs
        # + N * d xs/dT), same for pressure.
        if hasattr(self.optical_property, "cross_section_derivatives"):
            dxs = self.optical_property.cross_section_derivatives(
                atmo.wavelengths_nm,
                altitudes_m=atmo.model_geometry.altitudes(),
                pressure_pa=atmo.pressure_pa,
                temperature_k=atmo.temperature_k,
            )
            dn = eos.air_numberdensity
            dn_dparam = {
                "temperature_k": dn["dN_dT"], "pressure_pa": dn["dN_dP"],
            }
            for pname, dxs_dp in dxs.items():
                dkp = vmr_grid[:, None] * (
                    dn_dparam.get(pname, 0.0 * nd)[:, None] * xs
                    + nd[:, None] * dxs_dp
                )
                mp = atmo.storage.get_derivative_mapping(
                    f"wf_{name}_{pname}"
                )
                mp.d_extinction[:] += dkp
                with np.errstate(divide="ignore", invalid="ignore"):
                    mp.d_ssa[:] += np.where(
                        k_total > 0, -ssa * dkp / k_total, 0.0
                    )
                mp.interp_dim = "altitude"
