"""Emission constituents.

Roles of the reference's ``ThermalEmission`` (Planck from atmosphere
temperature, ``rust/sasktran2-rs/src/constituent/types/thermal_emission.rs``)
and ``VolumeEmissionRate`` (airglow-style isotropic VER,
``.../monochromatic_emission.rs``).

(Numpy copy of ``sasktran2_tpu/constituent/emission.py:1-107`` for the
PyTorch port; a test pins it to the original. The line-list and
population emission constituents need the spectroscopy and
photochemistry modules, which the port does not have yet.)
"""

from __future__ import annotations

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from .base import Constituent

H_PLANCK = 6.62607015e-34
C_LIGHT = 299792458.0
K_BOLTZMANN = 1.380649e-23


def planck_blackbody_radiance(wavelength_m, temperature_k):
    """Planck spectral radiance B_lambda [W / (m^2 sr m)]."""
    wl = np.asarray(wavelength_m, dtype=np.float64)
    t = np.asarray(temperature_k, dtype=np.float64)
    c1 = 2.0 * H_PLANCK * C_LIGHT**2
    c2 = H_PLANCK * C_LIGHT / K_BOLTZMANN
    return c1 / wl**5 / np.expm1(c2 / (wl * t))


class ThermalEmission(Constituent):
    """Planck thermal emission source from the atmosphere temperature
    profile. Fills ``storage.emission_source`` in radiance units."""

    def add_to_atmosphere(self, atmo):
        if atmo.temperature_k is None:
            msg = "ThermalEmission requires atmosphere.temperature_k"
            raise ValueError(msg)
        wl_m = atmo.wavelengths_nm * 1e-9
        atmo.storage.emission_source += planck_blackbody_radiance(
            wl_m[None, :], np.asarray(atmo.temperature_k)[:, None]
        )

    def register_derivative(self, atmo, name: str):
        # dB/dT for the temperature weighting function
        wl_m = atmo.wavelengths_nm * 1e-9
        t = np.asarray(atmo.temperature_k)[:, None]
        c2 = H_PLANCK * C_LIGHT / K_BOLTZMANN
        b = planck_blackbody_radiance(wl_m[None, :], t)
        x = c2 / (wl_m[None, :] * t)
        dbdt = b * x / t * np.exp(x) / np.expm1(x)
        m = atmo.storage.get_derivative_mapping(f"wf_{name}_temperature_k")
        m.d_emission[:] = dbdt
        m.interp_dim = "altitude"


class SurfaceThermalEmission(Constituent):
    """Planck surface emission at a given surface temperature with
    emissivity (reference ``surface emission`` handling)."""

    def __init__(self, temperature_k: float, emissivity=1.0):
        self.temperature_k = float(temperature_k)
        self.emissivity = emissivity

    def add_to_atmosphere(self, atmo):
        wl_m = atmo.wavelengths_nm * 1e-9
        atmo.surface.emission += self.emissivity * planck_blackbody_radiance(
            wl_m, self.temperature_k
        )

    def register_derivative(self, atmo, name: str):
        pass


class VolumeEmissionRate(Constituent):
    """Monochromatic isotropic volume emission rate (airglow), specified on
    its own altitude grid in [photons / (m^3 s)] or radiance-rate units;
    emission source = VER / (4 pi)."""

    def __init__(self, altitudes_m, ver, wavelength_nm=None):
        self._altitudes = np.asarray(altitudes_m, dtype=np.float64)
        self.ver = np.asarray(ver, dtype=np.float64)
        self.wavelength_nm = wavelength_nm

    def add_to_atmosphere(self, atmo):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), "extend"
        )
        prof = interp @ self.ver / (4.0 * np.pi)
        if self.wavelength_nm is None:
            atmo.storage.emission_source += prof[:, None]
        else:
            widx = int(np.argmin(np.abs(atmo.wavelengths_nm
                                        - self.wavelength_nm)))
            atmo.storage.emission_source[:, widx] += prof

    def register_derivative(self, atmo, name: str):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), "extend"
        )
        m = atmo.storage.get_derivative_mapping(f"wf_{name}")
        m.d_emission[:] = 1.0 / (4.0 * np.pi)
        m.interpolator = interp.T
        m.interp_dim = f"{name}_altitude"
