"""Misc constituents: Manual raw inputs, SolarIrradiance, AirMassFactor,
CollisionInducedAbsorber (roles of the reference's
``src/sasktran2/constituent/{solar,amf}.py`` and the Rust CIA constituent).

(Copy of ``sasktran2_tpu/constituent/misc.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from ..util.state import EquationOfState
from .base import Constituent


class ManualOpticalProperties(Constituent):
    """Directly-specified extinction / ssa (+optional Legendre) profiles on
    the model grid (reference "Manual" constituent)."""

    def __init__(self, extinction, ssa=None, leg_coeff=None):
        self.extinction = np.asarray(extinction, dtype=np.float64)
        self.ssa = None if ssa is None else np.asarray(ssa, dtype=np.float64)
        self.leg_coeff = (
            None if leg_coeff is None
            else np.asarray(leg_coeff, dtype=np.float64)
        )

    def add_to_atmosphere(self, atmo):
        k = np.broadcast_to(
            self.extinction.reshape(-1, 1)
            if self.extinction.ndim == 1 else self.extinction,
            atmo.storage.total_extinction.shape,
        )
        atmo.storage.total_extinction += k
        if self.ssa is not None:
            ks = k * np.broadcast_to(
                self.ssa.reshape(-1, 1) if self.ssa.ndim == 1 else self.ssa,
                k.shape,
            )
            atmo.storage.ssa += ks
            a1 = atmo.leg_coeff.a1
            if self.leg_coeff is not None:
                L = min(self.leg_coeff.shape[0], a1.shape[0])
                a1[:L] += ks[None] * self.leg_coeff[:L].reshape(L, -1, 1)
            else:
                a1[0] += ks

    def register_derivative(self, atmo, name: str):
        m = atmo.storage.get_derivative_mapping(f"wf_{name}_extinction")
        m.d_extinction[:] = 1.0
        m.interp_dim = "altitude"


class SolarIrradiance(Constituent):
    """Sets the solar irradiance spectrum on the atmosphere (reference
    ``constituent/solar.py:11``). ``mode`` kept for API parity."""

    def __init__(self, irradiance=None, wavelengths_nm=None, mode="sample"):
        self.irradiance = irradiance
        self.wavelengths_nm = wavelengths_nm
        self.mode = mode

    def add_to_atmosphere(self, atmo):
        from ..solar import SolarModel

        if self.irradiance is None:
            model = SolarModel()
            atmo.storage.solar_irradiance[:] = model.irradiance(
                atmo.wavelengths_nm
            )
        else:
            irr = np.atleast_1d(np.asarray(self.irradiance, dtype=np.float64))
            if self.wavelengths_nm is not None:
                interp = linear_interpolating_matrix(
                    np.asarray(self.wavelengths_nm), atmo.wavelengths_nm,
                    "extend",
                )
                irr = interp @ irr
            atmo.storage.solar_irradiance[:] = irr

    def register_derivative(self, atmo, name: str):
        pass


class CollisionInducedAbsorber(Constituent):
    """Collision-induced absorption: extinction ~ xs(lambda) * N_a * N_b
    with the cross section in m^5 (reference CIA constituent). For O2-O2,
    both densities are the O2 number density."""

    def __init__(self, optical_wavelengths_nm, xs_m5, vmr_a, vmr_b,
                 name_a="a", name_b="b"):
        self.wl = np.asarray(optical_wavelengths_nm, dtype=np.float64)
        self.xs = np.asarray(xs_m5, dtype=np.float64)
        self.vmr_a = float(vmr_a)
        self.vmr_b = float(vmr_b)

    def add_to_atmosphere(self, atmo):
        eos = EquationOfState(
            atmo.pressure_pa, atmo.temperature_k, atmo.specific_humidity
        )
        nd = eos.air_numberdensity["N"]
        interp = linear_interpolating_matrix(self.wl, atmo.wavelengths_nm,
                                             "extend")
        xs = interp @ self.xs
        k = (self.vmr_a * nd)[:, None] * (self.vmr_b * nd)[:, None] * xs[None]
        atmo.storage.total_extinction += k

    def register_derivative(self, atmo, name: str):
        pass


class AirMassFactor(Constituent):
    """Registers box air-mass-factor weighting functions as the output
    variable ``air_mass_factor`` = -d(ln I)/d(tau_layer) (reference
    ``constituent/amf.py:10-48``). Adds no optical properties.

    The box AMF perturbation is a pure ABSORBER added to one layer: the
    extinction rises by dtau/dz while the scattering extinction stays
    fixed, so ssa = k_scat/k picks up a compensating -ssa/k term. The
    altitude factors convert d/d(extinction at a grid level) into
    d/d(layer optical depth): -1/dz via ``np.gradient`` spacing with the
    half-width boundary cells doubled, exactly as the reference does.
    """

    def add_to_atmosphere(self, atmo):
        pass

    def register_derivative(self, atmo, name: str):  # noqa: ARG002
        altitudes = np.asarray(atmo.altitudes(), dtype=np.float64)
        alt_factors = -1.0 / np.gradient(altitudes)
        alt_factors[0] *= 2
        alt_factors[-1] *= 2

        m = atmo.storage.get_derivative_mapping("air_mass_factor")
        m.d_extinction[:] += alt_factors[:, None]
        with np.errstate(invalid="ignore", divide="ignore"):
            m.d_ssa[:] += np.where(
                atmo.storage.total_extinction > 0,
                alt_factors[:, None]
                * (0.0 - atmo.storage.ssa)
                / atmo.storage.total_extinction,
                0.0,
            )
        m.log_radiance_space = True
        m.interp_dim = "altitude"
