"""Rayleigh scattering constituent (Bates parameterization).

(Numpy copy of ``sasktran2_tpu/constituent/rayleigh.py`` for the PyTorch
port; a test pins its atmosphere to the original's.)

Behavior mirrors the reference
(upstream SASKTRAN2 ``rust/sasktran2-rs/src/constituent/types/rayleigh.rs``):
extinction = sigma(lambda) * N_air(z); pure scattering (ssa contribution =
extinction); scalar Legendre a1 = [1, 0, (1-delta)/(2+delta)] with the
depolarization delta = 6(K-1)/(3+7K); registers pressure/temperature
weighting functions through dN/dP, dN/dT.
"""

from __future__ import annotations

import numpy as np

from ..optical.rayleigh import rayleigh_cross_section_bates
from ..util.state import EquationOfState
from .base import Constituent


class Rayleigh(Constituent):
    """Rayleigh scattering with Bates (1984) cross sections, or manual
    user-supplied cross sections + King factors (reference
    ``constituent/rayleigh.py`` methods "bates" / "manual")."""

    def __init__(self, method: str = "bates", wavelengths_nm=None,
                 xs=None, king_factor=None, **percentages):
        if method not in ("bates", "manual"):
            msg = f"Unsupported Rayleigh method: {method}"
            raise NotImplementedError(msg)
        if method == "manual":
            if wavelengths_nm is None or xs is None:
                msg = (
                    "Rayleigh('manual') requires wavelengths_nm and xs "
                    "(m^2); king_factor defaults to 1"
                )
                raise ValueError(msg)
            self._manual_wl = np.asarray(wavelengths_nm, dtype=np.float64)
            self._manual_xs = np.asarray(xs, dtype=np.float64)
            self._manual_king = (
                np.ones_like(self._manual_wl)
                if king_factor is None
                else np.asarray(king_factor, dtype=np.float64)
            )
        self._method = method
        self._percentages = percentages

    def _xs_king(self, atmo):
        if self._method == "manual":
            wl = atmo.wavelengths_nm
            xs = np.interp(wl, self._manual_wl, self._manual_xs)
            king = np.interp(wl, self._manual_wl, self._manual_king)
            return xs, king
        return rayleigh_cross_section_bates(
            atmo.wavelengths_nm / 1000.0, **self._percentages
        )

    def _number_density(self, atmo):
        if atmo.pressure_pa is None or atmo.temperature_k is None:
            msg = (
                "Rayleigh requires atmosphere.pressure_pa and "
                "atmosphere.temperature_k"
            )
            raise ValueError(msg)
        eos = EquationOfState(
            atmo.pressure_pa, atmo.temperature_k, atmo.specific_humidity
        )
        return eos.air_numberdensity

    def add_to_atmosphere(self, atmo):
        if atmo.wavelengths_nm is None:
            msg = "Rayleigh requires wavelengths_nm on the atmosphere"
            raise ValueError(msg)
        xs, king = self._xs_king(atmo)
        nd = self._number_density(atmo)["N"]  # [A]
        k = nd[:, None] * xs[None, :]  # [A, W]
        delta = 6.0 * (king - 1.0) / (3.0 + 7.0 * king)
        beta2 = (1.0 - delta) / (2.0 + delta)

        s = atmo.storage
        s.total_extinction += k
        s.ssa += k
        a1 = atmo.leg_coeff.a1
        a1[0] += k
        a1[2] += k * beta2[None, :]
        if atmo.nstokes == 3:
            a2 = atmo.leg_coeff.a2
            b1 = atmo.leg_coeff.b1
            a2[2] += k * 6.0 * beta2[None, :]
            b1[2] += k * np.sqrt(6.0) * beta2[None, :]

    def register_derivative(self, atmo, name: str):
        nd = self._number_density(atmo)
        xs, king = self._xs_king(atmo)
        delta = 6.0 * (king - 1.0) / (3.0 + 7.0 * king)
        beta2 = (1.0 - delta) / (2.0 + delta)
        k_total = atmo.storage.total_extinction
        ssa = atmo.storage.ssa
        a1 = atmo.leg_coeff.a1

        for pname, dnd in (("pressure_pa", nd["dN_dP"]), ("temperature_k", nd["dN_dT"])):
            dk = dnd[:, None] * xs[None, :]  # [A, W]: d extinction / d param
            m = atmo.storage.get_derivative_mapping(f"wf_{name}_{pname}")
            m.d_extinction[:] = dk
            # d ssa / dx at fixed others: scattering added == extinction
            # added (pure scatterer): dssa = dk (1 - ssa) / k
            with np.errstate(divide="ignore", invalid="ignore"):
                m.d_ssa[:] = np.where(
                    k_total > 0, dk * (1.0 - ssa) / k_total, 0.0
                )
            # legendre: adding Rayleigh shifts the mixture's a1 toward the
            # Rayleigh phase: d a1_l = dk_scat (rayleigh_l - a1_l) / k_scat
            m.ensure_leg(3)
            kscat = ssa * k_total
            ray = np.zeros((3, 1, 1))
            with np.errstate(divide="ignore", invalid="ignore"):
                inv_kscat = np.where(kscat > 0, 1.0 / kscat, 0.0)
            m.d_leg_coeff[0] = dk * (1.0 - a1[0]) * inv_kscat
            m.d_leg_coeff[1] = dk * (0.0 - a1[1]) * inv_kscat
            m.d_leg_coeff[2] = dk * (beta2[None, :] - a1[2]) * inv_kscat
            m.interp_dim = "altitude"
