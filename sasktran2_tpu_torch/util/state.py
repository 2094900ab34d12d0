"""Equation of state: air number density from pressure / temperature /
specific humidity (reference ``src/sasktran2/util/state.py:8``).

(Copy of ``sasktran2_tpu/util/state.py`` for the PyTorch port.)
"""

from __future__ import annotations

import numpy as np

K_BOLTZMANN = 1.380649e-23  # J / K
MW_DRY_AIR = 28.9644e-3  # kg / mol
MW_H2O = 18.01528e-3


class EquationOfState:
    """Ideal-gas air number density with optional specific-humidity
    correction, plus analytic dN/dP and dN/dT for pressure/temperature
    weighting functions."""

    def __init__(self, pressure_pa, temperature_k, specific_humidity=None):
        self.pressure_pa = np.asarray(pressure_pa, dtype=np.float64)
        self.temperature_k = np.asarray(temperature_k, dtype=np.float64)
        self.specific_humidity = (
            np.asarray(specific_humidity, dtype=np.float64)
            if specific_humidity is not None
            else None
        )

    @property
    def air_numberdensity(self) -> dict:
        """dict with N [molecules/m^3], dN_dP, dN_dT — matching the
        reference's ``air_numberdensity_dict``."""
        N = self.pressure_pa / (K_BOLTZMANN * self.temperature_k)
        dN_dP = 1.0 / (K_BOLTZMANN * self.temperature_k)
        dN_dT = -self.pressure_pa / (K_BOLTZMANN * self.temperature_k**2)
        if self.specific_humidity is not None:
            # moist air: the number of "air" molecules per unit volume is
            # reduced by the vapour partial fraction
            eps = MW_H2O / MW_DRY_AIR
            q = self.specific_humidity
            frac_dry = 1.0 - q / (eps + q * (1.0 - eps))
            N = N * frac_dry
            dN_dP = dN_dP * frac_dry
            dN_dT = dN_dT * frac_dry
        return {"N": N, "dN_dP": dN_dP, "dN_dT": dN_dT}
