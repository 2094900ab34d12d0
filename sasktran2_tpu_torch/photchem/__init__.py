"""Photochemistry: photolysis rates and simple airglow emission models.

Role of the reference's ``rust/sasktran2-rs/src/photchem/``
(``calculate_photolysis_rate``, ``models.rs:383``; O2/O3 airglow emission
models). The photolysis-rate integral composes directly with the engine's
actinic-flux output (``FluxType.Actinic`` observers).

(Copy of ``sasktran2_tpu/photchem/__init__.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from .emission import (
    EmissionBand,
    EmissionTransition,
    mcdade_oxygen_green_line_o1s_population,
    mcdade_oxygen_green_line_photon_ver,
    oxygen_a_band_from_catalogue,
    oxygen_b_band_from_catalogue,
    oxygen_green_line_transition,
    photon_ver_from_state_profile,
)
from .models import (
    PhotochemicalModel,
    Yankovsky,
    calculate_photolysis_rate,
    wavelength_bin_widths,
)
from .types import ChemicalReaction, Molecule, PhotoReaction, RateConstant

__all__ = [
    "ChemicalReaction",
    "EmissionBand",
    "EmissionTransition",
    "Molecule",
    "PhotoReaction",
    "PhotochemicalModel",
    "RateConstant",
    "Yankovsky",
    "calculate_photolysis_rate",
    "integrate_photolysis_rate",
    "irradiance_to_photon_flux",
    "mcdade_oxygen_green_line_o1s_population",
    "mcdade_oxygen_green_line_photon_ver",
    "o2_singlet_delta_ver",
    "oxygen_a_band_from_catalogue",
    "oxygen_b_band_from_catalogue",
    "oxygen_green_line_transition",
    "photon_ver_from_state_profile",
    "wavelength_bin_widths",
]


def integrate_photolysis_rate(
    wavelengths_nm, cross_section_m2, quantum_yield, actinic_flux,
):
    """J [1/s] = int sigma(lambda) phi(lambda) F_actinic(lambda) dlambda.

    Plain trapezoid integral over explicit arrays. For the reference-parity
    reaction-based API (band windows, single-line evaluation, TOA-rate
    renormalization) use :func:`calculate_photolysis_rate` (from
    ``photchem.models``, reference ``photchem/models.rs:383``).

    actinic_flux: spectral actinic flux in photons / (m^2 s nm) — or in
    W / (m^2 nm), in which case pass it through
    :func:`irradiance_to_photon_flux` first. Shapes broadcast; the integral
    runs over the last (wavelength) axis with the trapezoid rule.
    """
    wl = np.asarray(wavelengths_nm, dtype=np.float64)
    integrand = (
        np.asarray(cross_section_m2)
        * np.asarray(quantum_yield)
        * np.asarray(actinic_flux)
    )
    return np.trapezoid(integrand, wl, axis=-1)


def irradiance_to_photon_flux(wavelengths_nm, irradiance_w_m2_nm):
    """Convert spectral irradiance [W/(m^2 nm)] to photon flux
    [photons/(m^2 s nm)]: divide by the photon energy h c / lambda."""
    h = 6.62607015e-34
    c = 299792458.0
    wl_m = np.asarray(wavelengths_nm, dtype=np.float64) * 1e-9
    return np.asarray(irradiance_w_m2_nm) * wl_m / (h * c)


def o2_singlet_delta_ver(
    j_hartley, o3_number_density, temperature_k, pressure_pa,
    quantum_yield_o1d=0.9, f_delta=0.79,
):
    """Simplified O2(1-Delta) airglow volume emission rate [photons/m^3/s].

    Steady-state balance of the dominant dayglow channel (a reduced form of
    the reference's Yankovsky model, ``photchem/models.rs:551``):
    production = f_delta * phi_O1D * J_Hartley * [O3]; loss = radiative
    (A = 2.237e-4 1/s) + collisional quenching by O2 (k ~ 3.6e-18
    exp(-220/T) cm^3/s).
    """
    kb = 1.380649e-23
    n_air = np.asarray(pressure_pa) / (kb * np.asarray(temperature_k))
    n_o2 = 0.20946 * n_air
    a_delta = 2.237e-4
    kq = 3.6e-24 * np.exp(-220.0 / np.asarray(temperature_k))  # m^3/s
    production = (
        f_delta * quantum_yield_o1d * np.asarray(j_hartley)
        * np.asarray(o3_number_density)
    )
    excited = production / (a_delta + kq * n_o2)
    return a_delta * excited
