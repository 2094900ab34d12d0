"""Unit conversions (reference ``src/sasktran2/units.py``).

(Copy of ``sasktran2_tpu/units.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations


def celsius_to_kelvin(temperature_c):
    return temperature_c + 273.15


def kelvin_to_celsius(temperature_k):
    return temperature_k - 273.15


def wavlength_nm_to_wavenumber_cminv(wavelengths_nm):
    return 1e7 / wavelengths_nm


def wavenumber_cminv_to_wavlength_nm(wavenumber_cminv):
    return 1e7 / wavenumber_cminv


# aliases with the typo fixed (the reference spells it "wavlength")
wavelength_nm_to_wavenumber_cminv = wavlength_nm_to_wavenumber_cminv
wavenumber_cminv_to_wavelength_nm = wavenumber_cminv_to_wavlength_nm
