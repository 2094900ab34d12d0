"""Refractive index of air — Ciddor (1996) equation set.

Provides the profile that feeds :attr:`Geometry1D.refractive_index` for
refractive ray tracing (reference API:
``upstream SASKTRAN2 src/sasktran2/optical/refraction.py``; physics: P. E.
Ciddor, "Refractive index of air: new equations for the visible and near
infrared", Appl. Opt. 35, 1566-1573 (1996)).

All constants below are the published values from Ciddor (1996): dispersion
coefficients for standard dry air (k0..k3) and water vapour (w0..w3), the
BIPM-density-equation compressibility coefficients (a/b/c/d/e), and the
reference densities of dry air at 101325 Pa / 15 C and pure vapour at
1333 Pa / 20 C.

(Copy of ``sasktran2_tpu/optical/refraction.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

_R_GAS = 8.314472  # J / (mol K)
_M_WATER = 0.018015  # kg / mol
_M_AIR_450 = 0.0289635  # kg / mol at 450 ppm CO2


def _compressibility(p_pa, t_k, x_w):
    """BIPM compressibility Z(p, T, x_w) (Ciddor 1996, appendix A)."""
    t_c = t_k - 273.15
    a0, a1, a2 = 1.58123e-6, -2.9331e-8, 1.1043e-10
    b0, b1 = 5.707e-6, -2.051e-8
    c0, c1 = 1.9898e-4, -2.376e-6
    d, e = 1.83e-11, -0.765e-8
    pt = p_pa / t_k
    return (
        1.0
        - pt * (a0 + a1 * t_c + a2 * t_c**2
                + (b0 + b1 * t_c) * x_w
                + (c0 + c1 * t_c) * x_w**2)
        + pt * pt * (d + e * x_w**2)
    )


def ciddor_index_of_refraction(
    temperatures_k,
    pressure_pa,
    specific_humidity,
    x_co2,
    wavelength_nm: float,
):
    """Refractive index of moist air.

    Parameters mirror the reference signature: temperature [K], pressure
    [Pa], specific humidity [kg/kg], CO2 molar fraction [ppm], and a single
    wavelength [nm].  All array arguments broadcast.
    """
    t_k = np.asarray(temperatures_k, dtype=np.float64)
    p = np.asarray(pressure_pa, dtype=np.float64)
    q = np.asarray(specific_humidity, dtype=np.float64)
    xc = np.asarray(x_co2, dtype=np.float64)

    # specific humidity -> water vapour molar fraction:
    # x_w = (q/Mw) / (q/Mw + (1-q)/Ma).  (The reference applies the molar
    # mass ratio inverted, src/sasktran2/optical/refraction.py:38-40; here
    # the physically correct conversion is used — the vapour term is a
    # <1e-6 effect on n either way.)
    eps = 18.01528 / 28.9647  # Mw / Ma
    x_w = q / (q + (1.0 - q) * eps)

    sigma2 = (1000.0 / wavelength_nm) ** 2  # 1/um^2

    # dispersion of standard dry air at 450 ppm CO2 (n_as - 1), eq (1)
    n_as = 1e-8 * (5792105.0 / (238.0185 - sigma2)
                   + 167917.0 / (57.362 - sigma2))
    # CO2 correction, eq (2)
    n_axs = n_as * (1.0 + 5.34e-7 * (xc - 450.0))
    # water vapour dispersion (n_ws - 1), eq (3)
    n_ws = 1.022e-8 * (295.235 + 2.6422 * sigma2
                       - 0.03238 * sigma2**2 + 0.004028 * sigma2**3)

    m_air = _M_AIR_450 + 1.2011e-8 * (xc - 400.0)

    # density of standard dry air (101325 Pa, 288.15 K, dry)
    z_axs = 0.9995922115
    rho_axs = 101325.0 * m_air / (z_axs * _R_GAS * 288.15)
    # density of standard pure vapour (1333 Pa, 293.15 K): Ciddor gives the
    # BIPM value directly
    rho_ws = 0.00985938

    z = _compressibility(p, t_k, x_w)
    rho_a = (1.0 - x_w) * p * m_air / (z * _R_GAS * t_k)
    rho_w = x_w * p * _M_WATER / (z * _R_GAS * t_k)

    return 1.0 + (rho_a / rho_axs) * n_axs + (rho_w / rho_ws) * n_ws
