"""Line-shape functions: complex probability function and Voigt profile.

Torch counterpart of ``sasktran2_tpu/optical/lineshape.py``: Humlicek's
(1982) w4 rational approximations in four regions, selected with
``torch.where`` so a whole (lines x grid) block evaluates branch-free on
the device, in complex128 for float64 inputs as the reference computes
them.
"""

from __future__ import annotations

import math

import torch

SQRT_PI = 1.7724538509055159
INV_SQRT_PI = 1.0 / SQRT_PI


def _complex_dtype(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def wofz(z):
    """Faddeeva function w(z) = exp(-z^2) erfc(-iz) for Im(z) >= 0.

    Humlicek (1982) w4, region-selected: s = |x| + y >= 15 (region 1),
    5.5 <= s < 15 (region 2), s < 5.5 with y >= 0.195 |x| - 0.176
    (region 3), the remainder (region 4). Relative accuracy about 1e-4,
    as the reference's.
    """
    z = torch.as_tensor(z)
    if not z.is_complex():
        z = z.to(_complex_dtype(z.dtype))
    x = z.real
    y = z.imag
    t = torch.complex(y, -x)  # y - i x
    s = x.abs() + y

    # region 1: s >= 15
    w1 = t * INV_SQRT_PI / (0.5 + t * t)

    # region 2: 5.5 <= s < 15
    u = t * t
    w2 = t * (1.410474 + u * INV_SQRT_PI) / (0.75 + u * (3.0 + u))

    # region 3: s < 5.5 and y >= 0.195 |x| - 0.176
    w3 = (
        16.4955
        + t * (20.20933 + t * (11.96482 + t * (3.778987 + t * 0.5642236)))
    ) / (
        16.4955
        + t * (38.82363 + t * (39.27121 + t * (21.69274 + t * (6.699398 + t))))
    )

    # region 4: remainder
    numer = t * (
        36183.31
        - u * (3321.9905
               - u * (1540.787
                      - u * (219.0313
                             - u * (35.76683
                                    - u * (1.320522 - u * 0.56419)))))
    )
    denom = (
        32066.6
        - u * (24322.84
               - u * (9022.228
                      - u * (2186.181
                             - u * (364.2191
                                    - u * (61.57037
                                           - u * (1.841439 - u))))))
    )
    w4 = torch.exp(u) - numer / denom

    return torch.where(
        s >= 15.0,
        w1,
        torch.where(
            s >= 5.5,
            w2,
            torch.where(y >= 0.195 * x.abs() - 0.176, w3, w4),
        ),
    )


def _w(nu, nu0, doppler_width, lorentz_width):
    x = (nu - nu0) / doppler_width
    y = lorentz_width / doppler_width
    x, y = torch.broadcast_tensors(x, y)
    return wofz(torch.complex(x, y))


def voigt_profile(nu, nu0, doppler_width, lorentz_width):
    """Voigt line shape [1/(same units as nu)] normalized to unit area.

    doppler_width: Gaussian HWHM/sqrt(ln 2) parameter alpha_d such that the
    Gaussian part is exp(-(nu-nu0)^2/alpha_d^2)/(alpha_d sqrt(pi)).
    """
    return _w(nu, nu0, doppler_width, lorentz_width).real / (
        doppler_width * SQRT_PI
    )


def voigt_profile_complex(nu, nu0, doppler_width, lorentz_width):
    """(absorption, dispersion) components of the Voigt profile:
    ``Re w(z) / (alpha_d sqrt(pi))`` and ``Im w(z) / (alpha_d sqrt(pi))``.
    The dispersion part enters first-order Rosenkranz line mixing."""
    w = _w(nu, nu0, doppler_width, lorentz_width)
    norm = doppler_width * SQRT_PI
    return w.real / norm, w.imag / norm


def doppler_width(nu0, temperature_k, molar_mass_kg_mol):
    """alpha_d parameter [same units as nu0]; ``temperature_k`` a number or
    a tensor that broadcasts against ``nu0``."""
    kb = 1.380649e-23
    na = 6.02214076e23
    mass = molar_mass_kg_mol / na
    c = 299792458.0
    if isinstance(temperature_k, torch.Tensor):
        return nu0 / c * torch.sqrt(2.0 * kb * temperature_k / mass)
    return nu0 / c * math.sqrt(2.0 * kb * temperature_k / mass)
