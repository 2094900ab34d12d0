"""Wigner d-functions and associated-Legendre tables.

The reference computes these with a C++/Rust recurrence
(``upstream SASKTRAN2 cpp/include/sasktran2/math/wigner.h:10-150``,
``upstream SASKTRAN2 rust/sasktran2-core/src/math/wigner.rs:30-113``). Here the
tables are built host-side in float64 numpy with the standard three-term
recurrence in ``l`` (Mishchenko, "Scattering, Absorption, and Emission of
Light by Small Particles", App. B): they parameterize static geometry and
quadrature, so they never need to be traced or differentiated.

``d^l_{m n}(theta)`` conventions:
  - ``d^l_{0 0} = P_l(cos theta)`` (ordinary Legendre)
  - ``d^l_{m 0} = sqrt((l-m)!/(l+m)!) P_l^m(cos theta)`` (normalized ALP)

(Copy of ``sasktran2_tpu/ops/wigner.py`` for the PyTorch port.)
"""

from __future__ import annotations

import numpy as np


def wigner_d(theta: np.ndarray, m: int, n: int, lmax: int) -> np.ndarray:
    """Wigner d-functions ``d^l_{m n}(theta)`` for ``l = 0..lmax-1``.

    Parameters
    ----------
    theta : array of angles [rad], any shape
    m, n : lower indices (m >= 0, n any sign supported via symmetry)
    lmax : number of l values returned

    Returns
    -------
    array of shape ``(lmax, *theta.shape)``; entries with ``l < max(|m|,|n|)``
    are zero.
    """
    theta = np.asarray(theta, dtype=np.float64)
    x = np.cos(theta)
    out = np.zeros((lmax,) + theta.shape, dtype=np.float64)

    am, an = abs(m), abs(n)
    lmin = max(am, an)
    if lmin >= lmax:
        return out

    if m == 0 and n == 0:
        # The general recurrence has an l factor that degenerates at l=0;
        # m=n=0 is exactly the ordinary Legendre recurrence.
        return legendre_p(x, lmax)

    # Symmetries to reduce to m >= 0: d^l_{-m,-n} = d^l_{m,n};
    # d^l_{n,m} = (-1)^{m-n} d^l_{m,n}
    sign = 1.0
    mm, nn = m, n
    if mm < 0 and nn <= 0:
        mm, nn = -mm, -nn
    elif mm < 0 or (mm == 0 and nn < 0):
        mm, nn = nn, mm
        sign = (-1.0) ** (mm - nn)
        if mm < 0:  # both were mixed-sign; flip both
            mm, nn = -mm, -nn

    # Starting value at l = lmin (Mishchenko B.23-B.24)
    xi = 1.0 if nn >= mm else (-1.0) ** (mm - nn)
    amn = abs(mm - nn)
    apn = abs(mm + nn)
    # binomial sqrt factor sqrt( (2 lmin)! / ( |m-n|! |m+n|! ) )
    log_fact = (
        _log_factorial(2 * lmin) - _log_factorial(amn) - _log_factorial(apn)
    )
    prefac = xi * (2.0 ** (-lmin)) * np.exp(0.5 * log_fact)
    with np.errstate(invalid="ignore"):
        d_lmin = (
            prefac
            * (1.0 - x) ** (amn / 2.0)
            * (1.0 + x) ** (apn / 2.0)
        )
    out[lmin] = d_lmin

    if lmin + 1 < lmax:
        d_prev = np.zeros_like(d_lmin)
        d_curr = d_lmin
        for l in range(lmin, lmax - 1):
            c0 = l * np.sqrt(((l + 1.0) ** 2 - mm * mm) * ((l + 1.0) ** 2 - nn * nn))
            c1 = (2.0 * l + 1.0) * (l * (l + 1.0) * x - mm * nn)
            c2 = (
                (l + 1.0) * np.sqrt(float(l * l - mm * mm) * float(l * l - nn * nn))
                if l > 0
                else 0.0
            )
            d_next = (c1 * d_curr - c2 * d_prev) / c0
            out[l + 1] = d_next
            d_prev, d_curr = d_curr, d_next

    return sign * out


def _log_factorial(k: int) -> float:
    from math import lgamma

    return lgamma(k + 1.0)


def legendre_p(x: np.ndarray, lmax: int) -> np.ndarray:
    """Ordinary Legendre polynomials P_l(x), l = 0..lmax-1, shape
    ``(lmax, *x.shape)`` via the standard recurrence."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros((lmax,) + x.shape, dtype=np.float64)
    if lmax >= 1:
        out[0] = 1.0
    if lmax >= 2:
        out[1] = x
    for l in range(1, lmax - 1):
        out[l + 1] = ((2 * l + 1) * x * out[l] - l * out[l - 1]) / (l + 1)
    return out


def normalized_alp(x: np.ndarray, m: int, lmax: int) -> np.ndarray:
    """Normalized associated Legendre functions used by the DO azimuth
    expansion: ``d^l_{m 0}(acos x) = sqrt((l-m)!/(l+m)!) P_l^m(x)`` (with the
    Condon-Shortley phase). The phase always appears an even number of times
    in azimuth-mode phase sums, so only internal consistency matters.

    Returns shape ``(lmax, *x.shape)``; rows with l < m are zero.
    """
    x = np.asarray(x, dtype=np.float64)
    theta = np.arccos(np.clip(x, -1.0, 1.0))
    return wigner_d(theta, m, 0, lmax)
