"""Host-side numerics of the plain reference: quadrature, Legendre
functions, interpolation weights and the stable divided differences of
the discrete-ordinates layer integrals.

Written for the benchmark from the textbook definitions; nothing here
imports the port or the JAX package.
"""

from __future__ import annotations

from math import lgamma

import numpy as np
import torch

K_BOLTZMANN = 1.380649e-23  # J / K


def streams(nstr: int):
    """Half-range Gauss-Legendre stream cosines (descending, in (0, 1))
    and weights summing to 1, for ``nstr`` streams; (0.5, 1) at nstr = 2."""
    if nstr < 2 or nstr % 2:
        msg = f"nstr must be an even integer >= 2, got {nstr}"
        raise ValueError(msg)
    if nstr == 2:
        return np.array([0.5]), np.array([1.0])
    x, w = np.polynomial.legendre.leggauss(nstr // 2)
    order = np.argsort(x)[::-1]
    return 0.5 * x[order] + 0.5, 0.5 * w[order]


def legendre_p(x, lmax: int) -> np.ndarray:
    """P_l(x) for l < lmax, shape (lmax, *x.shape)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros((lmax,) + x.shape)
    if lmax > 0:
        out[0] = 1.0
    if lmax > 1:
        out[1] = x
    for l in range(1, lmax - 1):
        out[l + 1] = ((2 * l + 1) * x * out[l] - l * out[l - 1]) / (l + 1)
    return out


def normalized_alp(x, m: int, lmax: int) -> np.ndarray:
    """sqrt((l-m)!/(l+m)!) P_l^m(x) with the Condon-Shortley phase, for
    l < lmax (rows with l < m are zero); shape (lmax, *x.shape). The
    upward recurrence in l from P_m^m = (-1)^m (2m-1)!! (1-x^2)^(m/2)."""
    x = np.clip(np.asarray(x, dtype=np.float64), -1.0, 1.0)
    out = np.zeros((lmax,) + x.shape)
    if m >= lmax:
        return out
    pmm = np.ones_like(x)
    s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    for k in range(1, m + 1):
        pmm = -pmm * (2 * k - 1) * s
    raw = {m: pmm}
    if m + 1 < lmax:
        raw[m + 1] = x * (2 * m + 1) * pmm
    for l in range(m + 2, lmax):
        raw[l] = ((2 * l - 1) * x * raw[l - 1]
                  - (l + m - 1) * raw[l - 2]) / (l - m)
    for l, p in raw.items():
        out[l] = np.exp(0.5 * (lgamma(l - m + 1) - lgamma(l + m + 1))) * p
    return out


def interp_matrix(from_grid, to_grid) -> np.ndarray:
    """M with f(to_grid) = M @ f(from_grid), linear inside the grid and
    the end value outside it."""
    xp = np.asarray(from_grid, dtype=np.float64)
    x = np.atleast_1d(np.asarray(to_grid, dtype=np.float64))
    M = np.zeros((len(x), len(xp)))
    if len(xp) == 1:
        M[:, 0] = 1.0
        return M
    for i, xi in enumerate(x):
        if xi <= xp[0]:
            M[i, 0] = 1.0
        elif xi >= xp[-1]:
            M[i, -1] = 1.0
        else:
            j = min(np.searchsorted(xp, xi, side="right") - 1, len(xp) - 2)
            f = (xi - xp[j]) / (xp[j + 1] - xp[j])
            M[i, j] = 1.0 - f
            M[i, j + 1] = f
    return M


def ediff(a, b, delta):
    """(exp(-a delta) - exp(-b delta)) / (b - a), with a series about the
    midpoint where |b - a| delta < 1e-3."""
    a, b, delta = torch.broadcast_tensors(a, b, delta)
    diff = b - a
    x = diff * delta
    small = x.abs() < 1e-3
    safe = torch.where(small, torch.ones_like(diff), diff)
    exact = (torch.exp(-a * delta) - torch.exp(-b * delta)) / safe
    series = torch.exp(-0.5 * (a + b) * delta) * delta * (
        1.0 + x * x / 24.0 * (1.0 + x * x / 80.0))
    return torch.where(small, series, exact)


def ddiff2(a, b, c, delta):
    """The second divided difference of exp(-x delta) over (a, b, c), with
    a series where the three nodes lie within 1e-2 / delta."""
    a, b, c, delta = torch.broadcast_tensors(a, b, c, delta)
    fab = -ediff(a, b, delta)
    fbc = -ediff(b, c, delta)
    ac = a - c
    spread = torch.maximum(torch.maximum(a, b), c) - torch.minimum(
        torch.minimum(a, b), c)
    small = spread * delta < 1e-2
    floor = 1e-300 if ac.dtype == torch.float64 else torch.finfo(ac.dtype).tiny
    safe = torch.where(small | (ac.abs() < floor), torch.ones_like(ac), ac)
    series = 0.5 * delta * delta * torch.exp(-(a + b + c) / 3.0 * delta)
    return torch.where(small, series, (fab - fbc) / safe)


def safe_div(num, den):
    """num / den, 0 where den == 0, finite in both passes."""
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))
