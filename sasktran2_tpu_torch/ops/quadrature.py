"""Stream quadrature for the discrete-ordinates solvers.

Reproduces the reference's "double Gauss" convention
(``upstream SASKTRAN2 cpp/lib/sktran_disco/sktran_do_quadrature.cpp:5-75``):
Gauss-Legendre nodes of order ``nstr/2`` mapped onto each hemisphere
``mu in (0, 1]``, with the special case ``nstr == 2`` using ``mu = 0.5,
w = 1``. All precompute is host-side numpy (the nodes are static under jit).

(Copy of ``sasktran2_tpu/ops/quadrature.py`` for the PyTorch port.)
"""

from __future__ import annotations

import numpy as np


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1], ascending nodes."""
    x, w = np.polynomial.legendre.leggauss(n)
    order = np.argsort(x)
    return x[order], w[order]


def streams(nstr: int) -> tuple[np.ndarray, np.ndarray]:
    """Positive-hemisphere stream cosines and weights.

    Returns (mu, w) each of length nstr//2, mu descending from ~1 toward 0
    (matching the reference ordering where index 0 is the largest cosine),
    normalized so that sum(w) = 1 over the hemisphere.
    """
    if nstr < 2 or nstr % 2 != 0:
        msg = f"nstr must be an even integer >= 2, got {nstr}"
        raise ValueError(msg)
    if nstr == 2:
        return np.array([0.5]), np.array([1.0])
    half = nstr // 2
    x, w = gauss_legendre(half)
    # Map [-1, 1] -> [0, 1]; reference stores angles[idx] = 0.5*x + 0.5 with
    # x descending so that index 0 is the largest cosine.
    mu = 0.5 * x[::-1] + 0.5
    wt = 0.5 * w[::-1]
    return mu, wt

