"""Host-side helpers of the polarized (I, Q, U) discrete-ordinates solver
(copies of ``sasktran2_tpu/rt/disco_vec.py:52-83``; a test pins them
array-equal).

With the generalized-spherical-function matrices

    Pi_l^m(mu) = [[ d^l_{m0},      0,        0    ],
                  [ 0,          P+_{lm},  -P-_{lm} ],
                  [ 0,         -P-_{lm},   P+_{lm} ]],
    P+- = (d^l_{m2} +- d^l_{m,-2}) / 2,

and the Greek matrix B_l = [[a1, -b1, 0], [-b1, a2, 0], [0, 0, a3]]_l,
flipping the sign of U in the downwelling field (D = diag(1, 1, -1))
gives the vector system the scalar solver's symmetric structure.
"""

from __future__ import annotations

import numpy as np

from ..ops.wigner import wigner_d

NS = 3
DSIGN = np.array([1.0, 1.0, -1.0])


def _pi_matrices(mu_vals: np.ndarray, m: int, lmax: int) -> np.ndarray:
    """Pi_l^m matrices at the given cosines: [L, n, 3, 3]."""
    mu_vals = np.asarray(mu_vals, dtype=np.float64)
    theta = np.arccos(np.clip(mu_vals, -1.0, 1.0))
    d0 = wigner_d(theta, m, 0, lmax)
    d2p = wigner_d(theta, m, 2, lmax)
    d2m = wigner_d(theta, m, -2, lmax)
    pp = 0.5 * (d2p + d2m)
    pm = 0.5 * (d2p - d2m)
    out = np.zeros((lmax,) + mu_vals.shape + (3, 3))
    out[..., 0, 0] = d0
    out[..., 1, 1] = pp
    out[..., 2, 2] = pp
    out[..., 1, 2] = -pm
    out[..., 2, 1] = -pm
    return out
