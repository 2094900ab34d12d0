"""Tournament schedule of the parallel-ordered Jacobi eigensolve (numpy
copy of ``_tournament_schedule``, ``sasktran2_tpu/ops/eigen.py:33-50``)."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=32)
def _tournament_schedule(n: int) -> tuple:
    """Round-robin pairings: n-1 rounds, each a list of n/2 disjoint pairs.

    Standard circle method: fix player 0, rotate the rest.
    """
    if n % 2 != 0:
        msg = "tournament schedule requires even n"
        raise ValueError(msg)
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = []
        for i in range(n // 2):
            a, b = players[i], players[n - 1 - i]
            pairs.append((min(a, b), max(a, b)))
        rounds.append(tuple(sorted(pairs)))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


@functools.lru_cache(maxsize=32)
def stacked_round_tables(npad: int):
    """The tournament rounds as [R, ...] numpy tables: (p [R, n/2],
    q [R, n/2], perm [R, n], sign [R, n], pair_of [R, n]), as
    ``lanes._stacked_round_tables`` builds them in the JAX package."""
    rounds = _tournament_schedule(npad)
    R = len(rounds)
    p_t = np.empty((R, npad // 2), dtype=np.int64)
    q_t = np.empty((R, npad // 2), dtype=np.int64)
    perm_t = np.empty((R, npad), dtype=np.int64)
    sign_t = np.empty((R, npad), dtype=np.float64)
    pair_t = np.empty((R, npad), dtype=np.int64)
    for r, pairs in enumerate(rounds):
        for k, (p, q) in enumerate(pairs):
            p_t[r, k] = p
            q_t[r, k] = q
            perm_t[r, p], perm_t[r, q] = q, p
            sign_t[r, p], sign_t[r, q] = 1.0, -1.0
            pair_t[r, p] = pair_t[r, q] = k
    return p_t, q_t, perm_t, sign_t, pair_t


def jacobi_eigh(a, sweeps: int | None = None):
    """Eigendecomposition of a batch of symmetric matrices, batch-leading
    (counterpart of ``sasktran2_tpu/ops/eigen.py:74-187``).

    ``a`` [..., P, n, n] (or [n, n]) -> (eigenvalues [..., P, n]
    UNSORTED, eigenvectors [..., P, n, n], columns in eigenvalue order).
    The leading batch is flattened and moved to the minor axis, [P, n, n,
    B] with the layer axis P kept, and solved by
    ``lanes.lane_jacobi_eigh_scan``: the Jacobi kernel on the card for a
    padded order of at most 32, the reference's odd-n padding, its sweep
    counts (7 in float32, 10 in float64) and the implicit eigh adjoint.
    """
    from .lanes import lane_jacobi_eigh_scan

    squeeze = a.ndim == 2
    if squeeze:
        a = a[None]
    lead, (P, n) = a.shape[:-3], a.shape[-3:-1]
    lanes = a.reshape((-1, P, n, n)).permute(1, 2, 3, 0)
    w, v = lane_jacobi_eigh_scan(lanes, sweeps)
    w = w.permute(2, 0, 1).reshape(lead + (P, n))
    v = v.permute(3, 0, 1, 2).reshape(lead + (P, n, n))
    if squeeze:
        return w[0], v[0]
    return w, v
