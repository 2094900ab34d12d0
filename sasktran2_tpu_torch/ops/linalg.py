"""Stable exponential divided differences (counterpart of ``ediff`` and
``ddiff2`` in ``sasktran2_tpu/ops/linalg.py:17-63``), and the generic
route's batch-leading solves (``cholesky``, ``solve_upper``,
``block_tridiag_solve``) on the lane kernels of ``ops/lanes.py``.

Every ``torch.where`` here keeps both of its branches finite, because the
gradient of the branch that is not taken is still evaluated.
"""

from __future__ import annotations

import torch


def ediff(a, b, delta):
    """Stable ``(exp(-a*delta) - exp(-b*delta)) / (b - a)``.

    Near ``a == b`` it switches to a series about the midpoint, so the
    value and its derivatives stay finite and smooth.
    """
    a, b, delta = torch.broadcast_tensors(a, b, delta)
    diff = b - a
    mid = 0.5 * (a + b)
    x = diff * delta
    small = x.abs() < 1e-3
    safe_diff = torch.where(small, torch.ones_like(diff), diff)
    exact = (torch.exp(-a * delta) - torch.exp(-b * delta)) / safe_diff
    emid = torch.exp(-mid * delta)
    series = emid * delta * (1.0 + x * x / 24.0 * (1.0 + x * x / 80.0))
    return torch.where(small, series, exact)


def ddiff2(a, b, c, delta):
    """Stable second divided difference of ``f(x) = exp(-x*delta)`` over
    the nodes (a, b, c), with a series where all three nodes cluster."""
    a, b, c, delta = torch.broadcast_tensors(a, b, c, delta)
    fab = -ediff(a, b, delta)
    fbc = -ediff(b, c, delta)
    ac = a - c
    spread = torch.maximum(torch.maximum(a, b), c) - torch.minimum(
        torch.minimum(a, b), c
    )
    small = spread * delta < 1e-2
    safe_ac = torch.where(ac.abs() < 1e-300, torch.ones_like(ac), ac)
    exact = (fab - fbc) / safe_ac
    mean = (a + b + c) / 3.0
    series = 0.5 * delta * delta * torch.exp(-mean * delta)
    return torch.where(small, series, exact)


# ---------------------------------------------------------------------------
# Batch-leading dense and block-tridiagonal solves on the lane kernels.
# ---------------------------------------------------------------------------


def _to_lanes(x, core: int):
    """[..., *core] -> ([*core, B], leading shape): the leading batch
    flattened onto the minor axis."""
    lead = x.shape[: x.ndim - core]
    flat = x.reshape((-1,) + x.shape[x.ndim - core:])
    return flat.permute(*range(1, core + 1), 0), lead


def _from_lanes(y, lead):
    """[*core, B] -> [*lead, *core]."""
    return y.permute(y.ndim - 1, *range(y.ndim - 1)).reshape(
        lead + y.shape[:-1])


def cholesky(a):
    """Lower Cholesky factor of SPD matrices [..., n, n], by the port's
    unrolled lane Cholesky on the batch moved to the minor axis (no
    cuSOLVER batch limit on the card)."""
    from .lanes import lane_cholesky

    lanes, lead = _to_lanes(a, 2)
    return _from_lanes(lane_cholesky(lanes), lead)


def solve_upper(u, b):
    """Solve U x = b for upper-triangular U [..., n, n] and b [..., n, m]
    (batch shapes broadcast), by unrolled back substitution on the lane
    layout."""
    from .lanes import lane_solve_upper

    batch = torch.broadcast_shapes(u.shape[:-2], b.shape[:-2])
    u = u.expand(batch + u.shape[-2:])
    b = b.expand(batch + b.shape[-2:])
    ul, lead = _to_lanes(u, 2)
    bl, _ = _to_lanes(b, 2)
    return _from_lanes(lane_solve_upper(ul, bl), lead)


def block_tridiag_solve(lower, diag, upper, rhs):
    """Solve the batched block-tridiagonal system ``lower[p] x[p-1] +
    diag[p] x[p] + upper[p] x[p+1] = rhs[p]`` (``lower[0]`` and
    ``upper[P-1]`` ignored; counterpart of
    ``sasktran2_tpu/ops/linalg.py:92-109``).

    lower/diag/upper [..., P, K, K], rhs [..., P, K]; leading batch shapes
    broadcast. The batch is flattened onto the minor axis and solved by
    ``lanes.lane_block_thomas_solve``: the Thomas kernel on the card for
    K <= 24, the torch-op loop above that, with the linear-system adjoint.
    The reference's block cyclic reduction (its route from P >= 8) is the
    same function, computed in log2 P levels for the TPU; in float64 the
    two agree to roundoff and it is not ported.
    """
    from .lanes import lane_block_thomas_solve

    batch = torch.broadcast_shapes(diag.shape[:-3], lower.shape[:-3],
                                   upper.shape[:-3], rhs.shape[:-2])
    P, K = diag.shape[-3], diag.shape[-1]
    blocks = [
        _to_lanes(t.expand(batch + (P, K, K)), 3)[0]
        for t in (lower, diag, upper)
    ]
    r, lead = _to_lanes(rhs.expand(batch + (P, K)), 2)
    return _from_lanes(lane_block_thomas_solve(*blocks, r), lead)
