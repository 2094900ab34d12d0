"""Peaks of the card and the least time of each CUDA kernel of the port,
frozen here so that a change to the program cannot move its own
yardstick.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit:
3.35 TB/s of HBM bandwidth, 67 TFLOP/s in FP32 and 34 TFLOP/s in FP64
outside the tensor cores (the kernels use none). A kernel's bound is the
larger of its bytes over the bandwidth and its operations over the peak
of its element type, counted from its shapes (a frozen copy of
``chip_smoke.py``'s ``thomas_bound`` and ``jacobi_bound``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12


def bound_s(nbytes, flops, itemsize=4) -> float:
    """The least time the card could take, in seconds, on elements of
    ``itemsize`` bytes."""
    peak = FP32_FLOP_PER_S if itemsize == 4 else FP64_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def thomas_cost(P, K, W, itemsize):
    """(bytes, FLOPs) of the block-tridiagonal solve of [P, K, K, W]
    blocks: lo, di, up and r read once, x written once; per layer and
    lane the least work whatever implements it: the carry products
    lo c[p-1] and lo y[p-1], 2K^3 + 2K^2; the LU factorisation of the
    K x K block with partial pivoting, K(K-1)/2 + K(K-1)(2K-1)/3; its
    solve for the K + 1 right-hand sides [up | rhs], (K + 1)(2K^2 - K);
    and the back substitution x = y - c x, 2K^2."""
    nbytes = (3 * P * K * K * W + 2 * P * K * W) * itemsize
    lu = K * (K - 1) // 2 + K * (K - 1) * (2 * K - 1) // 3
    flops = P * W * (2 * K**3 + 4 * K * K + lu + (K + 1) * (2 * K * K - K))
    return nbytes, flops


def jacobi_cost(P, n, W, sweeps, itemsize):
    """(bytes, FLOPs) of ``sweeps`` cyclic Jacobi sweeps of [P, n, n, W]
    symmetric matrices: a read once, w and v written once; per matrix,
    sweep and each of the n - 1 rounds the n/2 rotation angles (12 FLOPs
    each), the (n/2)(n/2 - 1)/2 off-diagonal 2 x 2 blocks of A's upper
    triangle rotated on both sides (24 each), the n/2 diagonal blocks in
    closed form (4 each) and V's n^2 two-term sums (3 each)."""
    nbytes = (2 * P * n * n * W + P * n * W) * itemsize
    h = n // 2
    per_round = 12 * h + 12 * h * (h - 1) + 4 * h + 3 * n * n
    return nbytes, P * W * sweeps * (n - 1) * per_round


def thomas_bound_s(P, K, W, itemsize):
    return bound_s(*thomas_cost(P, K, W, itemsize), itemsize)


def jacobi_bound_s(P, n, W, sweeps, itemsize):
    return bound_s(*jacobi_cost(P, n, W, sweeps, itemsize), itemsize)
