"""Tournament-Jacobi symmetric eigensolve: the CUDA kernel and its plain
twin.

Replaces the Pallas TPU kernel built by ``_make_kernel`` and launched by
``jacobi_eigh_pallas`` (``sasktran2_tpu/ops/pallas_jacobi.py:54-155``):
the eigendecomposition of symmetric ``[P, n, n, W]`` matrices, n even and
at most 32, by ``sweeps`` sweeps of n-1 tournament rounds, each round n/2
disjoint Jacobi rotations, re-symmetrizing after each sweep. Outputs are
unsorted eigenvalues ``[P, n, W]`` and eigenvectors ``[P, n, n, W]``.
``csrc/jacobi.cu`` takes each rotation from the Pallas kernel's
half-angle tangent. At n <= 8 it runs one thread per (layer, lane), with
the rounds unrolled and the matrix in registers; at 8 < n <= 32 one group
of threads per matrix and one thread per rotation pair, with A and V in
shared memory, in the layout that ``launch_shape`` chooses and with the
round table that ``round_table`` builds from the reference's tournament.
Its header says what bounds each.

``jacobi_eigh`` launches the kernel for a CUDA tensor and runs
``jacobi_eigh_plain`` (the sweep loop of the reference's
``_lane_jacobi_scan_impl``, ``lanes.py:353-400``) for a CPU tensor. A
CUDA tensor it cannot take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .eigen import stacked_round_tables
from .lanes import JACOBI_N_MAX

_SIGNATURE = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
              + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_FUNCS = {torch.float32: "jacobi_eigh_f32", torch.float64: "jacobi_eigh_f64"}

# csrc/jacobi.cu's threads per block, and the largest order that its
# register branch takes
THREADS = 128
FIXED_N_MAX = 8


class LaunchShape(NamedTuple):
    """The layout of the shared-memory branch (8 < n <= 32) for one (n,
    dtype): ``group`` threads per matrix, ``matrices`` per block,
    ``row_stride`` and ``mat_stride`` in elements, and the bytes of the
    whole block's shared memory."""

    group: int
    matrices: int
    row_stride: int
    mat_stride: int
    smem_bytes: int


def launch_shape(n: int, itemsize: int) -> LaunchShape:
    """Launch shape of ``csrc/jacobi.cu``'s shared-memory branch.

    One thread per rotation pair, in groups of G = 8 threads (n <= 16) or
    16 (n <= 32): a power of two at least n/2 that divides 32, so a group
    never straddles a warp. The block holds the n/2 rotations of each of
    its matrices, each matrix's A and V, and the round table. A and V have
    the odd row stride n + 1, so that the rows of one group's pairs fall in
    distinct banks. The matrix stride is padded to 2G modulo the elements
    of one shared-memory pass (32 four-byte words; 16 eight-byte ones),
    which starts the two matrices that the kernel pairs in the same bank
    and, in f32 with groups of 8, a pass's two such pairs 16 words apart
    (the kernel's header has the layout)."""
    if n % 2 or not FIXED_N_MAX < n <= JACOBI_N_MAX:
        msg = f"no shared-memory launch shape for n = {n}"
        raise ValueError(msg)
    group = 8 if n <= 16 else 16
    row_stride = n + 1
    per_pass = 128 // itemsize
    mat_stride = 2 * n * row_stride
    mat_stride += (2 * group - mat_stride) % per_pass
    matrices = THREADS // group
    # a rotation slot is (c, s) and two ints, padded to 4 elements; the
    # table is (n - 1) n / 2 pairs of bytes
    smem_bytes = matrices * (2 * n + mat_stride) * itemsize + (n - 1) * n
    return LaunchShape(group, matrices, row_stride, mat_stride, smem_bytes)


def round_table(n: int):
    """[n-1, n/2, 2] uint8: the (p, q) of each pair of each round, in the
    order of ``eigen.stacked_round_tables``."""
    p_t, q_t = stacked_round_tables(n)[:2]
    return np.stack([p_t, q_t], axis=-1).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _device_table(n: int, device):
    # kept, so that a launch makes no host-to-device copy
    return torch.as_tensor(round_table(n), device=device)


def kernel_args(a, w, v, sweeps: int) -> tuple:
    """The arguments of ``jacobi_eigh_f32`` / ``_f64`` before the stream,
    for the contiguous CUDA tensors ``a`` [P, n, n, W] and outputs ``w``,
    ``v``."""
    P, n, _, W = a.shape
    if n <= FIXED_N_MAX:
        table, shape = 0, (0,) * 4
    else:
        table = _device_table(n, a.device).data_ptr()
        s = launch_shape(n, a.element_size())
        shape = (s.group, s.row_stride, s.mat_stride, s.smem_bytes)
    return (a.data_ptr(), w.data_ptr(), v.data_ptr(), P, n, W, int(sweeps),
            table, *shape)


def jacobi_eigh_plain(a, sweeps: int):
    """Tournament Jacobi on [..., n, n, W] (n even) with the rotation angle
    ``0.5 atan2(2 a_pq, a_qq - a_pp)``; exactly-zero pivots do not rotate.
    Each round rotates columns, then rows, then eigenvector columns."""
    npad = a.shape[-2]
    p_t, q_t, perm_t, sign_t, pair_t = stacked_round_tables(npad)
    dev = a.device

    def idx(t):
        return torch.as_tensor(t, device=dev)

    rounds = [
        (idx(p_t[r]), idx(q_t[r]), idx(perm_t[r]),
         torch.as_tensor(sign_t[r], dtype=a.dtype, device=dev)[:, None],
         idx(pair_t[r]))
        for r in range(len(p_t))
    ]
    v = torch.eye(npad, dtype=a.dtype, device=dev)[:, :, None].expand(a.shape)
    for _sweep in range(sweeps):
        for p, q, perm, sign, pair in rounds:
            app = a[..., p, p, :]
            aqq = a[..., q, q, :]
            apq = a[..., p, q, :]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            theta = torch.where(apq == 0.0, torch.zeros_like(theta), theta)
            c_full = torch.cos(theta)[..., pair, :]
            s_full = torch.sin(theta)[..., pair, :]
            coeff = -sign * s_full
            a = (
                a * c_full[..., None, :, :]
                + a[..., :, perm, :] * coeff[..., None, :, :]
            )
            a = (
                a * c_full[..., :, None, :]
                + a[..., perm, :, :] * coeff[..., :, None, :]
            )
            v = (
                v * c_full[..., None, :, :]
                + v[..., :, perm, :] * coeff[..., None, :, :]
            )
        a = 0.5 * (a + a.transpose(-3, -2))
    diag = torch.arange(npad, device=dev)
    return a[..., diag, diag, :], v


def jacobi_eigh(a, sweeps: int):
    """Eigensolve [P, n, n, W] (n even, <= 32; float32 or float64) ->
    (eigenvalues [P, n, W], eigenvectors [P, n, n, W]). CUDA tensors
    launch ``csrc/jacobi.cu``; CPU tensors run the plain twin."""
    if not a.is_cuda:
        return jacobi_eigh_plain(a, sweeps)
    P, n, n2, W = a.shape
    if n != n2 or n % 2 or n > JACOBI_N_MAX:
        msg = f"jacobi kernel: unsupported shape {tuple(a.shape)}"
        raise ValueError(msg)
    if a.dtype not in _FUNCS:
        msg = f"jacobi kernel: unsupported dtype {a.dtype}"
        raise TypeError(msg)
    a = a.contiguous()
    w = torch.empty((P, n, W), dtype=a.dtype, device=a.device)
    v = torch.empty_like(a)
    lib = _build.load("jacobi", {f: _SIGNATURE for f in _FUNCS.values()})
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FUNCS[a.dtype])(
            *kernel_args(a, w, v, sweeps), stream)
    _build.check_launch(err, "jacobi")
    with _build.COUNT_LOCK:
        jacobi_eigh.launches += 1
        jacobi_eigh.launches_by_n[n] = jacobi_eigh.launches_by_n.get(n, 0) + 1
    return w, v


# launches of the kernel, in all and per matrix order n
jacobi_eigh.launches = 0
jacobi_eigh.launches_by_n = {}
