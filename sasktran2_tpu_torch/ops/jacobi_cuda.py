"""Tournament-Jacobi symmetric eigensolve: the CUDA kernel and its plain
twin.

Replaces the Pallas TPU kernel built by ``_make_kernel`` and launched by
``jacobi_eigh_pallas`` (``sasktran2_tpu/ops/pallas_jacobi.py:54-155``):
the eigendecomposition of symmetric ``[P, n, n, W]`` matrices, n even and
at most 32, by ``sweeps`` sweeps of n-1 tournament rounds, each round n/2
disjoint Jacobi rotations, re-symmetrizing after each sweep. Outputs are
unsorted eigenvalues ``[P, n, W]`` and eigenvectors ``[P, n, n, W]``.
``csrc/jacobi.cu`` runs one thread per (layer, lane), with the rounds
unrolled and the matrix in registers at n <= 8, and takes each rotation
from the Pallas kernel's half-angle tangent; its header says what bounds
it.

``jacobi_eigh`` launches the kernel for a CUDA tensor and runs
``jacobi_eigh_plain`` (the sweep loop of the reference's
``_lane_jacobi_scan_impl``, ``lanes.py:353-400``) for a CPU tensor. A
CUDA tensor it cannot take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .eigen import stacked_round_tables
from .lanes import JACOBI_N_MAX

_SIGNATURE = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
_FUNCS = {torch.float32: "jacobi_eigh_f32", torch.float64: "jacobi_eigh_f64"}


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
            a.data_ptr(), w.data_ptr(), v.data_ptr(), P, n, W, int(sweeps),
            stream,
        )
    _build.check_launch(err, "jacobi")
    jacobi_eigh.launches += 1
    jacobi_eigh.launches_by_n[n] = jacobi_eigh.launches_by_n.get(n, 0) + 1
    return w, v


# launches of the kernel, in all and per matrix order n
jacobi_eigh.launches = 0
jacobi_eigh.launches_by_n = {}
