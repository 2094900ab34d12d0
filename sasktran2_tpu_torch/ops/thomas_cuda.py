"""Block-tridiagonal Thomas solve: the CUDA kernel and its plain twin.

Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``thomas_solve_pallas`` (``sasktran2_tpu/ops/pallas_thomas.py:47-190``):
forward elimination of ``lo[p] x[p-1] + di[p] x[p] + up[p] x[p+1] = r[p]``
then back substitution, for lo/di/up ``[P, K, K, W]`` and r ``[P, K, W]``
with the wavelength axis last. ``csrc/thomas.cu`` runs both in one launch,
one warp per wavelength lane, the lane's rows split over the warp's
threads; its header says what bounds it. The scratch buffers c and y
keep their [P, K, K, W] and [P, K, W] sizes but hold the kernel's
lane-major layout.

``thomas_solve`` launches the kernel for a CUDA tensor and runs
``thomas_solve_plain`` (the scan loop of the reference's
``_thomas_forward``, ``lanes.py:403-433``) for a CPU tensor. A CUDA tensor
it cannot take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lanes import THOMAS_K_MAX, lane_gauss_solve, lane_mm, lane_mv

_SIGNATURE = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_FUNCS = {torch.float32: "thomas_solve_f32", torch.float64: "thomas_solve_f64"}


def thomas_solve_plain(lo, di, up, r):
    """Forward elimination + back substitution as a loop over the layer
    axis (-4), each layer an unpivoted Gauss-Jordan solve of
    ``(di - lo c_prev) [c | y] = [up | r - lo y_prev]``. Returns x
    [..., P, K, W]."""
    P = di.shape[-4]
    K = di.shape[-2]
    c_prev = torch.zeros_like(di[..., 0, :, :, :])
    y_prev = torch.zeros_like(r[..., 0, :, :])
    cs, ys = [], []
    for p in range(P):
        lo_p = lo[..., p, :, :, :]
        denom = di[..., p, :, :, :] - lane_mm(lo_p, c_prev)
        rhs = r[..., p, :, :] - lane_mv(lo_p, y_prev)
        stacked = torch.cat([up[..., p, :, :, :], rhs[..., None, :]], dim=-2)
        sol = lane_gauss_solve(denom, stacked)
        c_prev = sol[..., :K, :]
        y_prev = sol[..., K, :]
        cs.append(c_prev)
        ys.append(y_prev)
    x_next = torch.zeros_like(y_prev)
    xs = [None] * P
    for p in range(P - 1, -1, -1):
        x_next = ys[p] - lane_mv(cs[p], x_next)
        xs[p] = x_next
    return torch.stack(xs, dim=-3)


def thomas_solve(lo, di, up, r):
    """Solve [P, K, K, W] x [P, K, W] -> x [P, K, W]; K <= 24, float32 or
    float64. CUDA tensors launch ``csrc/thomas.cu``; CPU tensors run the
    plain twin."""
    if not di.is_cuda:
        return thomas_solve_plain(lo, di, up, r)
    P, K, K2, W = di.shape
    if K != K2 or K > THOMAS_K_MAX or r.shape != (P, K, W):
        msg = f"thomas kernel: unsupported shapes {tuple(di.shape)}, {tuple(r.shape)}"
        raise ValueError(msg)
    if di.dtype not in _FUNCS:
        msg = f"thomas kernel: unsupported dtype {di.dtype}"
        raise TypeError(msg)
    for t in (lo, up, r):
        if t.device != di.device or t.dtype != di.dtype:
            msg = "thomas kernel: operands differ in device or dtype"
            raise ValueError(msg)
    if lo.shape != di.shape or up.shape != di.shape:
        msg = "thomas kernel: lo/di/up shapes differ"
        raise ValueError(msg)
    lo, di, up, r = (t.contiguous() for t in (lo, di, up, r))
    c = torch.empty_like(di)
    y = torch.empty_like(r)
    x = torch.empty_like(r)
    lib = _build.load("thomas", {f: _SIGNATURE for f in _FUNCS.values()})
    with torch.cuda.device(di.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FUNCS[di.dtype])(
            lo.data_ptr(), di.data_ptr(), up.data_ptr(), r.data_ptr(),
            c.data_ptr(), y.data_ptr(), x.data_ptr(), P, K, W, stream,
        )
    _build.check_launch(err, "thomas")
    with _build.COUNT_LOCK:
        thomas_solve.launches += 1
        thomas_solve.launches_by_k[K] = thomas_solve.launches_by_k.get(K, 0) + 1
    return x


# launches of the kernel, in all and per block size K
thomas_solve.launches = 0
thomas_solve.launches_by_k = {}
