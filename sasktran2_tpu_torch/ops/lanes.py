"""Wavelength-minor ("lane layout") linear algebra for the N-stream
solver (counterpart of ``sasktran2_tpu/ops/lanes.py``).

Matrix operands are ``[..., N, M, W]`` with the wavelength axis W last;
"mm"/"mv" contract the inner matrix dims and broadcast everything else.

Two functions here have a hand-written CUDA kernel, and this module holds
their dispatch. It mirrors the JAX package's gates (``lanes.py:338-344``,
``:461-479``) as shape rules:

* ``lane_block_thomas_solve``: a ``[P, K, K, W]`` system with K <= 24
  goes to ``thomas_cuda.thomas_solve``, which launches the CUDA kernel
  for a CUDA tensor and runs its plain PyTorch twin for a CPU tensor.
  K > 24 takes the torch-op path, where the blocks are solved by
  ``torch.linalg.solve``, as the reference solves them with
  ``jnp.linalg.solve``. That path is the port of the reference's own scan
  ``_thomas_forward`` at K > 24 (``lanes.py:403-433``), which the
  polarized solver takes at 16 streams (2K = 48): the reference has no
  Pallas kernel there, so neither does the port. It is not a fallback
  from a kernel.
* ``lane_jacobi_eigh_scan``: a 4-D ``[P, n, n, W]`` matrix whose padded
  order is at most 32 goes to ``jacobi_cuda.jacobi_eigh`` (kernel on CUDA,
  plain twin on the CPU); any other shape takes the plain sweep loop.

Neither dispatch catches a failure: a CUDA tensor inside a kernel's domain
launches the kernel or raises.
"""

from __future__ import annotations

import torch

THOMAS_K_MAX = 24
JACOBI_N_MAX = 32

# block-Thomas solves that took the torch-op loop (K > 24), per block size
# K: the counterpart of the kernel's ``thomas_cuda.thomas_solve.launches_by_k``
TORCH_OP_THOMAS_CALLS_BY_K = {}


def lane_mm(a, b):
    """a [..., I, J, W] @ b [..., J, K, W] -> [..., I, K, W]."""
    return torch.einsum("...ijw,...jkw->...ikw", a, b)


def lane_mv(a, v):
    """a [..., I, J, W] @ v [..., J, W] -> [..., I, W]."""
    return torch.einsum("...ijw,...jw->...iw", a, v)


def lane_t(a):
    """Transpose the matrix dims of a lane-minor matrix [..., I, J, W]."""
    return a.transpose(-3, -2)


def lane_cholesky(a):
    """Cholesky factor L (L @ L^T = a) of SPD lane-minor matrices
    [..., N, N, W], unrolled Cholesky-Banachiewicz on [..., W] vectors."""
    N = a.shape[-2]
    ell = [[None] * N for _ in range(N)]
    for j in range(N):
        s = a[..., j, j, :]
        for k in range(j):
            s = s - ell[j][k] * ell[j][k]
        ljj = torch.sqrt(s)
        ell[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, N):
            s = a[..., i, j, :]
            for k in range(j):
                s = s - ell[i][k] * ell[j][k]
            ell[i][j] = s * inv
    zero = torch.zeros_like(a[..., 0, 0, :])
    rows = [
        torch.stack([ell[i][j] if j <= i else zero for j in range(N)], dim=-2)
        for i in range(N)
    ]
    return torch.stack(rows, dim=-3)


def lane_solve_upper(u, b):
    """Solve U x = b with U [..., N, N, W] upper-triangular and
    b [..., N, M, W], by unrolled back substitution."""
    N = u.shape[-2]
    xs = [None] * N
    for i in range(N - 1, -1, -1):
        s = b[..., i, :, :]
        for k in range(i + 1, N):
            s = s - u[..., i, k, None, :] * xs[k]
        xs[i] = s / u[..., i, i, None, :]
    return torch.stack(xs, dim=-3)


def lane_gauss_solve(a, b):
    """Small-matrix solve a [..., K, K, W] x = b [..., K, M, W].

    K <= 24: unrolled Gauss-Jordan elimination without pivoting (the
    well-scaled BVP assumption of the reference). K > 24: a pivoted
    ``torch.linalg.solve`` on the transposed ``[..., W, K, K]`` layout, as
    the reference does at ``lanes.py:129-133``.
    """
    K = a.shape[-2]
    if K > THOMAS_K_MAX:
        at = torch.movedim(a, -1, -3)
        bt = torch.movedim(b, -1, -3)
        return torch.movedim(torch.linalg.solve(at, bt), -3, -1)
    rows = torch.arange(K, device=a.device)
    for i in range(K):
        inv_p = 1.0 / a[..., i, i, :]
        row_a = a[..., i, :, :] * inv_p[..., None, :]
        row_b = b[..., i, :, :] * inv_p[..., None, :]
        col = a[..., :, i, None, :]
        off = (rows != i)[:, None, None]
        col = torch.where(off, col, torch.zeros_like(col))
        a = a - col * row_a[..., None, :, :]
        b = b - col * row_b[..., None, :, :]
        pivot = (rows == i)[:, None, None]
        a = torch.where(pivot, row_a[..., None, :, :], a)
        b = torch.where(pivot, row_b[..., None, :, :], b)
    return b


# ---------------------------------------------------------------------------
# Symmetric eigensolve: tournament Jacobi forward, implicit eigh adjoint.
# ---------------------------------------------------------------------------


def _lane_jacobi_bwd(w, v, wbar, vbar):
    """Implicit eigh adjoint (``sasktran2_tpu/ops/lanes.py:166-178``).
    Pairs with |w_j - w_i| < 1e-30 are zeroed, so degenerate eigenvalues
    (pure-Rayleigh atmospheres) give finite gradients."""
    vtvbar = lane_mm(lane_t(v), vbar)
    dw = w[..., None, :, :] - w[..., :, None, :]  # F_ij = 1/(w_j - w_i)
    small = dw.abs() < 1e-30
    f = torch.where(
        small, torch.zeros_like(dw),
        1.0 / torch.where(small, torch.ones_like(dw), dw),
    )
    mid = f * vtvbar
    n = w.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=w.device)[:, :, None]
    mid = torch.where(eye, wbar[..., :, None, :], mid)
    abar = lane_mm(lane_mm(v, mid), lane_t(v))
    return 0.5 * (abar + lane_t(abar))


def _lane_jacobi_scan_impl(a, sweeps=None):
    """Forward eigensolve with the reference's odd-n padding and sweep
    counts (``lanes.py:314-400``)."""
    from . import jacobi_cuda

    n = a.shape[-2]
    if n == 1:
        return a[..., 0, :], torch.ones_like(a)
    odd = n % 2 == 1
    if odd:
        # an isolated 2 max|a| entry that never rotates into the live block
        pad_val = 2.0 * a.abs().amax(dim=(-3, -2))
        a = torch.nn.functional.pad(a, (0, 0, 0, 1, 0, 1))
        a[..., n, n, :] = pad_val
        npad = n + 1
    else:
        npad = n
    if sweeps is None:
        sweeps = 7 if a.dtype == torch.float32 else 10

    if a.ndim == 4 and npad <= JACOBI_N_MAX:
        eigvals, v = jacobi_cuda.jacobi_eigh(a, sweeps)
    else:
        eigvals, v = jacobi_cuda.jacobi_eigh_plain(a, sweeps)
    if odd:
        eigvals = eigvals[..., :n, :]
        v = v[..., :n, :n, :]
    return eigvals, v


class _LaneJacobiEigh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, sweeps):
        w, v = _lane_jacobi_scan_impl(a, sweeps)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, wbar, vbar):
        w, v = ctx.saved_tensors
        return _lane_jacobi_bwd(w, v, wbar, vbar), None


def lane_jacobi_eigh_scan(a, sweeps: int | None = None):
    """Symmetric [..., n, n, W] -> (eigenvalues [..., n, W] unsorted,
    eigenvectors [..., n, n, W]). Forward by tournament Jacobi; backward
    by the implicit eigh adjoint, never by differentiating the sweeps or
    ``torch.linalg.eigh``."""
    return _LaneJacobiEigh.apply(a, sweeps)


# ---------------------------------------------------------------------------
# Block-tridiagonal Thomas solve with the linear-system adjoint.
# ---------------------------------------------------------------------------


def _thomas_batched(lo, di, up, r):
    """The solve behind both the primal and the adjoint of
    ``lane_block_thomas_solve``: the Thomas kernel's domain (K <= 24) goes
    to ``thomas_cuda.thomas_solve``; larger blocks to the torch-op loop."""
    from . import _build, thomas_cuda

    K = di.shape[-2]
    if K <= THOMAS_K_MAX:
        return thomas_cuda.thomas_solve(lo, di, up, r)
    with _build.COUNT_LOCK:
        TORCH_OP_THOMAS_CALLS_BY_K[K] = TORCH_OP_THOMAS_CALLS_BY_K.get(K, 0) + 1
    return thomas_cuda.thomas_solve_plain(lo, di, up, r)


class _BlockThomas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lower, diag, upper, rhs):
        x = _thomas_batched(lower, diag, upper, rhs)
        ctx.save_for_backward(lower, diag, upper, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        lo, di, up, x = ctx.saved_tensors
        # T^T lam = xbar: (T^T)_{i,i-1} = up_{i-1}^T, (T^T)_{i,i+1} = lo_{i+1}^T
        lo_t = torch.roll(lane_t(up), 1, dims=-4)
        up_t = torch.roll(lane_t(lo), -1, dims=-4)
        lam = _thomas_batched(lo_t, lane_t(di), up_t, xbar)
        # block cotangents: A_bar = -lam_i x_j^T for block (i, j)
        di_bar = -lam[..., :, None, :] * x[..., None, :, :]
        x_prev = torch.roll(x, 1, dims=-3)
        x_next = torch.roll(x, -1, dims=-3)
        lo_bar = -lam[..., :, None, :] * x_prev[..., None, :, :]
        up_bar = -lam[..., :, None, :] * x_next[..., None, :, :]
        # the primal ignores lower[0] and upper[P-1]
        P = x.shape[-3]
        idx = torch.arange(P, device=x.device)[:, None, None, None]
        lo_bar = torch.where(idx == 0, torch.zeros_like(lo_bar), lo_bar)
        up_bar = torch.where(idx == P - 1, torch.zeros_like(up_bar), up_bar)
        return lo_bar, di_bar, up_bar, lam


def lane_block_thomas_solve(lower, diag, upper, rhs):
    """Block-tridiagonal solve: lower/diag/upper [P, K, K, W], rhs
    [P, K, W], all of one dtype; ``lower[0]`` and ``upper[P-1]`` are
    ignored. The backward pass is the linear-system adjoint: one
    transposed Thomas solve through the same dispatch, plus outer
    products. (The JAX package also broadcasts leading batch dims; the
    solver passes none.)"""
    shapes_ok = (
        diag.ndim == 4
        and diag.shape[-3] == diag.shape[-2]
        and lower.shape == diag.shape == upper.shape
        and rhs.shape == diag.shape[:-2] + diag.shape[-1:]
    )
    if not shapes_ok:
        msg = (
            f"lane_block_thomas_solve: want [P, K, K, W] blocks and a "
            f"[P, K, W] rhs, got {tuple(diag.shape)} and {tuple(rhs.shape)}"
        )
        raise ValueError(msg)
    return _BlockThomas.apply(lower, diag, upper, rhs)
