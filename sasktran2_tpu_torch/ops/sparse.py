"""Static sparse operators as torch CSR matrices: a matrix built once on
the host from (row, column, value) entries and applied to dense
wavelength batches, with its transpose for the backward pass.

The successive-orders transport plan (``rt/successive.py``) and the 2D
line-of-sight tables (``rt/singlescatter.Rays2D``) use them in place of
gathers: a product with a CSR matrix touches each stored weight once,
where a gather materialises [W, rows, entries per row].
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def csr(rows, cols, vals, shape):
    """(crow, col, val, shape) of the CSR matrix of ``shape`` with the
    given entries; repeated (row, col) entries are summed, exact zeros
    dropped."""
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals, dtype=np.float64).ravel()
    keep = vals != 0.0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    key = rows * shape[1] + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    val = np.add.reduceat(vals, start) if len(vals) else vals
    r = uniq // shape[1]
    crow = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=shape[0]))])
    return crow, uniq % shape[1], val, shape


class SparseOp:
    """A static matrix and its transpose as torch CSR tensors of ``dtype``
    on ``device``."""

    def __init__(self, rows, cols, vals, shape, device, dtype):
        def tensor(crow, col, val, shp):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return torch.sparse_csr_tensor(
                    torch.as_tensor(crow, dtype=torch.int32),
                    torch.as_tensor(col, dtype=torch.int32),
                    torch.as_tensor(val, dtype=dtype), size=shp,
                ).to(device)

        self.m = tensor(*csr(rows, cols, vals, shape))
        self.mt = tensor(*csr(cols, rows, vals, shape[::-1]))


class _Apply(torch.autograd.Function):
    """y = M x for a static sparse M and dense x [K, N]."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return op.m @ x.contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.op.mt @ grad.contiguous(), None


def apply_sparse(x, op: SparseOp):
    """``op.m @ x`` for dense x [K, N], differentiable in x."""
    return _Apply.apply(x, op)
