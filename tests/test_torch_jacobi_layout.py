"""The launch shape and the round table of the Jacobi kernel's
shared-memory branch (``csrc/jacobi.cu``, 8 < n <= 32), checked on the CPU
for every order it takes: the block fits in Hopper's shared memory, the
thread groups tile a warp, the layout holds the rotations, A and V,
and the round table is the reference's tournament
(``lanes._stacked_round_tables``, the rounds that
``pallas_jacobi.jacobi_eigh_pallas`` runs), every unordered pair once a
sweep. Nothing is compiled."""

import itertools

import numpy as np
import pytest
import torch

from sasktran2_tpu.ops.lanes import _stacked_round_tables
from sasktran2_tpu_torch.ops import jacobi_cuda
from sasktran2_tpu_torch.ops.eigen import stacked_round_tables
from tests.torch_support import one_torch_thread  # noqa: F401

ORDERS = range(10, 33, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", ORDERS)
def test_launch_shape_and_round_table(n, dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    shape = jacobi_cuda.launch_shape(n, itemsize)

    assert shape.smem_bytes <= 227 * 1024  # Hopper's shared memory a block
    assert 32 % shape.group == 0
    assert shape.group >= n // 2
    assert shape.group * shape.matrices == jacobi_cuda.THREADS
    # n/2 slots of (c, s, p, q) a matrix, A and V of [n][row_stride], then
    # the table's (n - 1) n/2 pairs of bytes
    per_pass = 128 // itemsize
    assert shape.row_stride >= n and shape.row_stride % 2 == 1
    assert shape.mat_stride >= 2 * n * shape.row_stride
    assert shape.mat_stride % per_pass == 2 * shape.group % per_pass
    assert shape.smem_bytes == (
        shape.matrices * (n // 2 * 4 + shape.mat_stride) * itemsize
        + (n - 1) * n)

    table = jacobi_cuda.round_table(n)
    assert table.dtype == np.uint8 and table.shape == (n - 1, n // 2, 2)
    p_t, q_t = stacked_round_tables(n)[:2]
    ref_p, ref_q = _stacked_round_tables(n)[:2]
    np.testing.assert_array_equal(table[..., 0], p_t)
    np.testing.assert_array_equal(table[..., 1], q_t)
    np.testing.assert_array_equal(table[..., 0], ref_p)
    np.testing.assert_array_equal(table[..., 1], ref_q)
    assert np.all(table[..., 0] < table[..., 1])
    for rnd in table:
        assert sorted(rnd.ravel().tolist()) == list(range(n))
    pairs = sorted(map(tuple, table.reshape(-1, 2).tolist()))
    assert pairs == list(itertools.combinations(range(n), 2))


@pytest.mark.parametrize("n", [8, 11, 34])
def test_launch_shape_refuses_other_orders(n):
    """n <= 8 takes the register branch, which has no launch shape; odd n
    and n > 32 take no branch."""
    with pytest.raises(ValueError, match="no shared-memory launch shape"):
        jacobi_cuda.launch_shape(n, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 24])
def test_kernel_args_match_the_c_signature(n, dtype):
    """``kernel_args`` gives one argument for each of the C entry point's
    parameters before the stream: for n > 8 the round table and the
    launch shape's group, strides and shared-memory bytes; for n <= 8
    zeros, which the register branch does not read."""
    a = torch.zeros((2, n, n, 3), dtype=dtype)
    w = torch.zeros((2, n, 3), dtype=dtype)
    args = jacobi_cuda.kernel_args(a, w, torch.zeros_like(a), 7)
    assert len(args) == len(jacobi_cuda._SIGNATURE) - 1
    assert args[3:7] == (2, n, 3, 7)
    if n <= jacobi_cuda.FIXED_N_MAX:
        assert args[7:] == (0,) * 5
    else:
        s = jacobi_cuda.launch_shape(n, a.element_size())
        assert args[8:] == (s.group, s.row_stride, s.mat_stride, s.smem_bytes)
        table = jacobi_cuda._device_table(n, a.device)
        assert args[7] == table.data_ptr()
        np.testing.assert_array_equal(table.numpy(), jacobi_cuda.round_table(n))
