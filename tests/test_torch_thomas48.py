"""The Thomas kernel's pivoting branch (24 < K <= 48, ``csrc/thomas.cu``;
the polarized 16-stream solver's K = 48 blocks) and its dispatch.

On the CPU: the plain twin ``thomas_cuda.thomas_solve_plain`` and the
autograd of ``lanes.lane_block_thomas_solve`` against the JAX package's
``lane_block_thomas_solve`` (its scan, each block solved by a pivoted
``jnp.linalg.solve``) at K = 26 and 48 in float64, values and vjp to 1e-10
relative, on random systems and on one whose leading diagonal element is 0
in every layer, which only a pivoting solve gets right; and the dispatch:
K <= 48 is the kernel's domain (on the CPU its plain twin, no torch-op
count), K = 52 takes the torch-op loop and is counted.

On the card (``cuda`` marker; skipped without one): the kernel against
the plain twin at K in {26, 32, 40, 48} and ragged W = 1001 and 1004 (f32
within max(4 x the plain twin's error, 1e-5) of the f64 solve, as
``chip_smoke.py`` phase 8 holds it; f64 within 1e-10), the pivot-needing
system at each K, and the adjoint (two launches) against autograd through the plain
twin.

The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_thomas48.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest
import torch

from sasktran2_tpu.ops import lanes as lanes_ref
from sasktran2_tpu_torch.ops import lanes, thomas_cuda
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

PIVOT_K = [26, 32, 40, 48]


def _system(P, K, W, seed, kind="random"):
    """(lo, di, up, r) numpy float64. "random": N(0, 0.3^2) off-diagonal
    blocks, N(0, 1) + (5 + 2 sqrt(K)) I diagonal blocks. "pivot": diagonal
    blocks 10 x a permutation matrix plus N(0, 0.1^2), with di[p, 0, 0] = 0
    in every layer, so the first pivot of every layer must be a row swap."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(P, K, K, W)) * 0.3
    up = rng.normal(size=(P, K, K, W)) * 0.3
    r = rng.normal(size=(P, K, W))
    if kind == "random":
        di = rng.normal(size=(P, K, K, W)) + (5.0 + 2.0 * np.sqrt(K)) * np.eye(
            K)[:, :, None]
    else:
        perm = rng.permutation(K)
        perm = np.roll(perm, -int(np.argmax(perm == 0)) - 1)  # perm[0] != 0
        di = rng.normal(size=(P, K, K, W)) * 0.1 + 10.0 * np.eye(K)[perm][
            :, :, None]
        di[:, 0, 0, :] = 0.0
    return lo, di, up, r


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


CPU_CASES = [(26, "random"), (48, "random"), (48, "pivot")]


@pytest.mark.parametrize(("K", "kind"), CPU_CASES)
def test_plain_twin_matches_jax_scan(K, kind):
    args = _system(5, K, 6, K, kind)
    ref = torch_support.jax_reference(
        lambda: lanes_ref.lane_block_thomas_solve(*args), args)
    got = thomas_cuda.thomas_solve_plain(*[torch.tensor(a) for a in args])
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-10


@pytest.mark.parametrize(("K", "kind"), CPU_CASES)
def test_block_thomas_vjp_matches_jax(K, kind):
    """Values and all four gradients of ``lane_block_thomas_solve`` (the
    linear-system adjoint: a transposed solve through the same dispatch),
    each to 1e-10 of its largest magnitude."""
    args = _system(3, K, 2, 100 + K, kind)

    def cotangents(outputs):
        return [np.random.default_rng(K).normal(size=np.shape(outputs[0]))]

    ref, ref_grads = torch_support.jax_vjp_reference(
        lanes_ref.lane_block_thomas_solve, args, cotangents)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    x = lanes.lane_block_thomas_solve(*ts)
    assert _rel(x.detach().numpy(), np.asarray(ref[0])) <= 1e-10
    grads = torch.autograd.grad(
        x, ts, grad_outputs=torch.tensor(cotangents(ref)[0]))
    for name, g, rg in zip(("lower", "diag", "upper", "rhs"), grads,
                           ref_grads):
        assert _rel(g.numpy(), np.asarray(rg)) <= 1e-10, name


@pytest.mark.parametrize(("K", "counted"), [(48, False), (52, True)])
def test_dispatch_on_cpu(K, counted):
    """K = 48 is inside the kernel's domain: on the CPU the wrapper runs
    the plain twin, and neither a kernel launch nor a torch-op solve is
    counted. K = 52 is outside it: the torch-op loop, counted per K."""
    assert lanes.THOMAS_K_MAX == 48
    args = [torch.tensor(a) for a in _system(3, K, 4, K)]
    launches = thomas_cuda.thomas_solve.launches
    before = lanes.TORCH_OP_THOMAS_CALLS_BY_K.get(K, 0)
    x = lanes.lane_block_thomas_solve(*args)
    assert thomas_cuda.thomas_solve.launches == launches
    assert lanes.TORCH_OP_THOMAS_CALLS_BY_K.get(K, 0) - before == int(counted)
    ref = thomas_cuda.thomas_solve_plain(*args)
    assert _rel(x.numpy(), ref.numpy()) <= 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(args, device):
    """f32 kernel against the f64 plain solve, within max(4 x the f32 plain
    twin's error, 1e-5) of max |x|; f64 kernel against the f64 plain twin
    within 1e-10; one launch each, counted at K."""
    K = args[1].shape[1]
    a64 = [torch.tensor(a, device=device) for a in args]
    a32 = [t.float() for t in a64]
    before = thomas_cuda.thomas_solve.launches_by_k.get(K, 0)
    k32 = thomas_cuda.thomas_solve(*a32).double()
    k64 = thomas_cuda.thomas_solve(*a64)
    assert thomas_cuda.thomas_solve.launches_by_k[K] == before + 2
    truth = thomas_cuda.thomas_solve_plain(*a64)
    p32 = thomas_cuda.thomas_solve_plain(*a32).double()
    truth, k32, k64, p32 = (t.cpu().numpy() for t in (truth, k32, k64, p32))
    assert _rel(k32, truth) <= max(4.0 * _rel(p32, truth), 1e-5)
    assert _rel(k64, truth) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1001, 1004])
@pytest.mark.parametrize("K", PIVOT_K)
def test_pivot_kernel_ragged_w_on_gpu(cuda_device, K, W):
    """W = 1001 leaves a partial last block in both types and takes the
    element copies of lo; W = 1004 takes 16-byte copies, with a partial
    last block of 8 lanes in f32 and full blocks of 4 in f64."""
    _kernel_vs_plain(_system(9, K, W, 40 + K), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("K", PIVOT_K)
def test_pivot_kernel_needs_pivoting_on_gpu(cuda_device, K):
    _kernel_vs_plain(_system(9, K, 1004, 7 + K, "pivot"), cuda_device)


@pytest.mark.cuda
def test_pivot_kernel_adjoint_on_gpu(cuda_device):
    """The autograd Function's backward runs the kernel on the transposed
    system: f64 gradients against autograd through the plain twin, within
    1e-9 of each gradient's largest magnitude; two launches (primal and
    adjoint)."""
    args = _system(13, 48, 130, 7)
    g = torch.tensor(np.random.default_rng(8).normal(size=args[3].shape),
                     device=cuda_device)
    ins_k = [torch.tensor(a, device=cuda_device, requires_grad=True)
             for a in args]
    ins_p = [torch.tensor(a, device=cuda_device, requires_grad=True)
             for a in args]
    before = thomas_cuda.thomas_solve.launches_by_k.get(48, 0)
    (lanes.lane_block_thomas_solve(*ins_k) * g).sum().backward()
    assert thomas_cuda.thomas_solve.launches_by_k[48] == before + 2
    (thomas_cuda.thomas_solve_plain(*ins_p) * g).sum().backward()
    for a, b in zip(ins_k, ins_p):
        assert _rel(a.grad.cpu().numpy(), b.grad.cpu().numpy()) <= 1e-9
