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
twin; and the edges of the kernel's tiling: K = 25 and 47 (column
groups partly past K), W = 1 (one live lane of a block) and W = 9 (a
partial last block), a system whose first pivot ties in magnitude
between two rows and on which only the lowest row's pivot, as in
LAPACK's solve, keeps the f64 error inside the gate (a CPU test shows
that the highest row's does not), and the adjoint of the pivot-needing
system at each K.

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
TIE_SCALE = 1e12


def _system(P, K, W, seed, kind="random"):
    """(lo, di, up, r) numpy float64. "random": N(0, 0.3^2) off-diagonal
    blocks, N(0, 1) + (5 + 2 sqrt(K)) I diagonal blocks. "pivot": diagonal
    blocks 10 x a permutation matrix plus N(0, 0.1^2), with di[p, 0, 0] = 0
    in every layer, so the first pivot of every layer must be a row swap.
    "tie": lo = 0 and every diagonal block 10 (I + J) with its rows
    shuffled, J a permutation of 3-cycles (fixed points past the last
    whole cycle), so every layer's first column holds two equal entries.
    "tie_rule": lo = 0 and "random" diagonal blocks, rows 0 and a with
    their dominant entries traded, whose first column then has -s in row
    a and s in row b > a (random per layer and lane), s twice the
    column's largest |entry|, with di[b, b] and r[b] set to TIE_SCALE and
    scaled by it: pivoting row a first solves it to roundoff; row b first
    carries its large entries into every row and loses 1e-8 of max |x|
    or more in f64."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(P, K, K, W)) * 0.3
    up = rng.normal(size=(P, K, K, W)) * 0.3
    r = rng.normal(size=(P, K, W))
    if kind == "random":
        di = rng.normal(size=(P, K, K, W)) + (5.0 + 2.0 * np.sqrt(K)) * np.eye(
            K)[:, :, None]
    elif kind == "tie":
        lo = np.zeros_like(lo)
        cycles = np.arange(K)
        for q in range(0, K - K % 3, 3):
            cycles[q:q + 3] = [q + 1, q + 2, q]
        block = 10.0 * (np.eye(K) + np.eye(K)[cycles])[rng.permutation(K)]
        di = np.broadcast_to(block[:, :, None], (P, K, K, W)).copy()
    elif kind == "tie_rule":
        lo = np.zeros_like(lo)
        dom = 5.0 + 2.0 * np.sqrt(K)
        di = rng.normal(size=(P, K, K, W)) + dom * np.eye(K)[:, :, None]
        a = rng.integers(0, K - 1, size=(P, W))
        b = rng.integers(a + 1, K)
        pi, wi = np.meshgrid(np.arange(P), np.arange(W), indexing="ij")
        # rows 0 and a trade their dominant columns, so that once row a
        # is pivoted no other row holds a dominant entry of it
        for i, j, sign in ((a, a, -1), (0, a, 1), (0, 0, -1), (a, 0, 1)):
            di[pi, i, j, wi] += sign * dom
        s = 2.0 * np.abs(di[:, :, 0, :]).max(axis=1)
        di[pi, a, 0, wi] = -s
        di[pi, b, 0, wi] = s
        di[pi, b, b, wi] = TIE_SCALE
        r[pi, b, wi] *= TIE_SCALE
    else:
        perm = rng.permutation(K)
        perm = np.roll(perm, -int(np.argmax(perm == 0)) - 1)  # perm[0] != 0
        di = rng.normal(size=(P, K, K, W)) * 0.1 + 10.0 * np.eye(K)[perm][
            :, :, None]
        di[:, 0, 0, :] = 0.0
    return lo, di, up, r


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


CPU_CASES = [(26, "random"), (48, "random"), (48, "pivot"), (48, "tie")]


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
    within 1e-10; one launch each, counted at K. The plain twin runs on
    the CPU (LAPACK: the lowest row wins a tie in |pivot|)."""
    K = args[1].shape[1]
    a64 = [torch.tensor(a, device=device) for a in args]
    a32 = [t.float() for t in a64]
    before = thomas_cuda.thomas_solve.launches_by_k.get(K, 0)
    k32 = thomas_cuda.thomas_solve(*a32).double()
    k64 = thomas_cuda.thomas_solve(*a64)
    assert thomas_cuda.thomas_solve.launches_by_k[K] == before + 2
    truth = thomas_cuda.thomas_solve_plain(*[torch.tensor(a) for a in args])
    p32 = thomas_cuda.thomas_solve_plain(*[t.cpu() for t in a32]).double()
    truth, k32, k64, p32 = (t.cpu().numpy() for t in (truth, k32, k64, p32))
    assert _rel(k32, truth) <= max(4.0 * _rel(p32, truth), 1e-5)
    assert _rel(k64, truth) <= 1e-10


def _gauss_jordan(a, rhs, lowest):
    """Gauss-Jordan with partial pivoting in float64, rows never swapped, as
    the kernel solves a block; a tie in |pivot| goes to the lowest row, or
    to the highest."""
    a, rhs = np.array(a, dtype=float), np.array(rhs, dtype=float)
    free, order = np.ones(len(a), bool), []
    for s in range(len(a)):
        mag = np.where(free, np.abs(a[:, s]), -1.0)
        rows = np.flatnonzero(mag == mag.max())
        q = rows[0] if lowest else rows[-1]
        free[q] = False
        order.append(q)
        rhs[q] /= a[q, s]
        a[q] /= a[q, s]
        m = a[:, s].copy()
        m[q] = 0.0
        a -= np.outer(m, a[q])
        rhs -= m * rhs[q]
    return rhs[order]


@pytest.mark.parametrize("K", [26, 48])
def test_tie_rule_system_tells_the_rules_apart(K):
    """On the "tie_rule" blocks the card cases' f64 gate, 1e-10 of max |x|,
    holds for a solve that pivots the lowest of the tied rows and misses
    by 10x or more for one that pivots the highest: the card case sees the
    kernel's tie rule, not only that its threads agree on a pivot."""
    _, di, _, r = _system(1, K, 4, 11 + K, "tie_rule")
    for w in range(4):
        a, rhs = di[0, :, :, w], r[0, :, w]
        truth = np.linalg.solve(a, rhs)
        assert _rel(_gauss_jordan(a, rhs, lowest=True), truth) <= 1e-10
        assert _rel(_gauss_jordan(a, rhs, lowest=False), truth) > 1e-9


EDGE_K = [25, 47]  # column groups partly past K
ALL_K = sorted(PIVOT_K + EDGE_K)


@pytest.mark.cuda
@pytest.mark.parametrize(
    ("K", "W"), [(K, W) for K in PIVOT_K for W in (1001, 1004)]
    + [(K, W) for K in EDGE_K + [48] for W in (1, 9)])
def test_pivot_kernel_ragged_w_on_gpu(cuda_device, K, W):
    """Lanes that leave a block part empty: W = 1001 a partial last block
    in both types (8 lanes a block in f32, 4 in f64), W = 1004 in f32
    only, W = 9 in both, W = 1 one live lane (the f64 adjoint of a single
    wavelength); K = 25 and 47 leave column groups partly past K. Every
    copy of an operand is one element, so W's alignment does not matter."""
    _kernel_vs_plain(_system(9, K, W, 40 + K), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pivot", "tie_rule"])
@pytest.mark.parametrize("K", ALL_K)
def test_pivot_kernel_needs_pivoting_on_gpu(cuda_device, K, kind):
    _kernel_vs_plain(_system(9, K, 1004, 7 + K, kind), cuda_device)


def _adjoint_vs_plain(args, device):
    """The autograd Function's backward runs the kernel on the transposed
    system: f64 gradients against autograd through the plain twin, within
    1e-9 of each gradient's largest magnitude; two launches (primal and
    adjoint)."""
    K = args[1].shape[1]
    g = torch.tensor(np.random.default_rng(8).normal(size=args[3].shape),
                     device=device)
    ins_k = [torch.tensor(a, device=device, requires_grad=True)
             for a in args]
    ins_p = [torch.tensor(a, device=device, requires_grad=True)
             for a in args]
    before = thomas_cuda.thomas_solve.launches_by_k.get(K, 0)
    (lanes.lane_block_thomas_solve(*ins_k) * g).sum().backward()
    assert thomas_cuda.thomas_solve.launches_by_k[K] == before + 2
    (thomas_cuda.thomas_solve_plain(*ins_p) * g).sum().backward()
    for a, b in zip(ins_k, ins_p):
        assert _rel(a.grad.cpu().numpy(), b.grad.cpu().numpy()) <= 1e-9


@pytest.mark.cuda
def test_pivot_kernel_adjoint_on_gpu(cuda_device):
    _adjoint_vs_plain(_system(13, 48, 130, 7), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("K", ALL_K)
def test_pivot_kernel_adjoint_needs_pivoting_on_gpu(cuda_device, K):
    _adjoint_vs_plain(_system(9, K, 37, 70 + K, "pivot"), cuda_device)
