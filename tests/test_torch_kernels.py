"""The port's kernel modules (``ops/thomas_cuda.py``, ``ops/jacobi_cuda.py``):
their plain PyTorch twins against the JAX package's Pallas kernels run in
interpreter mode, as ``tests/test_pallas_thomas.py`` and
``tests/test_pallas_jacobi.py`` run them, at those tests' shapes, in
float64 (values to 1e-10 relative). A CPU tensor takes the plain twin and
leaves the launch counters at 0. The CUDA kernels themselves run only on
a GPU: those tests carry the ``cuda`` marker and skip without one. On the
card, Thomas runs at K in {4, 8, 16, 24} with ragged W = 1001 and 1004 against
the dense f64 truth (f32, within max(4 x the plain twin's error, 1e-5),
as ``tests/test_pallas_thomas.py`` holds the Pallas kernel) and against
the plain twin in f64 (1e-12); Jacobi runs at n in {2, 8, 16, 24, 32}
against numpy's ``eigh`` (f32: eigenvalue sets and reconstruction
residual) and against the plain twin in f64 (1e-12), and at the engines'
[100, n, n, 1024] for n = 8 (the register branch) and n = 12 and 24 (the
shared-memory branch), and on converged matrices whose pairs are in
reversed order (near-swap rotations), where V must stay orthonormal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sasktran2_tpu.ops.pallas_jacobi import jacobi_eigh_pallas
from sasktran2_tpu.ops.pallas_thomas import thomas_solve_pallas
from sasktran2_tpu_torch.ops import jacobi_cuda, thomas_cuda

THOMAS_SHAPES = [(7, 4, 8), (13, 16, 130), (5, 6, 128)]
JACOBI_SHAPES = [(3, 4, 8), (2, 8, 130), (2, 16, 128)]


def _thomas_inputs(P, K, W, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(P, K, K, W)) * 0.3
    up = rng.normal(size=(P, K, K, W)) * 0.3
    di = rng.normal(size=(P, K, K, W)) + 5.0 * np.eye(K)[:, :, None]
    r = rng.normal(size=(P, K, W))
    return lo, di, up, r


def _sym_inputs(P, n, W):
    a = np.random.default_rng(P + n).normal(size=(P, n, n, W))
    return 0.5 * (a + np.swapaxes(a, -3, -2))


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize(("P", "K", "W"), THOMAS_SHAPES)
def test_thomas_plain_vs_pallas(P, K, W):
    args = _thomas_inputs(P, K, W, 1 + P + K)
    ref = np.asarray(thomas_solve_pallas(
        *[jnp.asarray(a) for a in args], interpret=True
    ))
    before = thomas_cuda.thomas_solve.launches
    got = thomas_cuda.thomas_solve(*[torch.tensor(a) for a in args])
    assert thomas_cuda.thomas_solve.launches == before == 0
    assert _rel(got.numpy(), ref) <= 1e-10


@pytest.mark.parametrize(("P", "n", "W"), JACOBI_SHAPES)
def test_jacobi_plain_vs_pallas(P, n, W):
    """Same tournament and sweeps; the Pallas kernel takes the angle from
    the half-angle tangent and the twin from atan2, which agree to
    roundoff, so the unsorted outputs agree too."""
    sym = _sym_inputs(P, n, W)
    w_ref, v_ref = jacobi_eigh_pallas(jnp.asarray(sym), sweeps=10,
                                      interpret=True)
    before = jacobi_cuda.jacobi_eigh.launches
    w, v = jacobi_cuda.jacobi_eigh(torch.tensor(sym), 10)
    assert jacobi_cuda.jacobi_eigh.launches == before == 0
    assert _rel(w.numpy(), np.asarray(w_ref)) <= 1e-10
    assert _rel(v.numpy(), np.asarray(v_ref)) <= 1e-10
    np.testing.assert_allclose(
        np.sort(w.numpy(), axis=-2),
        np.sort(np.linalg.eigvalsh(np.moveaxis(sym, -1, -3)), axis=-1)
        .swapaxes(-1, -2),
        rtol=1e-10, atol=1e-10,
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(("P", "K", "W"), THOMAS_SHAPES + [(100, 16, 1024)])
def test_thomas_kernel_vs_plain_on_gpu(cuda_device, P, K, W):
    args = [torch.tensor(a, device=cuda_device)
            for a in _thomas_inputs(P, K, W, 1 + P + K)]
    before = thomas_cuda.thomas_solve.launches
    got = thomas_cuda.thomas_solve(*args)
    assert thomas_cuda.thomas_solve.launches == before + 1
    ref = thomas_cuda.thomas_solve_plain(*args)
    assert _rel(got.cpu().numpy(), ref.cpu().numpy()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize(("P", "n", "W"), JACOBI_SHAPES + [
    (100, 8, 1024), (100, 12, 1024), (100, 24, 1024)])
def test_jacobi_kernel_vs_plain_on_gpu(cuda_device, P, n, W):
    a = torch.tensor(_sym_inputs(P, n, W), device=cuda_device)
    before = jacobi_cuda.jacobi_eigh.launches
    w, v = jacobi_cuda.jacobi_eigh(a, 10)
    assert jacobi_cuda.jacobi_eigh.launches == before + 1
    wp, vp = jacobi_cuda.jacobi_eigh_plain(a, 10)
    assert _rel(w.cpu().numpy(), wp.cpu().numpy()) <= 1e-10
    assert _rel(v.cpu().numpy(), vp.cpu().numpy()) <= 1e-10


def _dense_truth(lo, di, up, r, w):
    P, K = r.shape[:2]
    big = np.zeros((P * K, P * K))
    for p in range(P):
        big[p * K:(p + 1) * K, p * K:(p + 1) * K] = di[p, :, :, w]
        if p > 0:
            big[p * K:(p + 1) * K, (p - 1) * K:p * K] = lo[p, :, :, w]
        if p < P - 1:
            big[p * K:(p + 1) * K, (p + 1) * K:(p + 2) * K] = up[p, :, :, w]
    return np.linalg.solve(big, r[:, :, w].ravel()).reshape(P, K)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1001, 1004])
@pytest.mark.parametrize("K", [4, 8, 16, 24])
def test_thomas_kernel_ragged_w_on_gpu(cuda_device, K, W):
    """f32 against the dense f64 truth; f64 against the plain twin. W =
    1001 leaves a partial last block in both types and takes the kernel's
    one-element copies; W = 1004 leaves a partial last block of 16-byte
    copies in f32 (blocks of 8 lanes) and full blocks in f64."""
    P = 9
    lo, di, up, r = _thomas_inputs(P, K, W, 40 + K)
    di = di + 2.0 * np.sqrt(K) * np.eye(K)[:, :, None]  # diagonal dominance
    args32 = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
              for a in (lo, di, up, r)]
    got = thomas_cuda.thomas_solve(*args32).cpu().numpy()
    plain = thomas_cuda.thomas_solve_plain(*args32).cpu().numpy()
    for w in (0, 1, W // 2, W - 3, W - 1):
        truth = _dense_truth(lo, di, up, r, w)
        plain_err = np.max(np.abs(plain[:, :, w] - truth))
        kernel_err = np.max(np.abs(got[:, :, w] - truth))
        assert kernel_err <= max(4.0 * plain_err, 1e-5), (w, kernel_err,
                                                          plain_err)
    args64 = [torch.tensor(a, device=cuda_device) for a in (lo, di, up, r)]
    got64 = thomas_cuda.thomas_solve(*args64).cpu().numpy()
    ref64 = thomas_cuda.thomas_solve_plain(*args64).cpu().numpy()
    assert _rel(got64, ref64) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 8, 16, 24, 32])
def test_jacobi_kernel_vs_eigh_on_gpu(cuda_device, n):
    """f32 with the reference's 7 sweeps (10 at n >= 24, where 7 do not
    converge random matrices) against numpy's eigh; f64 against the plain
    twin."""
    P, W = 3, 130
    sym = _sym_inputs(P, n, W)
    sweeps = 7 if n <= 16 else 10
    a32 = torch.tensor(sym, dtype=torch.float32, device=cuda_device)
    w, v = (t.cpu().double().numpy() for t in jacobi_cuda.jacobi_eigh(a32, sweeps))
    sym32 = sym.astype(np.float32).astype(np.float64)
    expect = np.linalg.eigh(np.moveaxis(sym32, -1, -3))[0]      # [P, W, n]
    got = np.sort(np.moveaxis(w, -1, -2), axis=-1)
    assert np.max(np.abs(got - expect) / (2e-5 + 2e-5 * np.abs(expect))) <= 1.0
    av = np.einsum("pijw,pjaw->piaw", sym32, v)
    assert np.max(np.abs(av - w[:, None] * v)) <= 5e-4
    # the plain twin in f32 is held to the same bound against eigh, so the
    # two f32 solutions may differ by twice that bound
    wp, _ = jacobi_cuda.jacobi_eigh_plain(a32, sweeps)
    plain = np.sort(np.moveaxis(wp.cpu().double().numpy(), -1, -2), axis=-1)
    assert np.max(np.abs(got - plain) / (2e-5 + 2e-5 * np.abs(expect))) <= 2.0
    a64 = torch.tensor(sym, device=cuda_device)
    w64, v64 = jacobi_cuda.jacobi_eigh(a64, 10)
    wp64, vp64 = jacobi_cuda.jacobi_eigh_plain(a64, 10)
    assert _rel(w64.cpu().numpy(), wp64.cpu().numpy()) <= 1e-12
    assert _rel(v64.cpu().numpy(), vp64.cpu().numpy()) <= 1e-12


def _reversed_pairs(n, dtype, tiny, device):
    """Converged [2, n, n, 16] matrices with every pair in reversed order:
    diagonal n, ..., 1 and off-diagonal ``tiny``, so each rotation is a
    near-swap with |a_pq| / |a_qq - a_pp| far below 1e-19."""
    d = np.arange(n, 0, -1, dtype=np.float64)
    a = np.full((n, n), tiny) + np.diag(d - tiny)
    a = np.broadcast_to(a[None, :, :, None], (2, n, n, 16)).copy()
    return torch.tensor(a, dtype=dtype, device=device), d


def _assert_orthonormal_eigh(w, v, d):
    n = d.size
    w, v = w.cpu().double().numpy(), v.cpu().double().numpy()
    vtv = np.einsum("pjaw,pjbw->pabw", v, v)
    assert np.max(np.abs(vtv - np.eye(n)[None, :, :, None])) <= 1e-6
    assert np.max(np.abs(np.sort(w, axis=1) - np.sort(d)[None, :, None])) <= 1e-6 * n


REVERSED_CASES = [(torch.float32, 1e-30), (torch.float64, 1e-300)]


@pytest.mark.parametrize(("dtype", "tiny"), REVERSED_CASES)
@pytest.mark.parametrize("n", [2, 6, 12])
def test_jacobi_plain_reversed_converged_pairs(n, dtype, tiny):
    """The plain twin's atan2 angle keeps V orthonormal where the
    rotation of a converged, reversed pair is a near-swap."""
    a, d = _reversed_pairs(n, dtype, tiny, "cpu")
    _assert_orthonormal_eigh(*jacobi_cuda.jacobi_eigh_plain(a, 7), d)


@pytest.mark.cuda
@pytest.mark.parametrize(("dtype", "tiny"), REVERSED_CASES)
@pytest.mark.parametrize("n", [2, 6, 8, 12, 24])
def test_jacobi_kernel_reversed_converged_pairs_on_gpu(cuda_device, n, dtype,
                                                       tiny):
    """The kernel's near-swap rotation: a tangent (r - x) / y whose square
    overflows float32 would give c = s = 0 and zero two eigenvectors."""
    a, d = _reversed_pairs(n, dtype, tiny, cuda_device)
    _assert_orthonormal_eigh(*jacobi_cuda.jacobi_eigh(a, 7), d)
