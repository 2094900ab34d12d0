"""The PyTorch port's lane-layout primitives against the JAX package's, in
float64 on the CPU: values to 1e-10 relative, gradients (torch autograd
vs ``jax.vjp``) to 1e-9, the tolerances of the JAX package's own
fast-vs-generic checks. On the CPU the Thomas and Jacobi dispatch runs
the kernels' plain twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sasktran2_tpu.ops import lanes as lanes_ref
from sasktran2_tpu.ops import linalg as linalg_ref
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.util import jaxmath
from sasktran2_tpu_torch.ops import lanes, linalg
from sasktran2_tpu_torch.rt import disco
from sasktran2_tpu_torch.util import torchmath
from tests.torch_support import one_torch_thread  # noqa: F401

VAL_RTOL = 1e-10
GRAD_RTOL = 1e-9


def _close(got, ref, rtol):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.max(np.abs(ref)), 1e-300)
    assert np.max(np.abs(got - ref)) <= rtol * scale, (
        np.max(np.abs(got - ref)) / scale
    )


def _check_fn(torch_fn, jax_fn, inputs, seed=0):
    """Values and input gradients of torch_fn vs jax_fn on the same numpy
    inputs, with one random cotangent (output of torch_fn must be a single
    tensor)."""
    ref_out, vjp = jax.vjp(jax.jit(jax_fn), *[jnp.asarray(x) for x in inputs])
    ts = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
          for x in inputs]
    out = torch_fn(*ts)
    _close(out.detach().numpy(), ref_out, VAL_RTOL)
    ct = np.random.default_rng(seed).normal(size=np.shape(ref_out))
    ref_grads = vjp(jnp.asarray(ct))
    grads = torch.autograd.grad(out, ts, grad_outputs=torch.tensor(ct))
    for g, rg in zip(grads, ref_grads):
        _close(g.numpy(), rg, GRAD_RTOL)


def _spd(rng, shape_batch, n, W):
    b = rng.normal(size=shape_batch + (n, n, W))
    return np.einsum("...ikw,...jkw->...ijw", b, b) + n * np.eye(n)[:, :, None]


@pytest.mark.parametrize("name", [
    "lane_mm", "lane_mv", "lane_t", "lane_cholesky", "lane_solve_upper",
    "lane_gauss_solve", "lane_gauss_solve_k26",
])
def test_lane_op(name):
    rng = np.random.default_rng(len(name))
    W = 3
    if name == "lane_mm":
        inputs = [rng.normal(size=(2, 4, 5, W)), rng.normal(size=(2, 5, 3, W))]
    elif name == "lane_mv":
        inputs = [rng.normal(size=(2, 4, 5, W)), rng.normal(size=(2, 5, W))]
    elif name == "lane_t":
        inputs = [rng.normal(size=(2, 4, 5, W))]
    elif name == "lane_cholesky":
        inputs = [_spd(rng, (2,), 5, W)]
    elif name == "lane_solve_upper":
        u = np.triu(rng.normal(size=(2, 5, 5, W)).transpose(0, 3, 1, 2))
        u = u.transpose(0, 2, 3, 1) + 4.0 * np.eye(5)[:, :, None]
        inputs = [u, rng.normal(size=(2, 5, 3, W))]
    else:
        K = 26 if name.endswith("k26") else 5
        a = rng.normal(size=(2, K, K, W)) + 2 * K * np.eye(K)[:, :, None]
        inputs = [a, rng.normal(size=(2, K, 3, W))]
    fn = name.removesuffix("_k26")
    if fn == "lane_cholesky":
        # the factor's upper triangle is structurally zero; differentiate
        # a symmetric function of it so both packages see the same input
        def ref_fn(a):
            return lanes_ref.lane_cholesky(0.5 * (a + lanes_ref.lane_t(a)))

        def port_fn(a):
            return lanes.lane_cholesky(0.5 * (a + lanes.lane_t(a)))
    else:
        ref_fn = getattr(lanes_ref, fn)
        port_fn = getattr(lanes, fn)
    _check_fn(port_fn, ref_fn, inputs)


@pytest.mark.parametrize("spread", [0.0, 1e-6, 3e-3, 0.7])
def test_ediff_ddiff2(spread):
    """Both the series and the exact branch, values and gradients."""
    rng = np.random.default_rng(int(spread * 1e7) + 1)
    a = rng.uniform(0.1, 2.0, size=7)
    b = a + spread * rng.uniform(0.5, 1.0, size=7)
    c = b + spread * rng.uniform(0.5, 1.0, size=7)
    d = rng.uniform(0.01, 3.0, size=7)
    _check_fn(linalg.ediff, linalg_ref.ediff, [a, b, d])
    _check_fn(linalg.ddiff2, linalg_ref.ddiff2, [a, b, c, d])


def test_clamp_ssa_straight_through():
    omega = np.array([0.3, 0.9999, 0.99995, 1.0])
    _check_fn(disco.clamp_ssa, disco_ref.clamp_ssa, [omega])
    t = torch.tensor(omega, requires_grad=True)
    out = disco.clamp_ssa(t)
    assert float(out.detach().max()) == disco.SSA_CEILING
    (g,) = torch.autograd.grad(out.sum(), t)
    np.testing.assert_array_equal(g.numpy(), np.ones(4))


def test_safe_div():
    num = np.array([1.0, 2.0, -3.0, 4.0])
    den = np.array([2.0, 0.0, 0.5, 0.0])
    _check_fn(torchmath.safe_div, jaxmath.safe_div, [num, den])


@pytest.mark.parametrize(("P", "K", "W"), [(6, 4, 5), (9, 8, 3), (3, 26, 2)])
def test_block_thomas_and_adjoint(P, K, W):
    """Plain Thomas forward and the linear-system adjoint; K = 26 takes
    the torch.linalg.solve branch, as the reference takes
    jnp.linalg.solve."""
    rng = np.random.default_rng(P * K)
    lo = rng.normal(size=(P, K, K, W)) * 0.3
    up = rng.normal(size=(P, K, K, W)) * 0.3
    di = rng.normal(size=(P, K, K, W)) + (5.0 + K) * np.eye(K)[:, :, None]
    r = rng.normal(size=(P, K, W))
    _check_fn(lanes.lane_block_thomas_solve,
              lanes_ref.lane_block_thomas_solve, [lo, di, up, r])


def test_block_thomas_rejects_other_shapes():
    """The solver passes [P, K, K, W] blocks only; a leading batch dim or a
    mismatched rhs raises instead of being broadcast."""
    di = torch.eye(4, dtype=torch.float64)[None, :, :, None].expand(3, 4, 4, 2)
    r = torch.ones(3, 4, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="want"):
        lanes.lane_block_thomas_solve(di[None], di[None], di[None], r[None])
    with pytest.raises(ValueError, match="want"):
        lanes.lane_block_thomas_solve(di, di, di, r[:, :3])


def _eig_loss_torch(w, v, c):
    # invariant to the eigenpairs' order and the eigenvectors' signs
    quad = torch.einsum("...iaw,...ijw,...jaw->...aw", v, c, v)
    return torch.sin(w).sum() + (w * quad).sum()


def _eig_loss_jax(w, v, c):
    quad = jnp.einsum("...iaw,...ijw,...jaw->...aw", v, c, v)
    return jnp.sin(w).sum() + (w * quad).sum()


def _sym(a):
    return 0.5 * (a + np.swapaxes(a, -3, -2))


def _degenerate(W):
    # exactly repeated eigenvalues in an exactly decoupled block: the
    # Jacobi sweep never rotates them, so |w_i - w_j| == 0 and the
    # adjoint must zero those pairs
    a = np.zeros((1, 4, 4, W))
    a[0, 0, 0] = 2.0
    a[0, 1, 1] = 1.0
    a[0, 0, 1] = a[0, 1, 0] = 0.5
    a[0, 2, 2] = a[0, 3, 3] = 3.0
    return a


@pytest.mark.parametrize("case", ["n4", "n5_odd", "n8", "degenerate"])
def test_jacobi_eigh_and_adjoint(case):
    rng = np.random.default_rng(len(case))
    W = 3
    if case == "degenerate":
        a = _degenerate(W)
    else:
        n = int(case[1])
        a = _sym(rng.normal(size=(2, n, n, W)))
    n = a.shape[-2]
    c = _sym(rng.normal(size=a.shape))

    w_ref, v_ref = jax.jit(lanes_ref.lane_jacobi_eigh_scan)(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    w, v = lanes.lane_jacobi_eigh_scan(ta)
    # invariants: sorted eigenvalues, and V diag(w) V^T
    _close(np.sort(w.detach().numpy(), axis=-2),
           np.sort(np.asarray(w_ref), axis=-2), VAL_RTOL)
    recon = torch.einsum("...iaw,...aw,...jaw->...ijw", v, w, v)
    recon_ref = jnp.einsum("...iaw,...aw,...jaw->...ijw", v_ref, w_ref, v_ref)
    _close(recon.detach().numpy(), recon_ref, VAL_RTOL)
    _close(recon.detach().numpy(), a, 1e-9)

    (g,) = torch.autograd.grad(
        _eig_loss_torch(w, v, torch.tensor(c)), ta
    )
    g_ref = jax.jit(jax.grad(
        lambda x: _eig_loss_jax(*lanes_ref.lane_jacobi_eigh_scan(x),
                                jnp.asarray(c))
    ))(jnp.asarray(a))
    assert np.all(np.isfinite(g.numpy()))
    _close(g.numpy(), g_ref, GRAD_RTOL)
    assert v.shape == (a.shape[0], n, n, W)
