"""The port's wavelength-minor N-stream solver (``rt/disco_nstream.py``)
against the JAX package's ``solve_nstream`` in float64 on the CPU:
radiance to 1e-10 relative and the gradients with respect to dtau,
omega, beta and albedo to 1e-9, at P = 8 layers, W = 3 wavelengths and
U = 2 user directions (one up, one down).

The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_nstream.npz``
(``tests/torch_support.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import disco_nstream as nstream_ref
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import disco_nstream
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

P, W = 8, 3
USER_MU = np.array([0.5, 0.9])
USER_UP = np.array([True, False])
USER_AZI = np.array([0.3, 1.2])


def _inputs(nstr, seed):
    rng = np.random.default_rng(seed)
    L = nstr
    dtau = rng.uniform(0.01, 0.5, size=(P, W))
    omega = rng.uniform(0.5, 0.99, size=(P, W))
    omega[2, 1] = 1.0  # conservative layer: the clamp and its gradient
    g = rng.uniform(0.0, 0.7, size=(P, W))
    ls = np.arange(L)[:, None, None]
    beta = (2 * ls + 1) * g[None] ** ls
    albedo = rng.uniform(0.1, 0.5, size=W)
    return dtau, omega, beta, albedo


def _chapman(mu0):
    # a pseudo-spherical-like lower-triangular slant matrix
    c = np.tril(np.ones((P, P))) / mu0
    return c * (1.0 + 0.02 * np.arange(P)[None, :] / P)


@pytest.mark.parametrize(("nstr", "chapman", "include_ss", "num_azimuth"), [
    (4, False, True, None),
    (8, True, True, 3),
    (4, True, False, 2),
])
def test_solve_nstream_and_gradients(nstr, chapman, include_ss, num_azimuth):
    mu0 = 0.6
    tables_ref = disco_ref.build_mode_tables(nstr, nstr, mu0, USER_MU)
    tables = mode_tables_from_reference(tables_ref)
    chap = _chapman(mu0) if chapman else None
    f0 = np.array([1.0, 0.8, 1.3])
    inputs = _inputs(nstr, nstr + int(chapman))

    def ref_fn(dtau, omega, beta, albedo):
        return nstream_ref.solve_nstream(
            dtau, omega, beta, albedo, tables_ref, USER_UP, USER_AZI,
            include_ss=include_ss, chapman=chap, num_azimuth=num_azimuth,
            f0=jnp.asarray(f0),
        )

    (ref_out,), ref_grads = torch_support.jax_vjp_reference(
        ref_fn, inputs,
        lambda outs: [np.random.default_rng(1).normal(size=outs[0].shape)])
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = disco_nstream.solve_nstream(
        *ts, tables, USER_UP, USER_AZI, include_ss=include_ss,
        chapman=chap, num_azimuth=num_azimuth, f0=torch.tensor(f0),
    )
    assert out.shape == (2, W)
    assert np.max(np.abs(out.detach().numpy() - ref_out)) <= (
        1e-10 * np.max(np.abs(ref_out))
    )
    ct = np.random.default_rng(1).normal(size=ref_out.shape)
    grads = torch.autograd.grad(out, ts, grad_outputs=torch.tensor(ct))
    for name, g, rg in zip(("dtau", "omega", "beta", "albedo"), grads,
                           ref_grads):
        rg = np.asarray(rg)
        err = np.max(np.abs(g.numpy() - rg)) / np.max(np.abs(rg))
        assert err <= 1e-9, (name, err)


def test_solve_nstream_out_of_slice_raises():
    """Surface and source inputs the solver cannot take: a thermal source
    given by one of its two level arrays, and a BRDF kernel that is not
    one of the port's (``rt.brdf``; ``params.brdf_from_reference``
    carries a JAX-side one over)."""
    tables = disco_nstream.build_mode_tables(4, 4, 0.6, USER_MU)
    ts = [torch.tensor(x) for x in _inputs(4, 0)]
    with pytest.raises(ValueError, match="thermal"):
        disco_nstream.solve_nstream(
            *ts, tables, USER_UP, USER_AZI, thermal_b0=ts[0],
        )
    with pytest.raises(NotImplementedError, match="BRDF"):
        disco_nstream.solve_nstream(
            *ts, tables, USER_UP, USER_AZI, brdf=object(),
            brdf_args=torch.ones((3, 1), dtype=torch.float64),
        )
