"""The port's wavelength-minor polarized solver
(``rt/disco_vec_minor.solve_nstream_vector``) against the JAX package, in
float64 on the CPU, on the random problems of ``tests/test_nstream_vec.py``
(Rayleigh-like greeks blended with a Henyey-Greenstein tail, 9 layers, 5
wavelengths):

* radiance at nstr 2, 4 and 8 (up- and downwelling users, three azimuths)
  and the gradients of a random linear functional of it with respect to
  every input, to 1e-10 of their largest magnitude; with and without the
  direct-beam term, with and without a chapman matrix (the JAX side read
  from ``golden_test_torch_polarized.npz``, ``tests/torch_support.py``);
* the level fields of ``return_internal`` (the limb source's input);
* at 16 streams, against the dense matrix-exponential vector oracle
  ``tests/bruteforce.solve_brute_vector`` to rtol 3e-5, as
  ``tests/test_nstream_vec.py:245`` holds the JAX solver;
* the conservative Rayleigh slab of ``tests/test_nstream_vec.py:250-294``:
  I, Q, U and DOLP at 16 streams against 8 streams within that test's
  tolerances."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sasktran2_tpu.rt import disco_vec_minor as vec_ref
from sasktran2_tpu_torch.rt import disco_vec_minor

from .bruteforce import solve_brute_vector
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

LEVEL_KEYS = ("i_plus_top", "i_minus_top", "i_plus_bot", "i_minus_bot")
USER_MU = np.array([0.35, 0.8, 0.55])
USER_UP = np.array([True, True, False])
USER_AZI = np.array([0.4, 1.2, 2.4])
GRAD_NAMES = ("dtau", "omega", "a1", "a2", "a3", "b1", "albedo")


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def _problem(seed, nstr, W=5, P=9):
    """Wavelength-minor inputs (dtau, omega, a1, a2, a3, b1, albedo) of
    ``tests/test_nstream_vec.py``'s ``_random_vector_problem``."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 0.6, (P, W))
    omega = rng.uniform(0.3, 0.97, (P, W))
    ls = np.arange(nstr)[:, None, None]
    g = rng.uniform(0.2, 0.7, (1, P, W))
    a1 = (2 * ls + 1) * g**ls
    a2 = 0.7 * a1 * (ls >= 2)
    a3 = 0.5 * a1 * (ls >= 2)
    b1 = 0.3 * a1 * (ls >= 2)
    albedo = rng.uniform(0.0, 0.8, (W,))
    return dtau, omega, a1, a2, a3, b1, albedo


def _pair(nstr, include_ss, chapman, internal):
    mu0 = 0.6
    tab_ref = vec_ref.build_vector_minor_tables(nstr, nstr, mu0, USER_MU)
    tab = disco_vec_minor.build_vector_minor_tables(nstr, nstr, mu0, USER_MU)
    P = 9
    chap = (np.tril(np.ones((P, P))) / mu0
            * (1.0 + 0.02 * np.arange(P)[None, :] / P)) if chapman else None
    f0 = np.array([1.0, 0.8, 1.3, 0.9, 1.1])
    kw = {"include_ss": include_ss, "chapman": chap,
          "return_internal": internal}

    def ref_fn(*args):
        out = vec_ref.solve_nstream_vector(
            *args, tab_ref, USER_UP, USER_AZI, f0=jnp.asarray(f0), **kw)
        if internal:
            return [out[0]] + [out[1]["levels"][k] for k in LEVEL_KEYS]
        return [out]

    def port_fn(*args):
        out = disco_vec_minor.solve_nstream_vector(
            *args, tab, USER_UP, USER_AZI, f0=torch.tensor(f0), **kw)
        if internal:
            return [out[0]] + [out[1]["levels"][k] for k in LEVEL_KEYS]
        return [out]

    return ref_fn, port_fn


def _cotangents(nstr, outputs):
    rng = np.random.default_rng(nstr)
    return [rng.normal(size=np.shape(r)) for r in outputs]


@pytest.mark.parametrize(
    ("nstr", "include_ss", "chapman", "internal"),
    [(2, True, False, False), (4, True, True, True), (4, False, False, False),
     (8, True, False, True)],
)
def test_solve_nstream_vector_matches_jax(nstr, include_ss, chapman,
                                          internal):
    inputs = _problem(7 + nstr, nstr)
    ref_fn, port_fn = _pair(nstr, include_ss, chapman, internal)
    ref, ref_grads = torch_support.jax_vjp_reference(
        ref_fn, inputs, lambda outs: _cotangents(nstr, outs))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = port_fn(*ts)
    assert got[0].shape == (3, 3, 5)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _rel_err(a.detach().numpy(), np.asarray(b)) <= 1e-10
    grads = torch.autograd.grad(
        got, ts,
        grad_outputs=[torch.tensor(c) for c in _cotangents(nstr, ref)])
    for name, g, rg in zip(GRAD_NAMES, grads, ref_grads):
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, name


def test_solve_nstream_vector_16_streams_vs_bruteforce():
    """``tests/test_nstream_vec.py:223-248``: 16 streams, 4 thin layers, 4
    azimuth modes, against the dense expm oracle to rtol 3e-5."""
    nstr = L = 16
    P = M = 4
    rng = np.random.default_rng(61)
    dtau = rng.uniform(0.002, 0.03, P)
    omega = rng.uniform(0.6, 0.95, P)
    ls = np.arange(L)
    g = rng.uniform(0.3, 0.6, (P, 1))
    a1 = (2 * ls + 1) * g**ls
    a2 = 0.7 * a1 * (ls >= 2)
    a3 = 0.5 * a1 * (ls >= 2)
    b1 = 0.3 * a1 * (ls >= 2)
    albedo, mu0 = 0.3, 0.55
    user_mu = np.array([0.9, 0.4])
    user_up = np.array([True, False])
    user_azi = np.array([0.4, 1.7])
    tab = disco_vec_minor.build_vector_minor_tables(
        nstr, L, mu0, user_mu, num_azimuth=M)
    rad = disco_vec_minor.solve_nstream_vector(
        torch.tensor(dtau)[:, None], torch.tensor(omega)[:, None],
        *[torch.tensor(v.T)[:, :, None] for v in (a1, a2, a3, b1)],
        torch.tensor([albedo]), tab, user_up, user_azi, num_azimuth=M,
    )
    ref = solve_brute_vector(
        dtau, omega, a1, a2, a3, b1, albedo, mu0, nstr,
        user_mu, user_up, user_azi, num_azimuth=M,
    )
    np.testing.assert_allclose(rad.numpy()[:, :, 0], ref, rtol=3e-5,
                               atol=1e-9)


def test_dolp_16_vs_8_streams():
    """The conservative Rayleigh slab (the Korkin regime): I, Q, U and
    DOLP at 16 streams against 8, within ``tests/test_nstream_vec.py``'s
    tolerances."""
    L, P = 3, 6
    a1 = np.zeros((P, L))
    a1[:, 0], a1[:, 2] = 1.0, 0.5
    a2 = np.zeros((P, L))
    a2[:, 2] = 3.0
    a3 = np.zeros((P, L))
    b1 = np.zeros((P, L))
    b1[:, 2] = np.sqrt(6.0) / 2.0
    dtau = np.full(P, 0.25 / P)
    omega = np.full(P, 1.0)
    user_mu = np.array([0.7575])

    def run(nstr):
        tab = disco_vec_minor.build_vector_minor_tables(
            nstr, L, 0.9999, user_mu, num_azimuth=3)
        r = disco_vec_minor.solve_nstream_vector(
            torch.tensor(dtau)[:, None], torch.tensor(omega)[:, None],
            *[torch.tensor(v.T)[:, :, None] for v in (a1, a2, a3, b1)],
            torch.tensor([0.0]), tab, np.array([True]), np.array([np.pi]),
            num_azimuth=3,
        )
        return r.numpy()[0, :, 0]

    iqu16, iqu8 = run(16), run(8)
    np.testing.assert_allclose(iqu16, iqu8, rtol=5e-3,
                               atol=1e-5 * abs(iqu8[0]))
    dolp16 = np.hypot(iqu16[1], iqu16[2]) / iqu16[0]
    dolp8 = np.hypot(iqu8[1], iqu8[2]) / iqu8[0]
    np.testing.assert_allclose(dolp16, dolp8, rtol=1e-3)
    assert 0.1 < dolp16 < 0.7
