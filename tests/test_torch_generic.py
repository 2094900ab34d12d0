"""The generic per-wavelength route's solvers in the port against the JAX
package, in float64 on the CPU, on inputs made from numpy seeds, values
and gradients (``torch.autograd`` against ``jax.vjp``) to 1e-10 of their
largest magnitude:

* ``ops.eigen.jacobi_eigh`` at even and odd orders (4; 3 and 9, the
  scalar and vector orders of 6 streams): eigenvalues sorted, the
  reconstruction V diag(w) V^T, and the gradient of an order- and
  sign-invariant matrix function of the eigendecomposition;
* ``ops.linalg.block_tridiag_solve`` below 8 layers (where the reference
  takes its Thomas scan) and from 8 up (its cyclic reduction);
* ``rt.disco.solve_plane_parallel`` and
  ``rt.disco_vec.solve_plane_parallel_vector`` over a Lambertian ground,
  and over a MODIS BRDF with a thermal source, with ``return_internal``: the
  radiance, the level fields, ``t_top``, ``t_ground`` and ``w_quad``;
* ``rt.do_source.ms_source_along_rays`` and ``ms_source_along_rays_vec``
  on a traced limb geometry, with the thermal source and the direct beam.

The JAX side of each test is read from
``sasktran2_tpu_torch/data/golden_test_torch_generic.npz``
(``tests/torch_support.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
from sasktran2_tpu.ops import eigen as eigen_ref
from sasktran2_tpu.ops import linalg as linalg_ref
from sasktran2_tpu.rt import brdf as brdf_ref
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import disco_vec as vec_ref
from sasktran2_tpu.rt import do_source as do_source_ref
from sasktran2_tpu.rt import raytrace as raytrace_ref
from sasktran2_tpu_torch.ops import eigen, linalg
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import brdf, disco, disco_vec, do_source
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

LEVEL_KEYS = ("i_plus_top", "i_minus_top", "i_plus_bot", "i_minus_bot")
USER_MU = np.array([0.5, 0.9, 0.3])
USER_UP = np.array([True, True, False])
USER_AZI = np.array([0.3, 1.2, 2.5])


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def _check_grads(port_fn, ref_fn, inputs, seed, names):
    """Values of ``port_fn`` / ``ref_fn`` (lists of arrays) and the
    gradients of a random linear functional of them with respect to every
    input, each to 1e-10 of its largest magnitude."""
    def cotangents(outputs):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=np.shape(r)) for r in outputs]

    ref, ref_grads = torch_support.jax_vjp_reference(ref_fn, inputs,
                                                     cotangents)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = port_fn(*ts)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel_err(a.detach().numpy(), np.asarray(b)) <= 1e-10, i
    cts = cotangents(ref)
    grads = torch.autograd.grad(
        got, ts, grad_outputs=[torch.tensor(c) for c in cts],
        allow_unused=True)
    for name, g, rg in zip(names, grads, ref_grads):
        g = np.zeros(np.shape(rg)) if g is None else g.numpy()
        assert _rel_err(g, np.asarray(rg)) <= 1e-10, name


@pytest.mark.parametrize("n", [3, 4, 9])
def test_jacobi_eigh_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(2, 5, n, n))
    a = a + np.swapaxes(a, -1, -2)
    c = rng.normal(size=(n, n))

    def invariant(w, v, xp):
        # V exp(w/4) V^T: unchanged by the order and the signs of the pairs
        f = xp.einsum("...ia,...a,...ja->...ij", v, xp.exp(0.25 * w), v)
        cc = jnp.asarray(c) if xp is jnp else torch.tensor(c)
        return (f * cc).sum(-1).sum(-1)

    w_ref = torch_support.jax_reference(
        lambda: eigen_ref.jacobi_eigh(jnp.asarray(a))[0], a)
    w, v = eigen.jacobi_eigh(torch.tensor(a))
    assert w.shape == (2, 5, n) and v.shape == (2, 5, n, n)
    assert _rel_err(np.sort(w.numpy(), -1),
                    np.sort(np.asarray(w_ref), -1)) <= 1e-10
    recon = np.einsum("...ia,...a,...ja->...ij", v.numpy(), w.numpy(),
                      v.numpy())
    assert _rel_err(recon, a) <= 1e-10

    def ref_fn(x):
        return [invariant(*eigen_ref.jacobi_eigh(x), jnp)]

    def port_fn(x):
        return [invariant(*eigen.jacobi_eigh(x), torch)]

    _check_grads(port_fn, ref_fn, [a], n, ["a"])


@pytest.mark.parametrize("P", [5, 12])
def test_block_tridiag_solve_matches_jax(P):
    rng = np.random.default_rng(P)
    K = 4
    lower = rng.normal(size=(3, P, K, K))
    upper = rng.normal(size=(3, P, K, K))
    diag = rng.normal(size=(3, P, K, K)) + 6.0 * np.eye(K)
    rhs = rng.normal(size=(3, P, K))

    def ref_fn(*args):
        return [linalg_ref.block_tridiag_solve(*args)]

    def port_fn(*args):
        return [linalg.block_tridiag_solve(*args)]

    _check_grads(port_fn, ref_fn, [lower, diag, upper, rhs], 10 + P,
                 ["lower", "diag", "upper", "rhs"])


def _layers(W, P, L, seed):
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 0.4, size=(W, P))
    omega = rng.uniform(0.4, 0.99, size=(W, P))
    g = rng.uniform(0.0, 0.7, size=(W, P))
    beta = (2 * np.arange(L) + 1) * g[..., None] ** np.arange(L)
    albedo = rng.uniform(0.1, 0.5, size=W)
    return rng, dtau, omega, beta, albedo


def _greeks(rng, W, P, L):
    g = np.zeros((4, W, P, L))
    g[0, ..., 0] = 1.0
    g[0, ..., 1] = rng.uniform(0.0, 1.0, (W, P))
    g[0, ..., 2] = rng.uniform(0.0, 0.5, (W, P))
    g[1, ..., 2] = rng.uniform(1.0, 3.0, (W, P))
    g[2, ..., 1] = 0.3
    g[2, ..., 2] = rng.uniform(0.0, 1.0, (W, P))
    g[3, ..., 2] = rng.uniform(0.0, 1.0, (W, P))
    return g


def _surface_inputs(rng, W, P, case):
    """(extra numpy inputs, their names, solver kwargs builder): none for
    a Lambertian ground; the MODIS BRDF's arguments and the thermal
    source's layer-top, layer-bottom and surface values for
    ``brdf_thermal``."""
    if case == "lambertian":
        return [], [], lambda pkg: {}
    args = np.stack([rng.uniform(0.1, 0.4, W), rng.uniform(0.0, 0.2, W),
                     rng.uniform(0.0, 0.1, W)], axis=-1)
    b_top = rng.uniform(1.0, 2.0, (W, P))
    b_bot = rng.uniform(1.0, 2.0, (W, P))
    surf = rng.uniform(1.0, 2.0, W)

    def kw(pkg, a, b0, b1, s):
        kernel = brdf_ref.MODISKernel() if pkg == "jax" else brdf.MODISKernel()
        return {"brdf": kernel, "brdf_args": a, "thermal_b0": b0,
                "thermal_b1_bottom": b1, "surface_emission": s}

    return [args, b_top, b_bot, surf], ["brdf_args", "b0", "b1", "surface"], kw


def _outputs(radiance, internal):
    lv = internal["levels"]
    return [radiance] + [lv[k] for k in LEVEL_KEYS] + [
        internal["t_top"], internal["t_ground"]]


@pytest.mark.parametrize("case", ["lambertian", "brdf_thermal"])
def test_solve_plane_parallel_matches_jax(case):
    W, P, nstr, L = 3, 9, 4, 6
    rng, dtau, omega, beta, albedo = _layers(W, P, L, 20)
    extra, names, kw = _surface_inputs(rng, W, P, case)
    f0 = rng.uniform(1.0, 2.0, W)
    chapman = np.tril(np.ones((P, P))) / 0.6 * (
        1.0 + 0.02 * np.arange(P)[None, :] / P)
    tables_ref = disco_ref.build_mode_tables(nstr, L, 0.6, USER_MU)
    tables = mode_tables_from_reference(tables_ref)

    def ref_fn(dt, om, be, al, *ex):
        rad, internal = disco_ref.solve_plane_parallel(
            dt, om, be, al, tables_ref, USER_UP, USER_AZI,
            chapman=jnp.asarray(chapman), f0=jnp.asarray(f0),
            return_internal=True, **kw("jax", *ex))
        return _outputs(rad, internal)

    def port_fn(dt, om, be, al, *ex):
        rad, internal = disco.solve_plane_parallel(
            dt, om, be, al, tables, USER_UP, USER_AZI, chapman=chapman,
            f0=torch.tensor(f0), return_internal=True, **kw("torch", *ex))
        np.testing.assert_array_equal(internal["w_quad"], tables.w)
        return _outputs(rad, internal)

    _check_grads(port_fn, ref_fn, [dtau, omega, beta, albedo, *extra], 21,
                 ["dtau", "omega", "beta", "albedo", *names])


@pytest.mark.parametrize("case", ["lambertian", "brdf_thermal"])
def test_solve_plane_parallel_vector_matches_jax(case):
    W, P, nstr, L = 2, 6, 4, 5
    rng, dtau, omega, _, albedo = _layers(W, P, L, 30)
    greeks = _greeks(rng, W, P, L)
    extra, names, kw = _surface_inputs(rng, W, P, case)
    f0 = rng.uniform(1.0, 2.0, W)
    tables_ref = vec_ref.build_vector_mode_tables(nstr, L, 0.6, USER_MU)
    tables = disco_vec.build_vector_mode_tables(nstr, L, 0.6, USER_MU)

    def ref_fn(dt, om, g, al, *ex):
        rad, internal = vec_ref.solve_plane_parallel_vector(
            dt, om, *g, al, tables_ref, USER_UP, USER_AZI,
            f0=jnp.asarray(f0), return_internal=True, **kw("jax", *ex))
        return _outputs(rad, internal)

    def port_fn(dt, om, g, al, *ex):
        rad, internal = disco_vec.solve_plane_parallel_vector(
            dt, om, *g, al, tables, USER_UP, USER_AZI, f0=torch.tensor(f0),
            return_internal=True, **kw("torch", *ex))
        np.testing.assert_array_equal(internal["w_quad"], tables.w)
        return _outputs(rad, internal)

    _check_grads(port_fn, ref_fn, [dtau, omega, greeks, albedo, *extra], 31,
                 ["dtau", "omega", "greeks", "albedo", *names])


@pytest.fixture(scope="module")
def limb_traced():
    alts = np.linspace(0.0, 100000.0, 9)
    rays = [
        sk.TangentAltitudeSolar(15000.0, 0.3, 200000.0, 0.6),
        sk.TangentAltitudeSolar(45000.0, 1.0, 200000.0, 0.6),
        sk.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0),
    ]
    return raytrace_ref.trace_spherical(alts, 6372000.0, 0.6, rays)


@pytest.mark.parametrize("polarized", [False, True])
def test_ms_source_along_rays_matches_jax(limb_traced, polarized):
    """The source at every real segment's ends (the port gives padded
    segments zero; the line-of-sight integral masks them) from a solve
    with the thermal source, the direct beam included."""
    traced = limb_traced
    W, P, nstr = 3, 8, 4
    rng, dtau, omega, beta, albedo = _layers(W, P, nstr, 40)
    greeks = _greeks(rng, W, P, nstr)
    b_top = rng.uniform(1.0, 2.0, (W, P))
    b_bot = rng.uniform(1.0, 2.0, (W, P))
    f0 = rng.uniform(1.0, 2.0, W)
    one = (np.array([True]), np.array([0.0]))
    if polarized:
        layer = greeks
        tab_ref = vec_ref.build_vector_mode_tables(nstr, nstr, 0.6, [0.5])
        tab = disco_vec.build_vector_mode_tables(nstr, nstr, 0.6, [0.5])
        rows = do_source.build_layer_rows(
            traced, do_source.build_ray_vector_tables(traced, nstr, nstr))
        ray_ref = do_source_ref.build_ray_vector_tables(traced, nstr, nstr)
        mask = traced.mask[None, :, :, None]

        def solve_ref(dt, om, g, al, b0, b1):
            return vec_ref.solve_plane_parallel_vector(
                dt, om, *g, al, tab_ref, *one, f0=jnp.asarray(f0),
                return_internal=True, thermal_b0=b0, thermal_b1_bottom=b1)[1]

        def solve(dt, om, g, al, b0, b1):
            return disco_vec.solve_plane_parallel_vector(
                dt, om, *g, al, tab, *one, f0=torch.tensor(f0),
                return_internal=True, thermal_b0=b0, thermal_b1_bottom=b1)[1]

        source_ref = do_source_ref.ms_source_along_rays_vec
        source = do_source.ms_source_along_rays_vec
    else:
        layer = beta
        tab_ref = disco_ref.build_mode_tables(nstr, nstr, 0.6, np.array([0.5]))
        tab = mode_tables_from_reference(tab_ref)
        rows = do_source.build_layer_rows(
            traced, do_source.build_ray_angular_tables(traced, nstr, nstr))
        ray_ref = do_source_ref.build_ray_angular_tables(traced, nstr, nstr)
        mask = traced.mask[None]

        def solve_ref(dt, om, be, al, b0, b1):
            return disco_ref.solve_plane_parallel(
                dt, om, be, al, tab_ref, *one, f0=jnp.asarray(f0),
                return_internal=True, thermal_b0=b0, thermal_b1_bottom=b1)[1]

        def solve(dt, om, be, al, b0, b1):
            return disco.solve_plane_parallel(
                dt, om, be, al, tab, *one, f0=torch.tensor(f0),
                return_internal=True, thermal_b0=b0, thermal_b1_bottom=b1)[1]

        source_ref = do_source_ref.ms_source_along_rays
        source = do_source.ms_source_along_rays

    def ref_fn(*args):
        ji, jo = source_ref(solve_ref(*args), traced, ray_ref,
                            include_ss=True)
        return [ji * mask, jo * mask]

    def port_fn(*args):
        ji, jo = source(solve(*args), rows, True)
        assert torch.all(ji.detach()[:, traced.mask == 0] == 0.0)
        return [ji, jo]

    _check_grads(port_fn, ref_fn,
                 [dtau, omega, layer, albedo, b_top, b_bot], 41,
                 ["dtau", "omega", "layer", "albedo", "b_top", "b_bot"])
