"""Successive orders in the port against the JAX package, solver level, in
float64 on the CPU, on inputs made from numpy seeds:

* the host tables bit-equal: ``build_so_geometry`` (every ``SOGeometry``
  field, straight and refracted internal rays), ``observer_source_tables``
  on a traced limb scan, ``build_so_polarized_tables`` and
  ``do_source.build_level_direction_tables``;
* ``successive_orders_field`` (with and without ``j_init``),
  ``successive_orders_field_polarized``, ``so_source_along_rays(_polarized)``
  and ``do_source.ms_source_on_levels``: values and the gradients of a
  random linear functional of them (``torch.autograd`` against
  ``jax.vjp``), each to 1e-10 of its largest magnitude.

The geometry is 12 altitudes (0-60 km) and a 6 x 6 direction grid, built
once per test run on each side. The JAX side of the field and source
tests is read from
``sasktran2_tpu_torch/data/golden_test_torch_successive.npz``
(``tests/torch_support.py``); the host tables are built by both packages
in the run.
"""

import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import do_source as do_source_ref
from sasktran2_tpu.rt import raytrace as raytrace_ref
from sasktran2_tpu.rt import successive as so_ref
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import disco, do_source, successive
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

ALTS = np.linspace(0.0, 60000.0, 12)
RE = 6372000.0
COS_SZA = 0.6
NLEG = 8
N_INC = 6
N_INDEX = 1.0 + 2.8e-4 * np.exp(-ALTS / 8000.0)
W = 2
ITERATIONS = 6


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


def _build(build, refraction):
    return build(
        ALTS, RE, COS_SZA, NLEG, n_mu=N_INC, n_phi=N_INC,
        refractive_index=N_INDEX if refraction else None,
        ms_refraction=refraction,
    )


@pytest.fixture(scope="session")
def geometries():
    """(JAX, port) SO geometries, straight and refracted; the port's
    through its memoised ``so_geometry``."""
    return {r: (_build(so_ref.build_so_geometry, r),
                _build(successive.so_geometry, r))
            for r in (False, True)}


@pytest.fixture(scope="session")
def limb_traced():
    """A traced spherical limb scan with a ground-viewing ray (port and
    JAX tracers give bit-equal tables, pinned elsewhere)."""
    rays = [sk.TangentAltitudeSolar(t, 0.4, 200000.0, COS_SZA)
            for t in (5000.0, 20000.0, 40000.0)]
    rays.append(sk.GroundViewingSolar(COS_SZA, 1.1, 0.7, 200000.0))
    return raytrace_ref.trace_spherical(ALTS, RE, COS_SZA, rays)


def _atmosphere(seed, greeks=1):
    rng = np.random.default_rng(seed)
    ext = 1e-5 * (0.5 + rng.random((W, len(ALTS))))
    ext *= np.exp(-ALTS / 12000.0)[None]
    ssa = 0.6 + 0.35 * rng.random((W, len(ALTS)))
    legs = []
    for g in range(greeks):
        leg = rng.normal(size=(W, len(ALTS), NLEG)) * 0.3 / (
            1.0 + np.arange(NLEG))
        if g == 0:
            leg[..., 0] = 1.0
        legs.append(leg)
    albedo = 0.1 + 0.5 * rng.random(W)
    return ext, ssa, legs, albedo


@pytest.mark.parametrize("refraction", [False, True])
def test_so_geometry_equal(geometries, refraction):
    ref, port = geometries[refraction]
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_so_geometry_memoised(geometries):
    _, port = geometries[False]
    a = successive.so_geometry(ALTS, RE, COS_SZA, NLEG, n_mu=N_INC,
                               n_phi=N_INC)
    b = successive.so_geometry(ALTS.copy(), RE, COS_SZA, NLEG, n_mu=N_INC,
                               n_phi=N_INC)
    c = successive.so_geometry(ALTS, RE, 0.5, NLEG, n_mu=N_INC, n_phi=N_INC)
    assert a is b and a is not c
    for f in dataclasses.fields(port):
        if isinstance(getattr(port, f.name), np.ndarray):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(port, f.name))


def test_observer_and_polarized_tables_equal(geometries, limb_traced):
    ref_geom, port_geom = geometries[False]
    ref_obs = so_ref.observer_source_tables(limb_traced, ref_geom)
    port_obs = successive.observer_source_tables(limb_traced, port_geom)
    ref_pol = so_ref.build_so_polarized_tables(ref_geom, NLEG)
    port_pol = successive.build_so_polarized_tables(port_geom, NLEG)
    ref_lev = do_source_ref.build_level_direction_tables(
        ref_geom.mu_d, ref_geom.phi_d, 8, 8)
    port_lev = do_source.build_level_direction_tables(
        port_geom.mu_d, port_geom.phi_d, 8, 8)
    for ref, port in ((ref_obs, port_obs), (ref_pol, port_pol),
                      (ref_lev, port_lev)):
        assert set(ref) == set(port)
        for k in ref:
            assert port[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_so_geometry_memo_is_bounded(monkeypatch):
    """The memo keeps the most recently used geometries only: a new
    solar zenith angle past the bound drops the least recently used."""
    monkeypatch.setattr(successive, "_GEOMETRY_CACHE", OrderedDict())
    monkeypatch.setattr(successive, "build_so_geometry",
                        lambda *a, **kw: object())
    n = successive.GEOMETRY_CACHE_SIZE

    def get(cos_sza):
        return successive.so_geometry(ALTS, RE, cos_sza, NLEG)

    first = [get(0.1 * (i + 1)) for i in range(n)]
    assert get(0.1) is first[0]              # now the most recent
    extra = get(0.95)
    assert len(successive._GEOMETRY_CACHE) == n
    assert get(0.2) is not first[1]          # the least recent went
    assert get(0.1) is first[0] and get(0.95) is extra


def test_transport_plan_covers_real_segments(geometries):
    """The compact plan keeps exactly the real segments, with each ray's
    boundaries (its point among them), and holds its operators on the
    device and in the dtype it was built for: the scalar phase operator
    for a scalar plan, the polarized ones given the polarized tables."""
    _, geom = geometries[False]
    cpu = torch.device("cpu")
    plan = successive.TransportPlan(geom, cpu, torch.float64)
    assert plan.nseg == int(geom.seg_mask.sum())
    assert plan.nb == plan.nseg + geom.seg_mask.shape[0]
    assert 0.1 < plan.nseg / geom.seg_mask.size < 0.6
    assert "pt" in plan.ops and "b00" not in plan.ops
    pol = successive.TransportPlan(
        geom, cpu, torch.float32,
        successive.build_so_polarized_tables(geom, NLEG))
    assert "pt" not in pol.ops and {"b00", "b02"} <= set(pol.ops)
    for p, dtype in ((plan, torch.float64), (pol, torch.float32)):
        for op in p.ops.values():
            assert op.m.dtype == op.mt.dtype == dtype
            assert op.m.device == cpu
        assert all(t.dtype == dtype for t in p.consts.values())


@pytest.mark.parametrize(("refraction", "with_init"),
                         [(False, False), (False, True), (True, False)])
def test_successive_orders_field_matches_jax(geometries, refraction,
                                             with_init):
    ref_geom, port_geom = geometries[refraction]
    ext, ssa, (leg,), albedo = _atmosphere(3 + refraction + 2 * with_init)
    inputs = [ext, ssa, leg, albedo]
    names = ["extinction", "ssa", "leg_coeff", "albedo"]
    if with_init:
        rng = np.random.default_rng(11)
        inputs.append(rng.random((W, len(ALTS), N_INC * N_INC)) * 1e-2)
        names.append("j_init")

    def ref_fn(*args):
        return list(so_ref.successive_orders_field(
            *args[:4], ref_geom, ITERATIONS,
            j_init=args[4] if with_init else None))

    plan = successive.TransportPlan(port_geom, torch.device("cpu"),
                                    torch.float64)

    def port_fn(*args):
        return list(successive.successive_orders_field(
            *args[:4], plan, ITERATIONS,
            j_init=args[4] if with_init else None))

    _check_grads(port_fn, ref_fn, inputs, 20 + refraction, names)


def test_successive_orders_field_polarized_matches_jax(geometries):
    ref_geom, port_geom = geometries[False]
    ext, ssa, legs, albedo = _atmosphere(7, greeks=4)
    ref_tabs = so_ref.build_so_polarized_tables(ref_geom, NLEG)
    plan = successive.TransportPlan(
        port_geom, torch.device("cpu"), torch.float64,
        successive.build_so_polarized_tables(port_geom, NLEG))

    def ref_fn(e, s, a1, a2, a3, b1, alb):
        return list(so_ref.successive_orders_field_polarized(
            e, s, (a1, a2, a3, b1), alb, ref_geom, ref_tabs, ITERATIONS))

    def port_fn(e, s, a1, a2, a3, b1, alb):
        return list(successive.successive_orders_field_polarized(
            e, s, (a1, a2, a3, b1), alb, plan, ITERATIONS))

    _check_grads(port_fn, ref_fn, [ext, ssa, *legs, albedo], 31,
                 ["extinction", "ssa", "a1", "a2", "a3", "b1", "albedo"])


@pytest.mark.parametrize("polarized", [False, True])
def test_so_source_along_rays_matches_jax(geometries, limb_traced,
                                          polarized):
    ref_geom, port_geom = geometries[False]
    tables = so_ref.observer_source_tables(limb_traced, ref_geom)
    rng = np.random.default_rng(41 + polarized)
    shape = (W, len(ALTS), N_INC * N_INC) + ((3,) if polarized else ())
    j_field = rng.normal(size=shape)
    ref_f = (so_ref.so_source_along_rays_polarized if polarized
             else so_ref.so_source_along_rays)
    port_f = (successive.so_source_along_rays_polarized if polarized
              else successive.so_source_along_rays)

    def ref_fn(j):
        return list(ref_f(j, limb_traced, tables))

    def port_fn(j):
        return list(port_f(j, limb_traced, tables))

    _check_grads(port_fn, ref_fn, [j_field], 43, ["j_field"])


def test_ms_source_on_levels_matches_jax(geometries):
    """The DO-initialisation source of a 4-stream, 4-mode solve (the
    engine's configuration: one user direction, no single scatter) on
    the SO direction grid."""
    _, port_geom = geometries[False]
    nstr, P = 4, len(ALTS) - 1
    rng = np.random.default_rng(51)
    dtau = 0.05 + 0.2 * rng.random((W, P))
    omega = 0.5 + 0.45 * rng.random((W, P))
    beta = rng.normal(size=(W, P, nstr)) * 0.3 / (1.0 + np.arange(nstr))
    beta[..., 0] = 1.0
    albedo = np.array([0.3, 0.1])
    ref_tables = disco_ref.build_mode_tables(
        nstr, nstr, COS_SZA, np.array([0.5]), num_azimuth=nstr)
    port_tables = mode_tables_from_reference(ref_tables)
    dir_tables = do_source.build_level_direction_tables(
        port_geom.mu_d, port_geom.phi_d, nstr, nstr)

    def ref_fn(d, o, b, a):
        _, internal = disco_ref.solve_plane_parallel(
            d, o, b, a, ref_tables, np.array([True]), np.array([0.0]),
            include_ss=False, return_internal=True)
        return [do_source_ref.ms_source_on_levels(internal, dir_tables)]

    def port_fn(d, o, b, a):
        _, internal = disco.solve_plane_parallel(
            d, o, b, a, port_tables, np.array([True]), np.array([0.0]),
            include_ss=False, return_internal=True)
        return [do_source.ms_source_on_levels(internal, dir_tables)]

    _check_grads(port_fn, ref_fn, [dtau, omega, beta, albedo], 53,
                 ["dtau", "omega", "beta", "albedo"])
