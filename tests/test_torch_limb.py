"""The port's limb scan and line-of-sight sources against the JAX package,
in float64 on the CPU, at 4 streams (2 for the chain case), about 20
altitudes and 3 wavelengths, with inputs made from numpy seeds:

* ``solve_nstream(..., return_internal=True)``: the level fields, and the
  gradients of a random linear functional of them, to 1e-10 of their
  largest magnitude;
* ``do_source.ms_source_along_rays_minor`` on a traced limb geometry:
  the source at every real segment's ends (padded segments are masked by
  the line-of-sight integral; the port gives them zero) and the gradients
  of a random functional of it, to 1e-10;
* the engine: radiance and every ``wf_*`` (and ``los_optical_depth``) to
  1e-10 of each variable's largest magnitude, for the limb scan at
  ``num_do_sza`` 1 and 2 (DO and exact single scatter), exact single
  scatter with multiple scatter off, table single scatter, occultation,
  Standard and volume-emission-rate emission with their weighting
  function, ``output_los_optical_depth``, and the two-stream limb chain
  with an ozone-like absorber (the cases of ``tests/test_limb.py``,
  ``tests/test_solar_table.py`` and
  ``tests/test_chain.py::test_scalar_full_chain``).

The JAX side of the parity tests is read from
``sasktran2_tpu_torch/data/golden_test_torch_limb.npz``
(``tests/torch_support.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import disco_nstream as nstream_ref
from sasktran2_tpu.rt import do_source as do_source_ref
from sasktran2_tpu.rt import raytrace as raytrace_ref
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import disco_nstream, do_source
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

WAVELENGTHS = np.array([310.0, 400.0, 550.0])
LEVEL_KEYS = ("i_plus_top", "i_minus_top", "i_plus_bot", "i_minus_bot")


def _rel_err(got, ref):
    """max |got - ref| relative to max |ref|; absolute where ref is all
    zero (the albedo weighting function of a limb-only scan)."""
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def _layer_inputs(P, W, nstr, seed):
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 0.5, size=(P, W))
    omega = rng.uniform(0.5, 0.99, size=(P, W))
    g = rng.uniform(0.0, 0.7, size=(P, W))
    ls = np.arange(nstr)[:, None, None]
    beta = (2 * ls + 1) * g[None] ** ls
    albedo = rng.uniform(0.1, 0.5, size=W)
    return dtau, omega, beta, albedo


def _chapman(P, mu0):
    c = np.tril(np.ones((P, P))) / mu0
    return c * (1.0 + 0.02 * np.arange(P)[None, :] / P)


def _solve_pair(inputs, nstr, mu0, chapman, include_ss):
    """The JAX and the port's internals of one solve as functions of
    (dtau, omega, beta, albedo)."""
    P = inputs[0].shape[0]
    tables_ref = disco_ref.build_mode_tables(nstr, nstr, mu0, np.array([0.5]))
    tables = mode_tables_from_reference(tables_ref)
    chap = _chapman(P, mu0) if chapman else None
    f0 = np.array([1.0, 0.8, 1.3])[: inputs[0].shape[1]]
    kw = {"include_ss": include_ss, "chapman": chap,
          "return_internal": True}

    def ref_fn(*args):
        return nstream_ref.solve_nstream(
            *args, tables_ref, np.array([True]), np.array([0.0]),
            f0=jnp.asarray(f0), **kw)[1]

    def port_fn(*args):
        return disco_nstream.solve_nstream(
            *args, tables, np.array([True]), np.array([0.0]),
            f0=torch.tensor(f0), **kw)[1]

    return ref_fn, port_fn


@pytest.mark.parametrize(("chapman", "include_ss"), [(False, True),
                                                     (True, False)])
def test_solve_nstream_levels(chapman, include_ss):
    inputs = _layer_inputs(8, 3, 4, 2 + int(chapman))
    ref_fn, port_fn = _solve_pair(inputs, 4, 0.6, chapman, include_ss)

    def ref_levels(*args):
        return [ref_fn(*args)["levels"][k] for k in LEVEL_KEYS]

    def cotangents(outputs):
        rng = np.random.default_rng(4)
        return [rng.normal(size=np.shape(r)) for r in outputs]

    ref, ref_grads = torch_support.jax_vjp_reference(ref_levels, inputs,
                                                     cotangents)
    ref_internal = torch_support.jax_reference(
        lambda: {k: ref_fn(*inputs)[k] for k in ("omega", "t_top", "sbar")},
        inputs)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    internal = port_fn(*ts)
    got = [internal["levels"][k] for k in LEVEL_KEYS]
    cts = cotangents(ref)
    for k, a, b in zip(LEVEL_KEYS, got, ref):
        assert a.shape == b.shape == (4, 8, 2, 3), k
        assert _rel_err(a.detach().numpy(), np.asarray(b)) <= 1e-10, k
    for key in ("omega", "t_top", "sbar"):
        assert _rel_err(internal[key].detach().numpy(),
                        ref_internal[key]) <= 1e-12, key
    grads = torch.autograd.grad(
        got, ts, grad_outputs=[torch.tensor(c) for c in cts])
    for name, g, rg in zip(("dtau", "omega", "beta", "albedo"), grads,
                           ref_grads):
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, name


@pytest.fixture(scope="module")
def limb_traced():
    alts = np.linspace(0.0, 100000.0, 9)
    rays = [
        sk.TangentAltitudeSolar(15000.0, 0.3, 200000.0, 0.6),
        sk.TangentAltitudeSolar(45000.0, 1.0, 200000.0, 0.6),
        sk.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0),
    ]
    return raytrace_ref.trace_spherical(alts, 6372000.0, 0.6, rays)


@pytest.mark.parametrize("include_ss", [True, False])
def test_ms_source_along_rays_minor(limb_traced, include_ss):
    traced = limb_traced
    nstr = 4
    inputs = _layer_inputs(8, 3, nstr, 9)
    ref_fn, port_fn = _solve_pair(inputs, nstr, 0.6, False, include_ss)
    ref_tables = do_source_ref.build_ray_angular_tables(traced, nstr, nstr)
    tables = do_source.build_ray_angular_tables(traced, nstr, nstr)
    rows = do_source.build_layer_rows(traced, tables)
    mask = traced.mask[..., None]

    def ref_source(*args):
        ji, jo = do_source_ref.ms_source_along_rays_minor(
            ref_fn(*args), traced, ref_tables, include_ss=include_ss)
        return ji * mask, jo * mask

    def cotangents(outputs):
        rng = np.random.default_rng(5)
        return [rng.normal(size=np.shape(r)) * mask for r in outputs]

    ref, ref_grads = torch_support.jax_vjp_reference(ref_source, inputs,
                                                     cotangents)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = do_source.ms_source_along_rays_minor(
        port_fn(*ts), rows, include_ss)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        a = a.detach().numpy()
        assert np.all(a[traced.mask == 0] == 0.0)
        assert _rel_err(a, np.asarray(b)) <= 1e-10
    cts = cotangents(ref)
    grads = torch.autograd.grad(
        got, ts, grad_outputs=[torch.tensor(c) for c in cts])
    for name, g, rg in zip(("dtau", "omega", "beta", "albedo"), grads,
                           ref_grads):
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, name


# --- the engine --------------------------------------------------------------

def _config(pkg, nstr=4, ms="DiscreteOrdinates", ss="Exact", **kw):
    return pkg.Config(
        num_streams=nstr,
        multiple_scatter_source=getattr(pkg.MultipleScatterSource, ms),
        single_scatter_source=getattr(pkg.SingleScatterSource, ss),
        num_singlescatter_moments=kw.pop("nss", 4),
        **kw,
    )


def _geometry(pkg, alts, geometry_type="Spherical"):
    return pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=alts,
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )


def _viewing(pkg, rays):
    viewing = pkg.ViewingGeometry()
    for cls, args in rays:
        viewing.add_ray(getattr(pkg, cls)(*args))
    return viewing


def _constituents(pkg, config, geometry):
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface([0.1, 0.3, 0.2])
    return atmo


def _raw(pkg, config, geometry):
    """Raw-input atmosphere: a background absorber (ssa < 1), a
    Henyey-Greenstein-like phase expansion and an emission profile, with
    the raw mode's unit weighting functions."""
    rng = np.random.default_rng(5)
    alts = geometry.altitudes()
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    z = alts[:, None]
    atmo.storage.total_extinction[:] = (
        2e-5 * np.exp(-z / 8000.0) * rng.uniform(0.8, 1.2, size=(1, 3))
    )
    atmo.storage.ssa[:] = rng.uniform(0.8, 0.99, size=(len(alts), 3))
    g = rng.uniform(0.0, 0.6, size=(len(alts), 3))
    for ell in range(atmo.storage.leg_coeff.shape[0]):
        atmo.storage.leg_coeff[ell] = (2 * ell + 1) * g**ell
    atmo.storage.emission_source[:] = rng.uniform(
        0.5, 2.0, size=(len(alts), 3))
    atmo.surface.albedo[:] = [0.25, 0.3, 0.05]
    atmo.surface.emission[:] = [1.5, 0.7, 1.1]
    return atmo


def _chain(pkg, config, geometry):
    """``tests/test_chain.py``'s US76 + Rayleigh + synthetic ozone chain
    at 3 wavelengths, built on the JAX side and carried over."""
    from sasktran2_tpu.constituent import VMRAltitudeAbsorber
    from sasktran2_tpu.optical.database import OpticalDatabaseGenericAbsorber

    wl = np.linspace(250.0, 850.0, 121)
    xs = (1.1e-21 * np.exp(-0.5 * ((wl - 255.0) / 25.0) ** 2)
          + 4.5e-25 * np.exp(-0.5 * ((wl - 600.0) / 45.0) ** 2))
    o3 = OpticalDatabaseGenericAbsorber(db={
        "coords": {"wavelength_nm": wl},
        "data_vars": {"xs": (("wavelength_nm",), xs)},
    })
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["ozone"] = VMRAltitudeAbsorber(
        o3, geometry.altitudes(), np.full(geometry.altitudes().shape, 1e-6))
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    return atmo


ALTS_20 = np.linspace(0.0, 100000.0, 20)
ALTS_CHAIN = np.arange(0.0, 65001.0, 2500.0)
LIMB = [("TangentAltitudeSolar", (t, 0.3, 200000.0, 0.6))
        for t in (10000.0, 20000.0, 30000.0)]
GROUND = [("GroundViewingSolar", (0.6, 0.5, 0.8, 200000.0))]

# name -> (config keywords, altitudes, rays, atmosphere builder)
CASES = {
    "limb_do_sza1_exact_ss": (
        {}, ALTS_20, LIMB + GROUND, _constituents),
    "limb_do_sza2_do_ss": (
        {"ss": "DiscreteOrdinates", "num_do_sza": 2}, ALTS_20,
        LIMB + [("TangentAltitudeSolar", (25000.0, 1.1, 200000.0, 0.45))],
        _raw),
    "exact_ss_only": (
        {"nstr": 2, "ms": "NoSource"}, ALTS_CHAIN,
        [("TangentAltitudeSolar", (15000.0, 0.3, 200000.0, 0.6))],
        _constituents),
    "table_ss": (
        {"nstr": 2, "ms": "NoSource", "ss": "Table", "nss": 8},
        np.linspace(0.0, 80000.0, 41),
        [("TangentAltitudeSolar", (t, 0.3, 2e5, 0.6))
         for t in (10000.0, 25000.0, 40000.0)],
        _constituents),
    "occultation": (
        {"ms": "NoSource", "ss": "NoSource",
         "occultation_source": sk.OccultationSource.Standard},
        ALTS_20, LIMB + GROUND, _raw),
    "emission_standard_los_od": (
        {"ms": "NoSource", "emission_source": sk.EmissionSource.Standard,
         "output_los_optical_depth": True},
        ALTS_20, LIMB + GROUND, _raw),
    "emission_ver": (
        {"ms": "NoSource", "ss": "NoSource",
         "emission_source": sk.EmissionSource.VolumeEmissionRate},
        ALTS_20, LIMB + GROUND, _raw),
    "chain_twostream_limb": (
        {"nstr": 2, "nss": 16}, ALTS_CHAIN,
        [("TangentAltitudeSolar", (t, 0.0, 200000.0, 0.6))
         for t in (10000.0, 20000.0, 30000.0, 40000.0)],
        _chain),
}


def _engine_case(pkg, name, ref_atmo=None):
    kw, alts, rays, make_atmo = CASES[name]
    kw = dict(kw)
    for key in ("occultation_source", "emission_source"):
        if key in kw:
            kw[key] = getattr(getattr(pkg, type(kw[key]).__name__),
                              kw[key].name)
    config = _config(pkg, **kw)
    geometry = _geometry(pkg, alts)
    viewing = _viewing(pkg, rays)
    if ref_atmo is not None:
        atmo = torch_support.carry_atmosphere(ref_atmo, geometry, config)
    else:
        atmo = make_atmo(pkg, config, geometry)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(name):
    config, geometry, viewing, atmo = _engine_case(sk, name)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    config, geometry, viewing, atmo_t = _engine_case(skt, name, atmo)
    got = skt.Engine(config, geometry, viewing, device="cpu")\
        .calculate_radiance(atmo_t)
    assert set(got.keys()) == set(ref.keys())
    assert any(k.startswith("wf_") for k in ref.keys())
    if config.output_los_optical_depth:
        assert "los_optical_depth" in ref.keys()
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert a.dims == b.dims, key
        a, b = a.to_numpy(), b.to_numpy()
        assert a.shape == b.shape, key
        assert np.all(np.isfinite(a)), key
        assert _rel_err(a, b) <= 1e-10, (key, _rel_err(a, b))
