"""The port's DO and two-stream thermal emission against the JAX package,
in float64 on the CPU, with inputs made from numpy seeds:

* ``solve_nstream`` (4 and 8 streams), ``solve_nstream_m0_levels`` and
  ``solve_twostream`` with thermal sources (Planck values at the layer
  tops and bottoms, one layer whose values are not both positive, and
  surface emission) beside the solar beam: outputs to 1e-10 and the
  gradients with respect to every input to 1e-10 of their largest
  magnitude;
* the limb DO source ``do_source.ms_source_along_rays_minor`` of a
  thermal solve, to 1e-10 with its gradients;
* the engine with Jacobians: a thermal infrared atmosphere (US76,
  Rayleigh, a tabulated absorber, ``ThermalEmission``,
  ``SurfaceThermalEmission``) on ground-viewing rays with flux observers
  and on limb rays, and raw-input atmospheres carried over by
  ``params.atmosphere_from_reference``, at nstr = 2 (the two-stream
  solver) and 4: radiance, fluxes and every ``wf_*`` to 1e-10 of each
  variable's largest magnitude. The flux weighting functions of the
  thermal infrared atmosphere are held to 1e-8 (``FLUX_WF_TOL``): at its
  top layers (dtau ~1e-10 at 4.5 um) the JAX package's own two routes,
  its fast path and its generic per-wavelength route, differ by up to
  1.8e-9 in the pressure weighting functions of the fluxes, and the port
  differs from the fast path by up to 5.9e-10 (both measured on this
  case);
* the DISORT 7a oracles of ``tests/test_thermal.py:45-99`` (thermal only,
  with surface emission, the isothermal blackbody limit, Standard against
  DO emission) through the port alone;
* float32: the temperature and emission weighting functions stay finite
  and near float64 at the top layers;
* polarized DO and two-stream thermal emission, ground-viewing and limb,
  through the port's generic route against the JAX package's, to 1e-10.

The JAX side of the solver and engine parity tests is read from
``sasktran2_tpu_torch/data/golden_test_torch_thermal.npz``
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
from sasktran2_tpu.rt import twostream as twostream_ref
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import disco_nstream, do_source, twostream
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

LEVEL_KEYS = ("i_plus_top", "i_minus_top", "i_plus_bot", "i_minus_bot")
INPUT_NAMES = ("dtau", "omega", "beta", "albedo", "thermal_b0",
               "thermal_b1_bottom", "surface_emission")
USER_MU = np.array([0.5, 0.9, 0.3])
USER_UP = np.array([True, True, False])
USER_AZI = np.array([0.3, 1.2, 2.5])
F0 = np.array([0.5, 0.0, 1.3])


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def _inputs(P, W, nstr, seed):
    """Layer optics and thermal sources [P, W]: the first layer of the
    first wavelength has a zero Planck value at its top, which takes the
    flat-mean branch of the layer fit."""
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 0.5, size=(P, W))
    omega = rng.uniform(0.2, 0.95, size=(P, W))
    g = rng.uniform(0.0, 0.7, size=(P, W))
    ls = np.arange(max(nstr, 3))[:, None, None]
    beta = (2 * ls + 1) * g[None] ** ls
    albedo = rng.uniform(0.05, 0.4, size=W)
    b_top = rng.uniform(0.5, 1.5, size=(P, W))
    b_bot = b_top * rng.uniform(0.8, 1.25, size=(P, W))
    b_top[0, 0] = 0.0
    surf = rng.uniform(0.5, 2.0, size=W)
    return dtau, omega, beta, albedo, b_top, b_bot, surf


def _cotangents(seed):
    """The seeded cotangents of a list of outputs."""

    def make(outputs):
        rng = np.random.default_rng(seed)
        return [rng.normal(size=np.shape(r)) for r in outputs]

    return make


def _reference(ref_fn, inputs, seed):
    """The JAX function's outputs and its vjp at ``_cotangents(seed)``
    (``tests/torch_support.py``)."""
    return torch_support.jax_vjp_reference(ref_fn, inputs, _cotangents(seed))


def _check_vjp(got, ref, ref_grads, ts, seed):
    """Outputs to 1e-10, then the gradients of a random functional of
    them with respect to every input to 1e-10."""
    got = list(got) if isinstance(got, (list, tuple)) else [got]
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert _rel_err(a.detach().numpy(), np.asarray(b)) <= 1e-10, i
    cts = _cotangents(seed)(ref)
    grads = torch.autograd.grad(
        got, ts, grad_outputs=[torch.tensor(c) for c in cts])
    for name, g, rg in zip(INPUT_NAMES, grads, ref_grads):
        assert np.all(np.isfinite(g.numpy())), name
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, name


@pytest.mark.parametrize(("nstr", "chapman", "num_azimuth"),
                         [(4, False, None), (8, True, 3)])
def test_solve_nstream_thermal_matches_jax(nstr, chapman, num_azimuth):
    P, mu0 = 6, 0.6
    tables_ref = disco_ref.build_mode_tables(nstr, nstr, mu0, USER_MU)
    tables = mode_tables_from_reference(tables_ref)
    chap = None
    if chapman:
        chap = np.tril(np.ones((P, P))) / mu0 * (
            1.0 + 0.02 * np.arange(P)[None, :] / P)
    inputs = _inputs(P, 3, nstr, 20 + nstr)
    kw = {"chapman": chap, "num_azimuth": num_azimuth}

    def ref_fn(dtau, omega, beta, albedo, b0, b1, surf):
        return nstream_ref.solve_nstream(
            dtau, omega, beta, albedo, tables_ref, USER_UP, USER_AZI,
            f0=jnp.asarray(F0), thermal_b0=b0, thermal_b1_bottom=b1,
            surface_emission=surf, **kw)

    ref, ref_grads = _reference(ref_fn, inputs, 1)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = disco_nstream.solve_nstream(
        *ts[:4], tables, USER_UP, USER_AZI, f0=torch.tensor(F0),
        thermal_b0=ts[4], thermal_b1_bottom=ts[5], surface_emission=ts[6],
        **kw)
    _check_vjp(got, ref, ref_grads, ts, 1)


def test_solve_nstream_m0_levels_thermal_matches_jax():
    nstr = 4
    tables_ref = disco_ref.build_mode_tables(
        nstr, nstr, 0.6, np.array([0.5]), num_azimuth=1)
    tables = mode_tables_from_reference(tables_ref)
    inputs = _inputs(6, 3, nstr, 31)

    def ref_fn(dtau, omega, beta, albedo, b0, b1, surf):
        lv, t_top, t_ground = nstream_ref.solve_nstream_m0_levels(
            dtau, omega, beta, albedo, tables_ref, f0=jnp.asarray(F0),
            thermal_b0=b0, thermal_b1_bottom=b1, surface_emission=surf)
        return [lv[k] for k in LEVEL_KEYS]

    ref, ref_grads = _reference(ref_fn, inputs, 2)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    lv, _, _ = disco_nstream.solve_nstream_m0_levels(
        *ts[:4], tables, f0=torch.tensor(F0), thermal_b0=ts[4],
        thermal_b1_bottom=ts[5], surface_emission=ts[6])
    _check_vjp([lv[k] for k in LEVEL_KEYS], ref, ref_grads, ts, 2)


def test_solve_twostream_thermal_matches_jax():
    tables_ref = disco_ref.build_mode_tables(2, 2, 0.6, USER_MU)
    tables = mode_tables_from_reference(tables_ref)
    inputs = _inputs(8, 3, 2, 41)

    def ref_fn(dtau, omega, beta, albedo, b0, b1, surf):
        return twostream_ref.solve_twostream(
            dtau, omega, beta, albedo, tables_ref, USER_UP, USER_AZI,
            f0=jnp.asarray(F0), thermal_b0=b0, thermal_b1_bottom=b1,
            surface_emission=surf)

    ref, ref_grads = _reference(ref_fn, inputs, 3)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = twostream.solve_twostream(
        *ts[:4], tables, USER_UP, USER_AZI, f0=torch.tensor(F0),
        thermal_b0=ts[4], thermal_b1_bottom=ts[5], surface_emission=ts[6])
    _check_vjp(got, ref, ref_grads, ts, 3)


def test_limb_source_thermal_matches_jax():
    """The limb DO source of a thermal solve at every real segment end of
    a traced limb geometry (padded segments are masked by the line of
    sight's integral; the port gives them zero)."""
    alts = np.linspace(0.0, 100000.0, 9)
    traced = raytrace_ref.trace_spherical(alts, 6372000.0, 0.6, [
        sk.TangentAltitudeSolar(15000.0, 0.3, 200000.0, 0.6),
        sk.TangentAltitudeSolar(45000.0, 1.0, 200000.0, 0.6),
    ])
    nstr = 4
    tables_ref = disco_ref.build_mode_tables(nstr, nstr, 0.6, np.array([0.5]))
    tables = mode_tables_from_reference(tables_ref)
    ref_rays = do_source_ref.build_ray_angular_tables(traced, nstr, nstr)
    rows = do_source.build_layer_rows(
        traced, do_source.build_ray_angular_tables(traced, nstr, nstr))
    mask = traced.mask[..., None]
    inputs = _inputs(8, 3, nstr, 51)
    one = (np.array([True]), np.array([0.0]))

    def ref_fn(dtau, omega, beta, albedo, b0, b1, surf):
        _, internal = nstream_ref.solve_nstream(
            dtau, omega, beta, albedo, tables_ref, *one, f0=jnp.asarray(F0),
            thermal_b0=b0, thermal_b1_bottom=b1, surface_emission=surf,
            return_internal=True)
        ji, jo = do_source_ref.ms_source_along_rays_minor(
            internal, traced, ref_rays, include_ss=True)
        return ji * mask, jo * mask

    ref, ref_grads = _reference(ref_fn, inputs, 4)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    _, internal = disco_nstream.solve_nstream(
        *ts[:4], tables, *one, f0=torch.tensor(F0), thermal_b0=ts[4],
        thermal_b1_bottom=ts[5], surface_emission=ts[6],
        return_internal=True)
    got = do_source.ms_source_along_rays_minor(internal, rows, True)
    for a in got:
        assert np.all(a.detach().numpy()[traced.mask == 0] == 0.0)
    _check_vjp(got, ref, ref_grads, ts, 4)


# --- the engine --------------------------------------------------------------

def _thermal_constituents(pkg, config, geometry, wavelengths):
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wavelengths)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    alts = geometry.altitudes()
    xs_wl = np.linspace(3900.0, 15100.0, 57)
    xs = 10.0 ** np.random.default_rng(0).uniform(-28.0, -24.0, xs_wl.size)
    atmo["absorber"] = pkg.constituent.VMRAltitudeAbsorber(
        pkg.optical.TabulatedCrossSectionAbsorber(xs_wl, xs), alts,
        np.full(len(alts), 4e-4))
    atmo["thermal"] = pkg.constituent.ThermalEmission()
    atmo["surface_emission"] = pkg.constituent.SurfaceThermalEmission(
        288.15, 0.98)
    atmo["surface"] = pkg.constituent.LambertianSurface(0.02)
    atmo.storage.solar_irradiance[:] = 0.0
    return atmo


def _thermal_raw(pkg, config, geometry, wavelengths):
    """Raw input: extinction, ssa and a Henyey-Greenstein-like expansion
    from numpy seed 6, level emission, surface emission, the sun on."""
    rng = np.random.default_rng(6)
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wavelengths)
    z = geometry.altitudes()[:, None]
    W = len(wavelengths)
    atmo.storage.total_extinction[:] = 3e-5 * np.exp(-z / 8000.0) * (
        rng.uniform(0.8, 1.2, size=(1, W)))
    atmo.storage.ssa[:] = rng.uniform(0.3, 0.95, size=(len(z), W))
    g = rng.uniform(0.0, 0.6, size=(len(z), W))
    for ell in range(atmo.storage.leg_coeff.shape[0]):
        atmo.storage.leg_coeff[ell] = (2 * ell + 1) * g**ell
    atmo.storage.emission_source[:] = 1e-5 * (1.0 + 0.5 * np.cos(z / 2e4)) * (
        rng.uniform(0.8, 1.2, size=(1, W)))
    atmo.storage.solar_irradiance[:] = rng.uniform(0.5, 1.5, size=W)
    atmo.surface.albedo[:] = rng.uniform(0.05, 0.3, size=W)
    atmo.surface.emission[:] = rng.uniform(1e-5, 2e-5, size=W)
    return atmo


# name -> (nstr, multiple scatter, geometry type, rays, flux observers,
# atmosphere builder, wavelengths)
THERMAL_WL = np.array([4500.0, 9000.0, 12000.0])
# the flux weighting functions of "ground_flux_constituents" (see the
# module's docstring): the JAX package's generic route differs from its
# fast path by up to 1.8e-9 there
FLUX_WF_TOL = 1e-8
CASES = {
    "ground_flux_constituents": (
        4, "DiscreteOrdinates", "PlaneParallel",
        [("GroundViewingSolar", (0.6, 0.5, mu, 2e5)) for mu in (0.5, 0.9)],
        (0.0, 30000.0), _thermal_constituents, THERMAL_WL),
    "limb_constituents": (
        4, "DiscreteOrdinates", "Spherical",
        [("TangentAltitudeSolar", (t, 0.4, 2e5, 0.6))
         for t in (10000.0, 40000.0)],
        (), _thermal_constituents, THERMAL_WL),
    "ground_raw_pseudospherical": (
        4, "DiscreteOrdinates", "PseudoSpherical",
        [("GroundViewingSolar", (0.6, 0.5, 0.7, 2e5)),
         ("SolarAnglesObserverLocation", (0.6, 1.1, -0.8, 2e5))],
        (10000.0,), _thermal_raw, np.array([500.0, 600.0, 700.0])),
    "twostream_raw": (
        2, "TwoStream", "PlaneParallel",
        [("GroundViewingSolar", (0.6, 0.3, 0.8, 2e5)),
         ("GroundViewingSolar", (0.6, 1.3, 0.4, 2e5))],
        (), _thermal_raw, np.array([500.0, 600.0, 700.0])),
}


def _engine_case(pkg, name, ref_atmo=None, emission="DiscreteOrdinates"):
    nstr, ms, geometry_type, rays, flux_alts, build, wl = CASES[name]
    config = pkg.Config(
        num_streams=nstr,
        multiple_scatter_source=getattr(pkg.MultipleScatterSource, ms),
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        emission_source=getattr(pkg.EmissionSource, emission),
        num_singlescatter_moments=max(nstr, 4),
        flux_types=(pkg.FluxType.Upwelling, pkg.FluxType.Downwelling,
                    pkg.FluxType.Actinic, pkg.FluxType.Divergence),
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 11),
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )
    viewing = pkg.ViewingGeometry()
    for cls, args in rays:
        viewing.add_ray(getattr(pkg, cls)(*args))
    for alt in flux_alts:
        viewing.add_flux_observer(pkg.FluxObserverSolar(0.6, alt))
    if ref_atmo is not None:
        return config, geometry, viewing, torch_support.carry_atmosphere(
            ref_atmo, geometry, config)
    return config, geometry, viewing, build(pkg, config, geometry, wl)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_thermal_matches_jax(name):
    config, geometry, viewing, atmo = _engine_case(sk, name)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    assert ref.extra["twostream_fast_ok"]
    raw = CASES[name][5] is _thermal_raw
    config, geometry, viewing, atmo_t = _engine_case(
        skt, name, ref_atmo=atmo if raw else None)
    got = skt.Engine(config, geometry, viewing, device="cpu")\
        .calculate_radiance(atmo_t)
    assert set(got.keys()) == set(ref.keys())
    wfs = [k for k in ref.keys() if k.startswith("wf_")]
    assert ("wf_emission" if raw else "wf_thermal_temperature_k") in wfs
    tol = dict.fromkeys(ref.keys(), 1e-10)
    if name == "ground_flux_constituents":
        tol.update({k: FLUX_WF_TOL for k in ref.keys()
                    if k.startswith("wf_") and k.endswith("_flux")})
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert a.dims == b.dims, key
        err = _rel_err(a.to_numpy(), b.to_numpy())
        assert err <= tol[key], (key, err, tol[key])


def test_thermal_weighting_functions_in_float32():
    """float32 on the CPU (the working dtype forced past the CPU's float64
    rule): every temperature and emission weighting function is finite,
    and at the top three levels within 1e-3 of float64 relative to the
    variable's largest magnitude; the fluxes and their weighting functions
    (solved in float64 under thermal emission) within 1e-5 (measured:
    2.1e-6 at most)."""
    outs = {}
    for dt in (torch.float64, torch.float32):
        config, geometry, viewing, atmo = _engine_case(
            skt, "ground_flux_constituents")
        engine = skt.Engine(config, geometry, viewing, device="cpu")
        engine._dtype = dt
        outs[dt] = engine.calculate_radiance(atmo)
    o32, o64 = outs[torch.float32], outs[torch.float64]
    names = [k for k in o64.keys() if k.startswith("wf_thermal_temperature")]
    assert len(names) == 5
    for key in names:
        a, b = o32[key].to_numpy(), o64[key].to_numpy()
        assert np.all(np.isfinite(a)), key
        scale = np.max(np.abs(b))
        top = np.max(np.abs(a[-3:] - b[-3:])) / scale
        assert top <= (1e-5 if key.endswith("_flux") else 1e-3), (key, top)
    for key in o64.keys():
        if key.endswith("_flux"):
            err = _rel_err(o32[key].to_numpy(), o64[key].to_numpy())
            assert err <= 1e-5, (key, err)


# --- the DISORT 7a oracles (tests/test_thermal.py) -----------------------

def _disort7a(od, with_surface_emission=False):
    config = skt.Config(
        multiple_scatter_source=skt.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=skt.SingleScatterSource.DiscreteOrdinates,
        emission_source=skt.EmissionSource.DiscreteOrdinates,
        num_streams=16, num_singlescatter_moments=17, delta_m_scaling=True,
    )
    geometry = skt.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.array([0.0, 1000.0]),
        geometry_type=skt.GeometryType.PlaneParallel,
    )
    viewing = skt.ViewingGeometry()
    viewing.add_ray(skt.GroundViewingSolar(0.6, 0.0, 1.0, 200000.0))
    atmo = skt.Atmosphere(geometry, config, numwavel=1,
                          calculate_derivatives=False)
    atmo.storage.total_extinction[:] = od / 1000.0
    atmo.storage.ssa[:] = 0.95
    atmo.storage.solar_irradiance[:] = 0.0
    atmo.storage.emission_source[:] = 1.09657540e-05
    if with_surface_emission:
        atmo.surface.emission[:] = 1.09657540e-05
    for ell in range(17):
        atmo.leg_coeff.a1[ell][:] = 0.75**ell * (2 * ell + 1)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    return engine.calculate_radiance(atmo)["radiance"].to_numpy()[0, 0, 0]


@pytest.mark.parametrize(("od", "surface", "expected"), [
    (100.0, False, 7.93075833e-06), (1.0, True, 1.02396134e-05),
])
def test_disort7a_oracle(od, surface, expected):
    np.testing.assert_allclose(_disort7a(od, surface), expected, rtol=1e-5)


def _slab(emission, ms, nstr, ext, ssa, b, alts, mu=0.8):
    config = skt.Config(
        multiple_scatter_source=ms,
        single_scatter_source=(
            skt.SingleScatterSource.DiscreteOrdinates
            if ms != skt.MultipleScatterSource.NoSource
            else skt.SingleScatterSource.NoSource),
        emission_source=emission, num_streams=nstr,
        num_singlescatter_moments=4,
    )
    geometry = skt.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=alts, geometry_type=skt.GeometryType.PlaneParallel,
    )
    viewing = skt.ViewingGeometry()
    viewing.add_ray(skt.GroundViewingSolar(0.6, 0.0, mu, 200000.0))
    atmo = skt.Atmosphere(geometry, config, numwavel=1,
                          calculate_derivatives=False)
    atmo.storage.total_extinction[:] = ext
    atmo.storage.ssa[:] = ssa
    atmo.storage.solar_irradiance[:] = 0.0
    atmo.storage.emission_source[:] = b
    atmo.leg_coeff.a1[0][:] = 1.0
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    return engine.calculate_radiance(atmo)["radiance"].to_numpy()[0, 0, 0]


def test_thermal_isothermal_blackbody_limit():
    """An optically thick isothermal absorber radiates B."""
    rad = _slab(skt.EmissionSource.DiscreteOrdinates,
                skt.MultipleScatterSource.DiscreteOrdinates, 4, 50.0 / 1000.0,
                1e-8, 2.5e-5, np.array([0.0, 1000.0]))
    np.testing.assert_allclose(rad, 2.5e-5, rtol=1e-6)


def test_emission_standard_vs_do():
    """Standard (along the ray) and DO emission agree to 1% for a
    non-scattering atmosphere seen at nadir (their layer models differ)."""
    alts = np.linspace(0, 10000, 11)
    ext = 1e-4 * np.exp(-alts / 3000.0)[:, None]
    b = 1e-5 * np.linspace(1.0, 0.5, 11)[:, None]
    r_do = _slab(skt.EmissionSource.DiscreteOrdinates,
                 skt.MultipleScatterSource.DiscreteOrdinates, 4, ext, 0.0, b,
                 alts, mu=1.0)
    r_std = _slab(skt.EmissionSource.Standard,
                  skt.MultipleScatterSource.NoSource, 4, ext, 0.0, b, alts,
                  mu=1.0)
    np.testing.assert_allclose(r_do, r_std, rtol=1e-2)


@pytest.mark.parametrize(("emission", "limb"), [
    ("DiscreteOrdinates", False), ("TwoStream", True),
])
def test_polarized_thermal_matches_jax(emission, limb):
    """Polarized DO and two-stream thermal emission, which the JAX package
    sends to its generic route (``_polarized_fast_ok``), in the thermal
    infrared (the sun off, US76, Rayleigh, the tabulated absorber,
    ``ThermalEmission``): the port's generic route matches its engine at
    1e-10, radiance and every ``wf_*``."""

    def case(pkg, ref_atmo=None):
        config = pkg.Config(
            num_streams=4, num_stokes=3,
            multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
            single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
            emission_source=getattr(pkg.EmissionSource, emission),
        )
        geometry = pkg.Geometry1D(
            cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
            altitude_grid_m=np.linspace(0.0, 100000.0, 6),
            geometry_type=pkg.GeometryType.Spherical,
        )
        viewing = pkg.ViewingGeometry()
        viewing.add_ray(
            pkg.TangentAltitudeSolar(20000.0, 0.0, 200000.0, 0.6) if limb
            else pkg.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
        if ref_atmo is not None:
            return config, geometry, viewing, torch_support.carry_atmosphere(
                ref_atmo, geometry, config)
        return config, geometry, viewing, _thermal_constituents(
            pkg, config, geometry, THERMAL_WL[:2])

    config, geometry, viewing, atmo = case(sk)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    assert not ref.extra["polarized_fast_ok"]
    config, geometry, viewing, atmo_t = case(skt, atmo)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo_t)
    assert not engine._polarized_fast_ok() and not engine._fast_route
    assert set(got.keys()) == set(ref.keys())
    assert "wf_thermal_temperature_k" in ref.keys()
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert a.dims == b.dims, key
        err = _rel_err(a.to_numpy(), b.to_numpy())
        assert err <= 1e-10, (key, err)
