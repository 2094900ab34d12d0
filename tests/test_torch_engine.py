"""The port's ``Engine`` against ``sasktran2_tpu.Engine``, in float64 on
the CPU: each package builds its own config, geometry, viewing geometry
and atmosphere from the same numpy inputs, and radiance and every ``wf_*``
agree to 1e-10 relative to each variable's largest magnitude, at 4
streams, 20 altitudes and 3 wavelengths, in plane-parallel geometry
(constituent atmosphere, Legendre Jacobians on) and pseudo-spherical
geometry (raw input atmosphere carried over by
``params.atmosphere_from_reference``, two solar zenith groups).
The configurations the JAX package sends to its generic per-wavelength
route (polarized thermal emission, polarized radiance with flux
observers, a BRDF on a limb scan, polarized BRDF) take the port's generic
route too and match at 1e-10; so do successive orders, scalar and
polarized; EngineIntegratedLineShape runs; a viewing geometry
that is not the port's raises ``TypeError`` and a ray of the 2D geometry's
kind on a ``Geometry1D`` ``NotImplementedError``, as the JAX 1D tracer
cannot trace it either; an engine with no
device named needs a GPU. The JAX engine's side of each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_engine.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

WAVELENGTHS = np.array([310.0, 400.0, 550.0])
ALTITUDES = np.linspace(0.0, 100000.0, 20)


def _config(pkg, nstr=4, **kw):
    return pkg.Config(
        num_streams=nstr,
        multiple_scatter_source=kw.pop(
            "ms", pkg.MultipleScatterSource.DiscreteOrdinates
        ),
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
        **kw,
    )


def _geometry(pkg, geometry_type):
    return pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES,
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )


def _constituent_atmosphere(pkg, config, geometry, _ref=None):
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface([0.1, 0.3, 0.2])
    return atmo


def _raw_atmosphere(pkg, config, geometry, ref=None):
    if ref is not None:
        return torch_support.carry_atmosphere(ref, geometry, config)
    rng = np.random.default_rng(5)
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    z = ALTITUDES[:, None]
    atmo.storage.total_extinction[:] = (
        2e-5 * np.exp(-z / 8000.0) * rng.uniform(0.8, 1.2, size=(1, 3))
    )
    atmo.storage.ssa[:] = rng.uniform(0.8, 0.99, size=(len(ALTITUDES), 3))
    g = rng.uniform(0.0, 0.6, size=(len(ALTITUDES), 3))
    for ell in range(atmo.storage.leg_coeff.shape[0]):
        atmo.storage.leg_coeff[ell] = (2 * ell + 1) * g**ell
    atmo.surface.albedo[:] = [0.25, 0.3, 0.05]
    return atmo


# (geometry type, atmosphere builder, rays as (class name, arguments))
CASES = {
    "planeparallel_constituents": (
        "PlaneParallel", _constituent_atmosphere,
        [("GroundViewingSolar", (0.6, 0.5, mu, 200000.0)) for mu in (0.5, 0.9)],
    ),
    "pseudospherical_raw": (
        "PseudoSpherical", _raw_atmosphere,
        [
            ("GroundViewingSolar", (0.6, 0.5, 0.7, 200000.0)),
            ("SolarAnglesObserverLocation", (0.4, 1.1, -0.8, 200000.0)),
            ("GroundViewingSolar", (0.4, 2.0, 1.0, 200000.0)),
        ],
    ),
}


def _case(pkg, case, ref_atmo=None):
    geometry_type, make_atmo, rays = CASES[case]
    config = _config(pkg)
    geometry = _geometry(pkg, geometry_type)
    viewing = pkg.ViewingGeometry()
    for cls, args in rays:
        viewing.add_ray(getattr(pkg, cls)(*args))
    return config, geometry, viewing, make_atmo(pkg, config, geometry, ref_atmo)


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(case):
    config, geometry, viewing, atmo = _case(sk, case)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    config, geometry, viewing, atmo_t = _case(skt, case, ref_atmo=atmo)
    got = skt.Engine(config, geometry, viewing, device="cpu")\
        .calculate_radiance(atmo_t)
    assert set(got.keys()) == set(ref.keys())
    assert len([k for k in ref.keys() if k.startswith("wf_")]) >= 3
    for name in ref.keys():
        a, b = got[name], ref[name]
        assert a.dims == b.dims, name
        a, b = a.to_numpy(), b.to_numpy()
        assert a.shape == b.shape, name
        err = np.max(np.abs(a - b)) / np.max(np.abs(b))
        assert err <= 1e-10, (name, err)
    np.testing.assert_array_equal(
        got.coords["wavelength"], ref.coords["wavelength"]
    )


def _limb_viewing():
    viewing = skt.ViewingGeometry()
    viewing.add_ray(skt.TangentAltitudeSolar(
        tangent_altitude_m=20000.0, relative_azimuth=0.0,
        observer_altitude_m=200000.0, cos_sza=0.6,
    ))
    return viewing


def _ground_viewing(flux=False):
    viewing = skt.ViewingGeometry()
    viewing.add_ray(skt.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    if flux:
        viewing.add_flux_observer(skt.FluxObserverSolar(0.6, 10000.0))
    return viewing


class _RayList:
    """A viewing geometry that is not the port's ``ViewingGeometry``."""

    def __init__(self, rays):
        self.observer_rays = rays


class _TangentAltitude:
    """A ray of the 2D geometry's kind (``sasktran2_tpu.TangentAltitude``),
    which a ``Geometry1D`` does not trace."""

    tangent_altitude_m = 20000.0
    observer_altitude_m = 200000.0


def _viewing_with(ray):
    viewing = skt.ViewingGeometry()
    viewing.add_ray(ray)
    return viewing


@pytest.mark.parametrize(("config", "viewing", "error", "match"), [
    (lambda: _config(skt),
     lambda: _RayList(_ground_viewing().observer_rays), TypeError,
     "sasktran2_tpu_torch.ViewingGeometry.*_RayList"),
    (lambda: _config(skt), lambda: _viewing_with(_TangentAltitude()),
     NotImplementedError, "_TangentAltitude.*Geometry1D.*Geometry2D"),
])
def test_out_of_slice_raises(config, viewing, error, match):
    geometry = _geometry(skt, "PlaneParallel")
    with pytest.raises(error, match=match):
        skt.Engine(config(), geometry, viewing(), device="cpu")


def test_engine_integrated_line_shape_is_ported():
    """EngineIntegratedLineShape, refused before the optical slice, now
    runs: the outputs come back on the output basis
    (``tests/test_torch_spectral_grid.py`` holds them to the JAX
    engine)."""
    config = _config(skt, spectral_grid_mode=(
        skt.SpectralGridMode.EngineIntegratedLineShape))
    geometry = _geometry(skt, "PlaneParallel")
    engine = skt.Engine(config, geometry, _ground_viewing(), device="cpu")
    fine = np.linspace(399.0, 401.0, 21)
    grid = skt.basis.Grid.from_triangles([399.8, 400.2], 0.3)
    atmo = skt.Atmosphere(geometry, config, wavelengths_nm=fine,
                          spectral_grid=grid)
    skt.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = skt.constituent.Rayleigh()
    atmo["surface"] = skt.constituent.LambertianSurface(0.3)
    out = engine.calculate_radiance(atmo)
    assert out["radiance"].to_numpy().shape == (2, 1, 1)
    np.testing.assert_array_equal(out.coords["wavelength"], [399.8, 400.2])


def so_engine_case(pkg, num_stokes):
    """(config, geometry, viewing, atmosphere) of the successive-orders
    engines this file once held to a refusal: the reference's SO defaults
    (110 incoming directions, 50 iterations) at 4 streams, plane-parallel
    on 20 altitudes, one ground-viewing ray, the constituent atmosphere."""
    config = _config(pkg, num_stokes=num_stokes,
                     ms=pkg.MultipleScatterSource.SuccessiveOrders)
    geometry = _geometry(pkg, "PlaneParallel")
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    return (config, geometry, viewing,
            _constituent_atmosphere(pkg, config, geometry))


@pytest.mark.parametrize("num_stokes", [1, 3])
def test_successive_orders_matches_jax(num_stokes):
    """Successive orders, scalar and polarized, at the reference's SO
    defaults: the generic route, as in the JAX engine, to 1e-10."""
    case = so_engine_case(sk, num_stokes)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    config, geometry, viewing, atmo = so_engine_case(skt, num_stokes)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    assert not engine._fast_route
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    assert engine._polarized_fast_ok() == ref.extra["polarized_fast_ok"]
    torch_support.assert_outputs_match(got, ref)
    assert any(k.startswith("wf_") for k in ref.keys())


def _assert_matches_jax(engine, got, ref):
    """Every output of the port's engine call against the JAX engine's to
    1e-10 of its largest magnitude, and the same route."""
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    assert engine._polarized_fast_ok() == ref.extra["polarized_fast_ok"]
    assert set(got.keys()) == set(ref.keys())
    for name in ref.keys():
        a, b = got[name], ref[name]
        assert a.dims == b.dims, name
        a, b = a.to_numpy(), b.to_numpy()
        scale = np.max(np.abs(b))
        err = np.max(np.abs(a - b)) / (scale if scale > 0 else 1.0)
        assert err <= 1e-10, (name, err)


GENERIC_ALTITUDES = np.linspace(0.0, 100000.0, 6)


def _generic_case(pkg, num_stokes, emission, viewing, surface, ref=None):
    """(config, geometry, viewing, atmosphere) of one configuration the
    JAX package sends to its generic route: the US76 Rayleigh atmosphere
    on 6 altitudes at 500 nm, plane-parallel for ground-viewing rays and
    spherical for a limb ray, with a level emission profile under thermal
    emission (6 altitudes keep the JAX compile of its generic route near
    20 s)."""
    kw = {} if emission is None else {
        "emission_source": getattr(pkg.EmissionSource, emission)}
    config = _config(pkg, num_stokes=num_stokes, **kw)
    limb = viewing == "limb"
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=GENERIC_ALTITUDES,
        geometry_type=getattr(
            pkg.GeometryType, "Spherical" if limb else "PlaneParallel"),
    )
    rays = pkg.ViewingGeometry()
    if limb:
        rays.add_ray(pkg.TangentAltitudeSolar(20000.0, 0.0, 200000.0, 0.6))
    else:
        rays.add_ray(pkg.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    if viewing == "flux":
        rays.add_flux_observer(pkg.FluxObserverSolar(0.6, 10000.0))
    if ref is not None:
        return config, geometry, rays, torch_support.carry_atmosphere(
            ref, geometry, config)
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=np.array([500.0]))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    if surface == "modis":
        atmo["surface"] = pkg.constituent.MODIS(0.25, 0.15, 0.05)
    else:
        atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    if emission is not None:
        atmo.storage.emission_source[:] = np.linspace(
            2e-3, 1e-3, len(GENERIC_ALTITUDES))[:, None]
    return config, geometry, rays, atmo


def _run_generic(*case):
    ref_case = _generic_case(sk, *case)

    def jax_side():
        engine = sk.Engine(*ref_case[:3])
        return engine, engine.calculate_radiance(ref_case[3])

    ref = torch_support.jax_engine_reference(jax_side, ref_case)
    config, geometry, viewing, atmo = _generic_case(skt, *case,
                                                    ref=ref_case[3])
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    _assert_matches_jax(engine, got, ref)
    assert not engine._fast_route
    return got


@pytest.mark.parametrize(("num_stokes", "emission", "viewing"), [
    (3, "DiscreteOrdinates", "ground"),
    (3, None, "flux"),
    (3, "TwoStream", "limb"),
])
def test_generic_route_matches_jax(num_stokes, emission, viewing):
    """Polarized DO thermal emission (ground-viewing), polarized radiance
    with flux observers and polarized two-stream thermal emission (limb):
    the JAX package's generic route, which the port takes too."""
    got = _run_generic(num_stokes, emission, viewing, "lambertian")
    if viewing == "flux":
        assert "upwelling_flux" in got


@pytest.mark.parametrize("num_stokes", [1, 3])
def test_brdf_surface_matches_jax(num_stokes):
    """A BRDF surface where the JAX package takes its generic route (a
    scalar limb scan, polarized radiance): the limb solves see the core
    albedo, 0 under MODIS; polarized ground-viewing rays see the BRDF."""
    viewing = "limb" if num_stokes == 1 else "ground"
    got = _run_generic(num_stokes, None, viewing, "modis")
    assert any(k.startswith("wf_surface") for k in got.keys())


@pytest.mark.parametrize("foreign", ["geometry", "viewing", "atmosphere"])
def test_reference_objects_refused(foreign):
    """The port takes its own classes only; a JAX-side object raises
    instead of being read by duck typing."""
    ref = _case(sk, "pseudospherical_raw")
    config, geometry, viewing, _ = _case(skt, "pseudospherical_raw",
                                         ref_atmo=ref[3])
    if foreign == "geometry":
        with pytest.raises(TypeError, match="Geometry1D"):
            skt.Engine(config, ref[1], viewing, device="cpu")
    elif foreign == "viewing":
        with pytest.raises(TypeError, match="ViewingGeometry"):
            skt.Engine(config, geometry, ref[2], device="cpu")
    else:
        engine = skt.Engine(config, geometry, viewing, device="cpu")
        with pytest.raises(TypeError, match="atmosphere_from_reference"):
            engine.calculate_radiance(ref[3])


def test_layer_optical_gradients_in_float32():
    """The layer omega and beta are level means weighted by extinction and
    scattering. Their gradients with respect to the level extinction, in
    float32 down to the 1e-11 /m of the top of the atmosphere, agree with
    float64 to 1e-4 of their largest magnitude, and vanish exactly where
    ssa and the phase expansion do not vary with altitude (a Rayleigh
    atmosphere)."""
    engine = skt.Engine(_config(skt), _geometry(skt, "PlaneParallel"),
                        _ground_viewing(), device="cpu")
    rng = np.random.default_rng(3)
    A = len(ALTITUDES)
    ext = 1e-5 * np.exp(-ALTITUDES / 7000.0)[None] * rng.uniform(
        0.9, 1.1, size=(2, A))
    leg = np.broadcast_to(np.array([1.0, 0.0, 0.5, 0.0]), (2, A, 4))
    for ssa, exact_zero in ((np.ones((2, A)), True),
                            (rng.uniform(0.5, 1.0, size=(2, A)), False)):
        grads = {}
        for dt in (torch.float32, torch.float64):
            k = torch.tensor(ext, dtype=dt, requires_grad=True)
            _, omega, beta = engine._layer_optical(
                k, torch.tensor(ssa, dtype=dt), torch.tensor(leg, dtype=dt))
            ct = np.random.default_rng(4).normal(size=omega.shape)
            cb = np.random.default_rng(5).normal(size=beta.shape)
            loss = (omega * torch.tensor(ct, dtype=dt)).sum() + (
                beta * torch.tensor(cb, dtype=dt)).sum()
            grads[dt] = torch.autograd.grad(loss, k)[0].double().numpy()
        g32, g64 = grads[torch.float32], grads[torch.float64]
        if exact_zero:
            assert np.all(g32 == 0.0) and np.all(g64 == 0.0)
        else:
            assert np.max(np.abs(g32 - g64)) <= 1e-4 * np.max(np.abs(g64))
