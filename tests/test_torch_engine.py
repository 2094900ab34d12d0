"""The port's ``Engine`` against ``sasktran2_tpu.Engine``, in float64 on
the CPU: each package builds its own config, geometry, viewing geometry
and atmosphere from the same numpy inputs, and radiance and every ``wf_*``
agree to 1e-10 relative to each variable's largest magnitude, at 4
streams, 20 altitudes and 3 wavelengths, in plane-parallel geometry
(constituent atmosphere, Legendre Jacobians on) and pseudo-spherical
geometry (raw input atmosphere carried over by
``params.atmosphere_from_reference``, two solar zenith groups).
Configurations outside the ported slices (successive orders, polarized
thermal emission, polarized radiance with flux observers, BRDF limb scans
and polarized BRDF) raise ``NotImplementedError``; an engine with no
device named needs a GPU."""

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch.params import atmosphere_from_reference

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
        return atmosphere_from_reference(ref, geometry, config)
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
    ref = sk.Engine(config, geometry, viewing).calculate_radiance(atmo)
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


@pytest.mark.parametrize(("config", "viewing", "match"), [
    (lambda: _config(skt, ms=skt.MultipleScatterSource.SuccessiveOrders),
     _ground_viewing, "successive orders"),
    (lambda: _config(skt, num_stokes=3,
                     emission_source=skt.EmissionSource.DiscreteOrdinates),
     _ground_viewing, "thermal emission"),
    (lambda: _config(skt, num_stokes=3), lambda: _ground_viewing(flux=True),
     "polarized radiance with flux observers.*slice 9"),
    (lambda: _config(skt, num_stokes=3,
                     emission_source=skt.EmissionSource.TwoStream),
     _limb_viewing, "thermal emission.*slice 4"),
    (lambda: _config(skt, num_stokes=3,
                     ms=skt.MultipleScatterSource.SuccessiveOrders),
     _ground_viewing, "successive orders.*slice 10"),
])
def test_out_of_slice_raises(config, viewing, match):
    geometry = _geometry(skt, "PlaneParallel")
    with pytest.raises(NotImplementedError, match=match):
        skt.Engine(config(), geometry, viewing(), device="cpu")


@pytest.mark.parametrize("num_stokes", [1, 3])
def test_brdf_surface_raises(num_stokes):
    """A BRDF surface where the JAX package takes its generic route (a
    scalar limb scan, polarized radiance) is refused at the call, naming
    its slice, instead of being treated as Lambertian."""
    config = _config(skt, num_stokes=num_stokes)
    geometry = _geometry(skt, "Spherical")
    atmo = skt.Atmosphere(geometry, config, wavelengths_nm=np.array([500.0]))
    skt.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = skt.constituent.Rayleigh()
    atmo["surface"] = skt.constituent.MODIS(0.25, 0.15, 0.05)
    viewing = _limb_viewing() if num_stokes == 1 else _ground_viewing()
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    with pytest.raises(NotImplementedError, match="BRDF.*slice 9"):
        engine.calculate_radiance(atmo)


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
        with pytest.raises(NotImplementedError, match="ViewingGeometry"):
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
