"""The port's geodetic and viewing-geometry containers against the JAX
package's: ``Geodetic``, ``ecef_to_sasktran2_ray`` (limb and ground),
``LimbVertical`` and the solar-angle handlers, bit-equal or within 1e-12;
the JAX test's engine case on a ``LimbVertical`` container
(``tests/test_viewinggeo_containers.py:49-87``) at 1e-10 in float64, with
the container's metadata merged into the output; and the ellipsoidal
geometry's osculating-sphere radius at a reference latitude. The JAX side
of each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_viewinggeo_containers.npz``
(``tests/torch_support.py``)."""

import dataclasses

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

TANGENTS = np.arange(10000.0, 45001.0, 5000.0)
# (latitude, longitude, altitude) of the geodetic cases
POINTS = [(0.0, 0.0, 0.0), (20.0, 40.0, 25000.0), (-63.5, 171.0, 600000.0),
          (89.0, -120.0, 80000.0)]


def _geodetic(pkg, lat, lon, alt):
    """Every quantity of a Geodetic built from (lat, lon, alt): its
    location and local frame, the osculating spheroid, the round trip
    through ``from_xyz``, the tangent point of a look vector from 600 km
    above it, the point of a 25 km tangent altitude along a boresight,
    and the intercepts of a 50 km shell."""
    g = pkg.Geodetic().from_lat_lon_alt(lat, lon, alt)
    radius, offset = g.osculating_spheroid()
    out = {
        "location": g.location, "up": g.local_up, "south": g.local_south,
        "west": g.local_west,
        "osculating": np.concatenate([[radius], offset]),
    }
    back = pkg.Geodetic()
    back.from_xyz(g.location)
    out["from_xyz"] = np.array([back.latitude, back.longitude, back.altitude])
    obs = pkg.Geodetic().from_lat_lon_alt(lat, lon, 600000.0)
    look = -obs.local_up * 0.4 + obs.local_south * 0.92
    t = pkg.Geodetic()
    t.from_tangent_point(obs.location, look)
    out["tangent_point"] = np.array([t.latitude, t.longitude, t.altitude])
    ta = pkg.Geodetic()
    loc = ta.from_tangent_altitude(25000.0, obs.location,
                                   obs.local_south - 0.1 * obs.local_up)
    out["tangent_altitude_look"] = np.asarray(loc)
    out["tangent_altitude_point"] = np.array(
        [ta.latitude, ta.longitude, ta.altitude])
    ent, ex = pkg.Geodetic().altitude_intercepts(
        50000.0, obs.location, look)
    out["intercepts"] = np.concatenate([ent, ex])
    return out


@pytest.mark.parametrize("point", range(len(POINTS)))
def test_geodetic_matches_jax(point):
    lat, lon, alt = POINTS[point]
    ref = torch_support.jax_reference(
        lambda: _geodetic(sk, lat, lon, alt), POINTS[point])
    got = _geodetic(skt, lat, lon, alt)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=1e-6,
                                   err_msg=k)


def _ray_fields(ray):
    return {"type": np.array(type(ray).__name__),
            **{f.name: np.array(getattr(ray, f.name))
               for f in dataclasses.fields(ray)}}


def _ecef_rays(pkg):
    """The limb and the ground ray of the JAX tests
    (``tests/test_viewinggeo_containers.py:23-46``)."""
    handler = pkg.solar.SolarGeometryHandlerForced
    geo = pkg.Geodetic()
    obs = geo.from_lat_lon_alt(0.0, 0.0, 600000.0).location
    look = geo.from_tangent_altitude(25000.0, obs,
                                     np.array([0.0, 1.0, 0.1]))
    limb = pkg.viewinggeo.ecef_to_sasktran2_ray(
        obs, look, None, solar_handler=handler(60.0, 0.0))
    nadir = -geo.local_up
    ground = pkg.viewinggeo.ecef_to_sasktran2_ray(
        obs, nadir, None, solar_handler=handler(45.0, 90.0))
    return {"limb": _ray_fields(limb), "ground": _ray_fields(ground)}


def test_ecef_rays_match_jax():
    ref = torch_support.jax_reference(lambda: _ecef_rays(sk), ())
    got = _ecef_rays(skt)
    assert str(got["limb"]["type"]) == "TangentAltitudeSolar"
    assert str(got["ground"]["type"]) == "GroundViewingSolar"
    for ray in ("limb", "ground"):
        assert set(got[ray]) == set(ref[ray])
        for k, v in ref[ray].items():
            if k == "type":
                assert str(got[ray][k]) == str(v)
            else:
                np.testing.assert_allclose(got[ray][k], v, rtol=1e-12,
                                           atol=1e-12, err_msg=(ray, k))


def _limb_vertical(pkg):
    return pkg.viewinggeo.LimbVertical.from_tangent_parameters(
        pkg.solar.SolarGeometryHandlerForced(60.0, 30.0), TANGENTS,
        tangent_latitude=20.0, tangent_longitude=40.0, time=None,
        observer_altitude=500000.0, viewing_azimuth=90.0,
        reference_altitude=25000.0,
    )


def _container_tree(c):
    return {
        "rays": [_ray_fields(r) for r in c.observer_rays],
        "metadata": {k: c.geometry_ds[k].to_numpy()
                     for k in c.geometry_ds.keys()},
        "cos_sza": np.array(c.recommended_cos_sza()),
        "earth_radius": np.array(c.recommended_earth_radius()),
    }


def test_limb_vertical_matches_jax():
    ref = torch_support.jax_reference(
        lambda: _container_tree(_limb_vertical(sk)), TANGENTS)
    c = _limb_vertical(skt)
    assert isinstance(c, skt.ViewingGeometry)
    assert isinstance(c, skt.ViewingGeometryContainer)
    got = _container_tree(c)
    assert len(got["rays"]) == len(ref["rays"]) == len(TANGENTS)
    for a, b in zip(got["rays"], ref["rays"]):
        for k, v in b.items():
            if k == "type":
                assert str(a[k]) == str(v)
            else:
                np.testing.assert_allclose(a[k], v, rtol=1e-12, atol=1e-9,
                                           err_msg=k)
    assert set(got["metadata"]) == set(ref["metadata"])
    for k, v in ref["metadata"].items():
        np.testing.assert_allclose(got["metadata"][k], v, rtol=1e-12,
                                   atol=1e-9, err_msg=k)
    for k in ("cos_sza", "earth_radius"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)
    geometry = c.model_geometry(np.arange(0, 65001, 5000.0))
    assert isinstance(geometry, skt.Geometry1D)
    assert geometry.geometry_type == skt.GeometryType.Spherical


def _engine_case(pkg, ms):
    """The JAX test's engine case on a LimbVertical container
    (``tests/test_viewinggeo_containers.py:49-87``: exact single scatter
    only, ``ms="none"``), and the same scan with 4-stream DO multiple
    scatter on a 2-point solar-zenith grid (``ms="do"``)."""
    container = _limb_vertical(pkg)
    geometry = container.model_geometry(np.arange(0, 65001, 5000.0))
    if ms == "do":
        kw = {"num_streams": 4, "num_do_sza": 2,
              "multiple_scatter_source":
                  pkg.MultipleScatterSource.DiscreteOrdinates}
    else:
        kw = {"num_streams": 2,
              "multiple_scatter_source": pkg.MultipleScatterSource.NoSource}
    config = pkg.Config(
        single_scatter_source=pkg.SingleScatterSource.Exact,
        num_singlescatter_moments=4, **kw,
    )
    atmosphere = pkg.Atmosphere(geometry, config,
                                wavelengths_nm=np.array([450.0]))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmosphere)
    atmosphere["rayleigh"] = pkg.constituent.Rayleigh()
    if ms == "do":
        atmosphere["surface"] = pkg.constituent.LambertianSurface(0.3)
    return config, geometry, container, atmosphere


@pytest.mark.parametrize("ms", ["none", "do"])
def test_limb_vertical_engine_matches_jax(ms):
    case = _engine_case(sk, ms)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    config, geometry, container, atmo = _engine_case(skt, ms)
    got = skt.Engine(config, geometry, container,
                     device="cpu").calculate_radiance(atmo)
    torch_support.assert_outputs_match(got, ref)
    # the container's per-ray metadata, merged as the JAX engine merges it
    for k in container.geometry_ds.keys():
        assert k in got.keys()
    np.testing.assert_allclose(got["tangent_altitude"].to_numpy(), TANGENTS,
                               atol=1.0)
    assert np.all(got["radiance"].to_numpy() > 0)


@pytest.mark.parametrize("latitude", [0.0, 45.0, -70.0])
def test_ellipsoidal_reference_latitude_radius(latitude):
    """``GeometryType.Ellipsoidal`` with a reference latitude traces on
    the WGS84 osculating sphere there, as the JAX package does."""

    def build(pkg):
        return pkg.Geometry1D(
            0.6, 0.0, 6372000.0, np.linspace(0.0, 100000.0, 11),
            geometry_type=pkg.GeometryType.Ellipsoidal,
            reference_latitude_deg=latitude, reference_longitude_deg=10.0,
        ).earth_radius_m

    ref = torch_support.jax_reference(lambda: np.array(build(sk)), latitude)
    got = build(skt)
    assert got == float(ref)
    assert got != 6372000.0


def test_ephemeris_handler_matches_jax():
    """The analytic ephemeris (``to_mjd`` imports pandas inside the
    function) at the JAX test's equinox noon and at two other times."""
    import pandas as pd

    times = ["2024-03-20 12:07:00", "2019-07-01 03:30:00",
             "2031-12-24 18:00:00"]
    where = [(0.0, 0.0), (52.1, -106.6), (-33.9, 151.2)]

    def angles(pkg):
        handler = pkg.solar.SolarGeometryHandlerEphemeris()
        return np.array([
            handler.target_solar_angles(lat, lon, 0.0, pd.Timestamp(t))
            for t, (lat, lon) in zip(times, where)
        ])

    ref = torch_support.jax_reference(lambda: angles(sk), (times, where))
    got = angles(skt)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-10)
    assert got[0, 0] < 1.0   # the sun nearly overhead at the equator
    assert skt.solar.to_mjd(51544.5) == 51544.5
