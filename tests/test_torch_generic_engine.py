"""The port's engine routes like the JAX engine, and its generic
per-wavelength route matches its wavelength-minor fast paths, in float64
on the CPU:

* the route: ``Engine._twostream_fast_ok`` and ``_polarized_fast_ok``
  agree with the JAX engine's on every configuration of the engine-level
  tests (scalar and polarized, ground-viewing, limb and flux observers,
  Lambertian and BRDF surfaces, DO and two-stream thermal emission, no DO
  source);
* forcing the generic route (the gate replaced by ``lambda: False``, as
  the JAX package's own tests do) on a configuration the fast path takes
  gives the fast path's radiance, fluxes and every ``wf_*`` to 1e-10 of
  each variable's largest magnitude: the counterparts of
  ``tests/test_brdf.py:186`` (BRDF ground-viewing), ``test_flux.py:120``
  (fluxes), ``test_nstream.py:153`` (scalar ground-viewing) and
  ``test_nstream_vec.py:176`` (polarized ground-viewing), plus limb scans
  on a 2-point solar zenith grid, thermal emission with fluxes, and 6
  streams (odd orders 3 and 9 of the eigensolve, K = 6 and 18 of the
  block solve).

The generic route against the JAX package's own generic route is in
``tests/test_torch_engine.py``, ``test_torch_brdf.py`` and
``test_torch_thermal.py``; its solvers in ``tests/test_torch_generic.py``.
"""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


# name -> (num_stokes, nstr, viewing, surface, emission, multiple scatter)
CASES = {
    "ground": (1, 4, "ground", "lambertian", None, "DiscreteOrdinates"),
    "ground_twostream": (1, 2, "ground", "lambertian", None, "TwoStream"),
    "limb": (1, 4, "limb", "lambertian", None, "DiscreteOrdinates"),
    "flux": (1, 4, "flux", "lambertian", None, "DiscreteOrdinates"),
    "brdf_ground": (1, 4, "ground", "modis", None, "DiscreteOrdinates"),
    "brdf_limb": (1, 4, "limb", "modis", None, "DiscreteOrdinates"),
    "brdf_flux": (1, 4, "flux", "modis", None, "DiscreteOrdinates"),
    "brdf_no_do": (1, 4, "ground", "modis", None, "NoSource"),
    "thermal_flux": (1, 4, "flux", "lambertian", "DiscreteOrdinates",
                     "DiscreteOrdinates"),
    "ground_6": (1, 6, "ground", "lambertian", None, "DiscreteOrdinates"),
    "pol_ground": (3, 4, "ground", "lambertian", None, "DiscreteOrdinates"),
    "pol_limb": (3, 4, "limb", "lambertian", None, "DiscreteOrdinates"),
    "pol_flux": (3, 4, "flux", "lambertian", None, "DiscreteOrdinates"),
    "pol_brdf": (3, 4, "ground", "modis", None, "DiscreteOrdinates"),
    "pol_thermal_ground": (3, 4, "ground", "lambertian", "DiscreteOrdinates",
                           "DiscreteOrdinates"),
    "pol_thermal_limb": (3, 4, "limb", "lambertian", "TwoStream",
                         "DiscreteOrdinates"),
    "pol_ground_6": (3, 6, "ground", "lambertian", None, "DiscreteOrdinates"),
    "pol_no_do": (3, 4, "ground", "lambertian", None, "NoSource"),
}
ALTITUDES = np.linspace(0.0, 60000.0, 11)


def _case(pkg, name):
    num_stokes, nstr, view, surface, emission, ms = CASES[name]
    kw = {} if emission is None else {
        "emission_source": getattr(pkg.EmissionSource, emission)}
    no_do = ms == "NoSource"
    config = pkg.Config(
        num_streams=nstr, num_stokes=num_stokes,
        multiple_scatter_source=getattr(pkg.MultipleScatterSource, ms),
        single_scatter_source=(pkg.SingleScatterSource.Exact if no_do else
                               pkg.SingleScatterSource.DiscreteOrdinates),
        num_singlescatter_moments=max(nstr, 4),
        num_do_sza=2 if view == "limb" else 1, **kw,
    )
    limb = view == "limb"
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES,
        geometry_type=(pkg.GeometryType.Spherical if limb
                       else pkg.GeometryType.PseudoSpherical),
    )
    viewing = pkg.ViewingGeometry()
    if limb:
        viewing.add_ray(pkg.TangentAltitudeSolar(15000.0, 0.3, 2e5, 0.6))
        viewing.add_ray(pkg.TangentAltitudeSolar(35000.0, 1.0, 2e5, 0.6))
    else:
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.7, 0.85, 2e5))
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 1.9, 0.45, 2e5))
        viewing.add_ray(pkg.SolarAnglesObserverLocation(0.6, 1.2, -0.7, 2e5))
    if view == "flux":
        for alt in (0.0, 10000.0, 30000.0):
            viewing.add_flux_observer(pkg.FluxObserverSolar(0.6, alt))
    atmo = pkg.Atmosphere(geometry, config,
                          wavelengths_nm=np.array([350.0, 550.0]))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    if surface == "modis":
        atmo["surface"] = pkg.constituent.MODIS(0.25, 0.15, 0.05)
    else:
        atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    if emission is not None:
        atmo.storage.emission_source[:] = np.linspace(
            2e-3, 1e-3, len(ALTITUDES))[:, None]
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", list(CASES))
def test_routing_gates_match_jax(name):
    """Each engine's gates, with the surface of the call set as its
    ``calculate_radiance`` sets it (no JAX compile)."""
    config, geometry, viewing, atmo = _case(sk, name)
    ref = sk.Engine(config, geometry, viewing)
    ref._surface_brdf = atmo.surface.brdf
    config, geometry, viewing, atmo = _case(skt, name)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    engine._brdf = atmo.surface.brdf
    assert engine._twostream_fast_ok() == ref._twostream_fast_ok()
    assert engine._polarized_fast_ok() == ref._polarized_fast_ok()


FAST_CASES = [name for name in CASES
              if name in ("ground", "ground_twostream", "limb", "flux",
                          "brdf_ground", "thermal_flux", "ground_6",
                          "pol_ground", "pol_limb", "pol_ground_6")]


@pytest.mark.parametrize("name", FAST_CASES)
def test_generic_route_matches_fast_path(name):
    config, geometry, viewing, atmo = _case(skt, name)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    fast = engine.calculate_radiance(atmo)
    assert engine._fast_route
    gate = ("_polarized_fast_ok" if config.num_stokes == 3
            else "_twostream_fast_ok")
    setattr(engine, gate, lambda: False)
    generic = engine.calculate_radiance(atmo)
    assert not engine._fast_route
    assert set(fast.keys()) == set(generic.keys())
    assert any(k.startswith("wf_") for k in fast.keys())
    if CASES[name][2] == "flux":
        assert "upwelling_flux" in fast.keys()
    for key in fast.keys():
        err = _rel_err(generic[key].to_numpy(), fast[key].to_numpy())
        assert err <= 1e-10, (key, err)
