"""The port's polarized (I, Q, U) engine against the JAX package, in
float64 on the CPU, at 4 streams, 11 or 12 altitudes and 2 or 3
wavelengths: radiance and every ``wf_*`` to 1e-10 of each variable's
largest magnitude, Q and U included (so a component near zero is held to
the scale of the largest one, not to itself).

Cases (the scenarios of ``tests/test_polarized_engine.py``,
``tests/test_polarized_limb.py``, ``tests/test_stokes_basis.py`` and
``tests/test_nstream_vec.py``'s engine tests, cut as stated):

* ground-viewing rays through the wavelength-minor vector solver, DO
  single and multiple scatter, plane-parallel, standard and solar Stokes
  bases, with an upward- and a downward-looking
  ``SolarAnglesObserverLocation`` ray;
* the limb scan: exact polarized single scatter and the vector DO source
  along the rays on a 2-point SZA grid, spherical, observer basis;
* a raw atmosphere with nonzero a2, a3 and b1, a background absorber,
  Standard emission and log-radiance weighting functions, limb and ground
  rays with DO single scatter on a 1-point SZA grid;
* exact single scatter with occultation and no multiple scatter (no
  solver), solar basis.

The JAX side of every case is read from
``sasktran2_tpu_torch/data/golden_test_torch_polarized_engine.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

WAVELENGTHS = np.array([350.0, 450.0, 600.0])


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def _rayleigh(pkg, config, geometry, wavelengths):
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wavelengths)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    return atmo


def _raw(pkg, config, geometry, wavelengths):
    """Raw-input polarized atmosphere: an absorbing Rayleigh-like mixture
    with a Henyey-Greenstein tail in a1 and nonzero a2, a3, b1, an emission
    profile, and log-radiance weighting functions."""
    rng = np.random.default_rng(17)
    W = len(wavelengths)
    alts = geometry.altitudes()
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wavelengths)
    z = alts[:, None]
    atmo.storage.total_extinction[:] = (
        3e-5 * np.exp(-z / 7000.0) * rng.uniform(0.8, 1.2, size=(1, W))
    )
    atmo.storage.ssa[:] = rng.uniform(0.85, 0.99, size=(len(alts), W))
    g = rng.uniform(0.1, 0.4, size=(len(alts), W))
    lc = atmo.leg_coeff
    for ell in range(lc.a1.shape[0]):
        lc.a1[ell] = (2 * ell + 1) * g**ell
        if ell >= 2:
            lc.a2[ell] = 0.7 * lc.a1[ell]
            lc.a3[ell] = 0.5 * lc.a1[ell]
            lc.b1[ell] = 0.3 * lc.a1[ell]
    atmo.storage.emission_source[:] = rng.uniform(
        0.5, 2.0, size=(len(alts), W)) * 1e-3
    atmo.surface.albedo[:] = rng.uniform(0.1, 0.4, size=W)
    atmo.surface.emission[:] = rng.uniform(0.5, 1.5, size=W) * 1e-3
    for m in atmo.storage.derivative_mappings.values():
        m.log_radiance_space = True
    return atmo


GROUND = [("GroundViewingSolar", (0.6, 0.3, 0.8, 2e5)),
          ("GroundViewingSolar", (0.6, 1.1, 0.5, 2e5))]
OBSERVER = [("SolarAnglesObserverLocation", (0.6, 0.7, 0.6, 10000.0)),
            ("SolarAnglesObserverLocation", (0.6, 2.0, -0.7, 30000.0))]
LIMB = [("TangentAltitudeSolar", (t, 0.4, 2e5, 0.6))
        for t in (15000.0, 30000.0)]

# name -> (config keywords, altitudes, geometry type, rays, atmosphere,
#          wavelengths)
CASES = {
    "ground_do_standard": (
        {}, np.linspace(0.0, 60000.0, 11), "PlaneParallel", GROUND,
        _rayleigh, WAVELENGTHS),
    "ground_observer_rays_solar_basis": (
        {"stokes_basis": "Solar"}, np.linspace(0.0, 60000.0, 11),
        "PlaneParallel", GROUND[:1] + OBSERVER, _rayleigh, WAVELENGTHS[:2]),
    "limb_exact_ss_sza2_observer_basis": (
        {"ss": "Exact", "num_do_sza": 2, "stokes_basis": "Observer"},
        np.linspace(0.0, 60000.0, 12), "Spherical",
        LIMB + GROUND[1:], _rayleigh, WAVELENGTHS[:2]),
    "limb_raw_greeks_emission_log_wf": (
        {"emission_source": "Standard"}, np.linspace(0.0, 60000.0, 12),
        "Spherical", LIMB[:1] + GROUND[:1], _raw, WAVELENGTHS),
    "exact_ss_occultation_no_ms": (
        {"ss": "Exact", "ms": "NoSource", "occultation_source": "Standard",
         "stokes_basis": "Solar"},
        np.linspace(0.0, 60000.0, 12), "Spherical", LIMB + GROUND[:1],
        _rayleigh, WAVELENGTHS),
}


def _engine_case(pkg, name, ref_atmo=None):
    kw, alts, gtype, rays, make_atmo, wavelengths = CASES[name]
    kw = dict(kw)
    enums = {
        "ss": ("single_scatter_source", "SingleScatterSource"),
        "ms": ("multiple_scatter_source", "MultipleScatterSource"),
        "emission_source": ("emission_source", "EmissionSource"),
        "occultation_source": ("occultation_source", "OccultationSource"),
        "stokes_basis": ("stokes_basis", "StokesBasis"),
    }
    args = {
        "num_streams": 4, "num_stokes": 3, "num_singlescatter_moments": 4,
        "single_scatter_source": pkg.SingleScatterSource.DiscreteOrdinates,
        "multiple_scatter_source":
            pkg.MultipleScatterSource.DiscreteOrdinates,
    }
    for key, value in kw.items():
        if key in enums:
            field, enum = enums[key]
            args[field] = getattr(getattr(pkg, enum), value)
        else:
            args[key] = value
    config = pkg.Config(**args)
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=alts, geometry_type=getattr(pkg.GeometryType, gtype),
    )
    viewing = pkg.ViewingGeometry()
    for cls, ray_args in rays:
        viewing.add_ray(getattr(pkg, cls)(*ray_args))
    if ref_atmo is not None:
        atmo = torch_support.carry_atmosphere(ref_atmo, geometry, config)
    else:
        atmo = make_atmo(pkg, config, geometry, wavelengths)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", list(CASES))
def test_polarized_engine_matches_jax(name):
    config, geometry, viewing, atmo = _engine_case(sk, name)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    if config.multiple_scatter_source != sk.MultipleScatterSource.NoSource:
        assert ref.extra["polarized_fast_ok"]
    config, geometry, viewing, atmo_t = _engine_case(skt, name, atmo)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo_t)
    assert set(got.keys()) == set(ref.keys())
    assert list(got.coords["stokes"]) == ["I", "Q", "U"]
    wf_names = [k for k in ref.keys() if k.startswith("wf_")]
    assert wf_names
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert tuple(a.dims) == tuple(b.dims), key
        a, b = a.to_numpy(), b.to_numpy()
        assert a.shape == b.shape, key
        assert np.all(np.isfinite(a)), key
        if "stokes" in got[key].dims:
            ax = got[key].dims.index("stokes")
            for c in range(3):
                ac, bc = np.take(a, c, axis=ax), np.take(b, c, axis=ax)
                assert _rel_err(ac, bc) <= 1e-10, (key, c, _rel_err(ac, bc))
        else:
            assert _rel_err(a, b) <= 1e-10, (key, _rel_err(a, b))
    rad = got["radiance"].to_numpy()
    # a genuinely polarized result, not zeros
    assert np.max(np.abs(rad[..., 1])) > 1e-3 * np.max(rad[..., 0])
