"""The port's scatterer constituents at engine level against the JAX
package's, in float64 on the CPU: radiance and every ``wf_*`` to 1e-10 of
each variable's largest magnitude but the aerosol's own weighting
functions, at 4 streams, 8 altitudes (0-35 km), 3 wavelengths,
plane-parallel, two ground-viewing rays, over US76 + Rayleigh +
Lambertian 0.3 with one aerosol:

* ``NumberDensityScatterer`` with ``HGScatteringOptical`` (wf in number
  density on the aerosol's own altitude grid, with its phase-expansion
  chain);
* ``GaussianHeightExtinction`` (height, width and optical-depth WFs);
* ``ExtinctionScatterer`` on an ``OpticalDatabaseGenericScatterer`` with a
  median-radius axis interpolated per altitude (``param_values``);
* ``NumberDensityScatterer`` with ``MieScatteringOptical``, whose Mie runs
  on the port's device (here the CPU); its refractive index is
  1.45 + 0.002i, absorbing in the sign convention of the Mie formulas
  (xi = psi - i chi), which both packages share.

The aerosol's own weighting functions (``wf_aerosol*``) are held level by
level (along their first axis) to 1e-10 of the variable's largest
magnitude, or, at a level where the JAX package's own two routes (its
fast path against its generic route, forced; a second reference of each
case) differ by more than that, to their difference there; and to 1e-8
on the whole. Up the column, where the total extinction falls, the
extinction and ssa terms of the chain cancel, and the two JAX routes
differ there by more than 1e-10.

Each package builds its own atmosphere from the same numpy inputs. The
2D scatterers refuse a 1D atmosphere and a field of another shape than
the 2D geometry's, as the JAX package's do
(``tests/test_torch_constituents2d.py`` holds them on a 2D one).
The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_scatterer.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

ALTITUDES = np.linspace(0.0, 35000.0, 8)
WAVELENGTHS = np.array([450.0, 600.0, 750.0])
AEROSOL_ALTITUDES = np.linspace(0.0, 35000.0, 6)


def _scatterer_db():
    """A small scatterer table over (median_radius, wavelength)."""
    rng = np.random.default_rng(31)
    lm = rng.uniform(0.05, 0.6, size=(12, 3, 4))
    lm[0] = 1.0
    lm[1] = rng.uniform(1.5, 2.0, size=(3, 4))
    return {
        "coords": {"wavelength_nm": np.array([400.0, 550.0, 700.0, 800.0]),
                   "median_radius": np.array([0.08, 0.15, 0.3])},
        "data_vars": {
            "xs_total": (("median_radius", "wavelength_nm"),
                         rng.uniform(1e-14, 3e-14, size=(3, 4))),
            "xs_scattering": (("median_radius", "wavelength_nm"),
                              rng.uniform(0.8e-14, 0.95e-14, size=(3, 4))),
            "lm_a1": (("legendre", "median_radius", "wavelength_nm"), lm),
        },
    }


def _aerosol(pkg, kind, device_kw):
    # an aerosol optical depth of about 0.1 at the surface scale height
    nd = 1e8 * np.exp(-AEROSOL_ALTITUDES / 3000.0)
    if kind == "numden_hg":
        return pkg.constituent.NumberDensityScatterer(
            pkg.constituent.HGScatteringOptical(1e-13, 0.95, 0.7, nleg=16),
            AEROSOL_ALTITUDES, nd)
    if kind == "gaussian_height":
        return pkg.constituent.GaussianHeightExtinction(
            pkg.constituent.HGScatteringOptical(1e-13, 0.9, 0.65, nleg=16),
            12000.0, 4000.0, 0.05, 600.0, AEROSOL_ALTITUDES)
    if kind == "extinction_db":
        return pkg.constituent.ExtinctionScatterer(
            pkg.optical.OpticalDatabaseGenericScatterer(db=_scatterer_db()),
            AEROSOL_ALTITUDES, 1e-5 * np.exp(-AEROSOL_ALTITUDES / 2000.0),
            600.0,
            param_values={"median_radius": np.linspace(0.1, 0.25, 6)})
    if kind == "numden_mie":
        return pkg.constituent.NumberDensityScatterer(
            pkg.constituent.MieScatteringOptical(
                1.45 + 0.002j, 0.12, 1.5, nleg=16, n_quad=24, **device_kw),
            AEROSOL_ALTITUDES, 0.05 * nd)
    raise ValueError(kind)


def _case(pkg, kind):
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=8,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES,
        geometry_type=pkg.GeometryType.PlaneParallel,
    )
    viewing = pkg.ViewingGeometry()
    for mu in (0.5, 0.9):
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.5, mu, 200000.0))
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    device_kw = {"device": "cpu"} if pkg is skt else {}
    atmo["aerosol"] = _aerosol(pkg, kind, device_kw)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("kind", ["numden_hg", "gaussian_height",
                                  "extinction_db", "numden_mie"])
def test_scatterer_matches_jax(kind):
    case = _case(sk, kind)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    # the generic route's own case: the fast path's call fills ``case``'s
    # atmosphere, which would change this reference's digest
    generic_case = _case(sk, kind)

    def jax_generic_side():
        engine = sk.Engine(*generic_case[:3])
        engine._twostream_fast_ok = lambda: False
        return engine, engine.calculate_radiance(generic_case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    generic = torch_support.jax_engine_reference(jax_generic_side,
                                                 generic_case)
    config, geometry, viewing, atmo = _case(skt, kind)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    own = [k for k in ref.keys() if k.startswith("wf_aerosol")]
    assert own
    torch_support.assert_outputs_match(
        _Without(got, own), _Without(ref, own))
    for key in own:
        a, b = got[key].to_numpy(), ref[key].to_numpy()
        assert got[key].dims == ref[key].dims
        assert np.all(np.isfinite(a))
        assert torch_support.rel_err(a, b) <= 1e-8, key
        err, routes = (_per_level(x, b) for x in (a, generic[key].to_numpy()))
        assert np.all(err <= np.maximum(1e-10, routes)), (key, err, routes)


def _per_level(got, ref):
    """The largest error of each entry of the first axis, relative to the
    largest magnitude of ``ref``."""
    diff = np.abs(got - ref).reshape(len(ref), -1).max(axis=1)
    return diff / np.max(np.abs(ref))


class _Without:
    """An engine output without some of its variables."""

    def __init__(self, out, drop):
        self._out, self._drop = out, set(drop)

    def keys(self):
        return [k for k in self._out.keys() if k not in self._drop]

    def __getitem__(self, key):
        return self._out[key]


@pytest.mark.parametrize("name", ["NumberDensityScatterer2D",
                                  "ExtinctionScatterer2D"])
def test_2d_scatterers_refused(name):
    for pkg in (sk, skt):
        optical = pkg.constituent.HGScatteringOptical(1e-13, 0.9, 0.5, nleg=4)
        extra = (500.0,) if name == "ExtinctionScatterer2D" else ()
        config = pkg.Config(num_streams=4)
        geometries = (
            (pkg.Geometry1D(0.6, 0.0, 6372000.0, np.linspace(0.0, 1e5, 3)),
             TypeError, "requires an atmosphere using Geometry2D"),
            (pkg.Geometry2D(0.6, 0.0, 6372000.0, np.linspace(0.0, 1e5, 4),
                            np.linspace(-0.2, 0.2, 2)),
             ValueError, r"shape does not match the atmosphere: \(2, 3\)"),
        )
        for geometry, error, match in geometries:
            atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=[500.0])
            atmo["aero"] = getattr(pkg.constituent, name)(
                optical, np.ones((2, 3)), *extra)
            with pytest.raises(error, match=match):
                atmo.internal_object()
