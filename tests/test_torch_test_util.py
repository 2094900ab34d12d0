"""The port's test utilities (``sasktran2_tpu_torch/test_util``) against
the JAX package's: the canned scenarios, the finite-difference check of
analytic weighting functions (``wf.numeric_wf`` / ``wf.validate_wf``) and
the Zawada et al. (2021) limb intercomparison harness, this one on a small
synthetic HDF5 file in the published group layout, written under each
package's own database root. The JAX side of each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_test_util.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu.test_util.zawada  # noqa: F401 - sk.test_util.zawada
import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch import scenarios
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

# the port's numeric WF against the JAX package's, relative to the
# largest analytic magnitude. Both are central differences over a step of
# 1e-3 of the input, whose float64 roundoff at the top levels (extinction
# 1.4e-8 / m at 60 km) leaves each numeric WF up to 2.6e-8 off its own
# analytic one; the two numeric WFs differ by 8.5e-9 (extinction) and
# 7e-13 (ssa) on an x86-64 CPU
NUMERIC_WF_TOL = 1e-7


def _storage_tree(atmo):
    """Every array of an atmosphere's storage and surface."""
    return {
        "storage": {k: v for k, v in vars(atmo.storage).items()
                    if isinstance(v, np.ndarray)},
        "surface": {k: v for k, v in vars(atmo.surface).items()
                    if isinstance(v, np.ndarray)},
        "calculate_derivatives": np.array(atmo.calculate_derivatives),
    }


def _pure_scattering(pkg, nstokes, ssa, albedo):
    config = pkg.Config(num_streams=4, num_stokes=nstokes)
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 20),
        geometry_type=pkg.GeometryType.PlaneParallel)
    atmo = pkg.test_util.default_pure_scattering_atmosphere(
        config, geometry, ssa=ssa, albedo=albedo)
    return _storage_tree(atmo)


@pytest.mark.parametrize(("nstokes", "ssa", "albedo"),
                         [(1, 1.0, 0.0), (3, 0.9, 0.3)])
def test_pure_scattering_atmosphere_bit_equal(nstokes, ssa, albedo):
    ref = torch_support.jax_reference(
        lambda: _pure_scattering(sk, nstokes, ssa, albedo),
        (nstokes, ssa, albedo))
    got = _pure_scattering(skt, nstokes, ssa, albedo)
    for part in ("storage", "surface"):
        assert set(got[part]) == set(ref[part])
        for k, v in ref[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    assert bool(got["calculate_derivatives"]) == bool(
        ref["calculate_derivatives"])


def test_aerosol_profile_equal():
    alts = np.linspace(0.0, 50000.0, 51)
    ref = torch_support.jax_reference(
        lambda: sk.test_util.test_aerosol_constituent(alts), alts)
    np.testing.assert_array_equal(
        skt.test_util.test_aerosol_constituent(alts), ref)


# --- numeric_wf / validate_wf -----------------------------------------------

def _polarized_wf_case(pkg, **engine_kw):
    """``tests/test_polarized_engine.py``'s FD setting: 4 streams, I/Q/U,
    DO single and multiple scatter, 13 levels on 0-60 km, two
    ground-viewing rays, SSA 0.9, Rayleigh phase, albedo 0.3."""
    config = pkg.Config(
        num_streams=4, num_stokes=3,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4)
    alts = np.linspace(0, 60000, 13)
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=alts, geometry_type=pkg.GeometryType.PlaneParallel)
    viewing = pkg.ViewingGeometry()
    for mu, azi in ((0.8, 0.3), (0.5, 1.5)):
        viewing.add_ray(pkg.GroundViewingSolar(0.6, azi, mu, 200000.0))
    engine = pkg.Engine(config, geometry, viewing, **engine_kw)
    atmo = pkg.Atmosphere(geometry, config, numwavel=1)
    atmo.storage.total_extinction[:] = (7e-5 * np.exp(-alts / 7000))[:, None]
    atmo.storage.ssa[:] = 0.9
    a1 = atmo.leg_coeff.a1
    a1[0] = 1.0
    a1[2] = 0.5
    atmo.leg_coeff.a2[2] = 3.0
    atmo.leg_coeff.b1[2] = np.sqrt(6.0) / 2
    atmo.surface.albedo[:] = 0.3
    return engine, atmo


def _numeric_wf(pkg, var, **engine_kw):
    engine, atmo = _polarized_wf_case(pkg, **engine_kw)
    name = {"total_extinction": "wf_extinction", "ssa": "wf_ssa"}[var]
    ds = pkg.test_util.wf.numeric_wf(
        getattr(atmo.storage, var)[:, 0], 0.001, engine, atmo, name)
    return {"analytic": ds[name].to_numpy(),
            "numeric": ds[name + "_numeric"].to_numpy(),
            "dims": np.array(ds[name].dims), "ds": ds, "name": name}


@pytest.mark.parametrize("var", ["total_extinction", "ssa"])
def test_numeric_wf_matches_jax(var):
    """The port's ``numeric_wf`` at the 4-stream polarized setting equals
    the JAX package's within ``NUMERIC_WF_TOL`` of the largest analytic
    magnitude (the analytic WFs within 1e-10), and passes ``validate_wf``
    at decimal 5 as the JAX test does."""

    def reference():
        out = _numeric_wf(sk, var)
        return {k: out[k] for k in ("analytic", "numeric", "dims")}

    ref = torch_support.jax_reference(reference, var)
    got = _numeric_wf(skt, var, device="cpu")
    assert tuple(got["dims"]) == tuple(str(d) for d in ref["dims"])
    scale = np.abs(ref["analytic"]).max()
    assert np.abs(got["analytic"] - ref["analytic"]).max() <= 1e-10 * scale
    err = np.abs(got["numeric"] - ref["numeric"]).max() / scale
    assert err <= NUMERIC_WF_TOL, err
    ds, name = got["ds"], got["name"]
    skt.test_util.wf.validate_wf(ds[name], ds[name + "_numeric"],
                                 wf_dim="altitude", decimal=5)
    assert np.all(got["numeric"] != 0)


class _QuadraticEngine:
    """A stand-in engine whose radiance is a fixed quadratic of ``x``
    (every element of which may be of any sign, as the port's and the
    JAX package's engines refuse a negative extinction)."""

    def __init__(self, pkg, x):
        self.pkg, self.x = pkg, x
        self.m = np.random.default_rng(14).normal(size=(len(x), 2))

    def calculate_radiance(self, atmosphere):
        arr = self.pkg.DataArray
        rad = self.x @ self.m + 0.5 * (self.x ** 2) @ self.m
        wf = self.m * (1.0 + self.x)[:, None]
        return {"radiance": arr(rad, ("los",)),
                "wf_x": arr(wf, ("altitude", "los"))}


def _edge_steps(pkg):
    x = np.array([0.7, 0.0, -0.4, 1.3])
    atmosphere = type("Atmosphere", (), {"calculate_derivatives": True})()
    ds = pkg.test_util.wf.numeric_wf(
        x, 0.001, _QuadraticEngine(pkg, x), atmosphere, "wf_x")
    return {"numeric": ds["wf_x_numeric"].to_numpy(), "x": x}


def test_numeric_wf_edges_match_jax():
    """``numeric_wf``'s three steps, held to the JAX package's on an
    input with a positive, a zero (a step of the input's mean) and a
    negative element (a one-sided step against the base radiance): the
    numeric WFs are equal, and the input is put back."""
    ref = torch_support.jax_reference(lambda: _edge_steps(sk), ())
    got = _edge_steps(skt)
    np.testing.assert_array_equal(got["numeric"], ref["numeric"])
    np.testing.assert_array_equal(got["x"], ref["x"])
    np.testing.assert_allclose(got["x"], [0.7, 0.0, -0.4, 1.3],
                               rtol=0, atol=1e-15)


def test_numeric_wf_16_streams_polarized():
    """The port alone at 16 streams polarized (the K = 48 block solve and
    the n = 24 eigensolve) on a coarse grid of ``scenarios.fd16_case``:
    the FD WF of the extinction passes ``validate_wf`` at decimal 5, and
    is nonzero wherever the analytic WF is significant. The JAX package
    has no engine-level value at 16 streams polarized on the CPU."""
    config, geometry, viewing, atmo = scenarios.fd16_case(
        skt, num_stokes=3, num_altitudes=7)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    ds = skt.test_util.wf.numeric_wf(
        atmo.storage.total_extinction[:, 0], scenarios.FD_FRACTIONAL_CHANGE,
        engine, atmo, "wf_extinction")
    a = ds["wf_extinction"].to_numpy()
    n = ds["wf_extinction_numeric"].to_numpy()
    assert a.shape == (7, 1, 4, 3)
    skt.test_util.wf.validate_wf(ds["wf_extinction"],
                                 ds["wf_extinction_numeric"],
                                 wf_dim="altitude", decimal=5)
    assert np.all(n[np.abs(a) > 1e-3 * np.abs(a).max()] != 0)
    assert bool(atmo.calculate_derivatives)     # restored after the steps


def _validate_outcomes(pkg):
    """The exception (its type name, or "none") of ``validate_wf`` on a
    good pair and on three bad ones."""
    rng = np.random.default_rng(14)
    a = rng.normal(size=(5, 1, 2, 3))
    dims = ("altitude", "wavelength", "los", "stokes")
    arr = pkg.DataArray
    cases = {
        "equal": (a, a + 1e-9, dims, "altitude"),
        "off": (a, a * (1 + 1e-3), dims, "altitude"),
        "missing_dim": (a, a, dims, "pressure"),
        "shapes": (a, a[:4], dims, "altitude"),
    }
    out = {}
    for name, (x, y, d, wf_dim) in cases.items():
        try:
            pkg.test_util.wf.validate_wf(arr(x, d), arr(y, d),
                                         wf_dim=wf_dim, decimal=6)
            out[name] = np.array("none")
        except Exception as e:  # noqa: BLE001 - the types are compared
            out[name] = np.array(type(e).__name__)
    return out


def test_validate_wf_raises_alike():
    ref = torch_support.jax_reference(lambda: _validate_outcomes(sk), ())
    got = _validate_outcomes(skt)
    assert {k: str(v) for k, v in got.items()} == {
        k: str(v) for k, v in ref.items()}
    assert str(got["equal"]) == "none"
    assert str(got["off"]) == "AssertionError"


# --- zawada ------------------------------------------------------------------

ZAWADA_NAME = "zawada_AMT_rtm_comparison_data_v1.nc"


@pytest.fixture
def zawada_roots(tmp_path, monkeypatch):
    """Each package's database root, empty."""
    roots = {sk: tmp_path / "jax", skt: tmp_path / "port"}
    for r in roots.values():
        r.mkdir()
    monkeypatch.setenv("SASKTRAN2_TPU_DB_ROOT", str(roots[sk]))
    monkeypatch.setenv("SASKTRAN2_TPU_TORCH_DB_ROOT", str(roots[skt]))
    return roots


def _write_zawada(root):
    """A small intercomparison file in the published group layout
    (``geometry_data``, ``ancillary_data``, ``model_data``), seeded."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(2021)
    alt = np.linspace(0.0, 100000.0, 26)
    wl = np.array([350.0, 600.0, 750.0])
    air = 2.5e25 * np.exp(-alt / 7000.0)
    groups = {
        "geometry_data": {
            "tangent_sza": np.array([60.0, 80.0]),
            "tangent_saa": np.array([30.0, 120.0]),
            "tangent_altitude": np.array([10.0, 20.0, 30.0, 40.0]),
        },
        "ancillary_data": {
            "altitude": alt,
            "pressure": 101325.0 * np.exp(-alt / 7000.0),
            "temperature": 288.0 - 60.0 * np.sin(alt / 60000.0),
            "wavelength": wl,
            "rayleigh_scattering_cross_section":
                4.0e-28 * (wl / 350.0) ** -4,
            "ozone_absorption_cross_section":
                1e-21 * (1.0 + rng.uniform(size=3)),
            "ozone_numden": 5e12 * np.exp(-((alt - 25000.0) / 6000.0) ** 2),
            "air_numden": air,
            "aerosol_numden": 10.0 * np.exp(-((alt - 20000.0) / 4000.0) ** 2),
        },
        "model_data": {
            "albedo": np.array([0.0, 0.3]),
            "mmm": rng.uniform(0.01, 0.1, size=(3, 4, 3)),
        },
    }
    path = root / "validation" / ZAWADA_NAME
    path.parent.mkdir(parents=True)
    with h5py.File(path, "w") as f:
        for g, arrays in groups.items():
            grp = f.create_group(g)
            for k, v in arrays.items():
                grp.create_dataset(k, data=v)


def _scenario_tree(pkg, atmosphere_index, test_case):
    scen = pkg.test_util.zawada.load_scenario(
        1, atmosphere_index, 1, test_case, altitude_spacing=4000.0)
    atmo = scen["atmosphere"]
    atmo.internal_object()
    config, geometry = scen["config"], scen["geometry"]
    rays = [[float(v) for v in vars(r).values()
             if isinstance(v, (int, float))]
            for r in scen["viewing"].observer_rays]
    return {
        "atmosphere": _storage_tree(atmo),
        "altitudes": geometry.altitudes(),
        "refractive_index": np.asarray(geometry.refractive_index),
        "rays": np.array(rays),
        "config": {k: np.array(str(getattr(config, k))) for k in (
            "num_stokes", "single_scatter_source",
            "multiple_scatter_source", "num_successive_orders_iterations",
            "num_successive_orders_sza", "los_refraction")},
        "model_data": scen["model_data"],
        "geometry_index": np.array(scen["geometry_index"]),
    }


@pytest.mark.parametrize(("atmosphere_index", "test_case"), [(0, 0), (1, 2)])
def test_zawada_scenario_inputs_equal(zawada_roots, atmosphere_index,
                                      test_case):
    """``load_scenario`` reads each package's own file and builds the same
    engine inputs (bit-equal): the atmosphere's storage after its
    constituents run (Rayleigh; with ozone at index 1),
    the geometry with the Ciddor refractive index, the rays, the
    configuration and the published model data."""
    for root in zawada_roots.values():
        _write_zawada(root)
    ref = torch_support.jax_reference(
        lambda: _scenario_tree(sk, atmosphere_index, test_case),
        (atmosphere_index, test_case))
    got = _scenario_tree(skt, atmosphere_index, test_case)
    assert skt.test_util.zawada.comparison_file() == (
        zawada_roots[skt] / "validation" / ZAWADA_NAME)
    for part in ("storage", "surface"):
        assert set(got["atmosphere"][part]) == set(ref["atmosphere"][part])
        for k, v in ref["atmosphere"][part].items():
            np.testing.assert_array_equal(got["atmosphere"][part][k], v,
                                          err_msg=k)
    for k in ("altitudes", "refractive_index", "rays", "geometry_index"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k, v in ref["config"].items():
        assert str(got["config"][k]) == str(v), k
    for k, v in ref["model_data"].items():
        np.testing.assert_array_equal(got["model_data"][k], v, err_msg=k)


def _percent_difference(pkg):
    scen = pkg.test_util.zawada.load_scenario(0, 0, 0, 1,
                                              altitude_spacing=4000.0)
    rad = np.random.default_rng(3).uniform(0.01, 0.1, size=(3, 4, 3))
    return pkg.test_util.zawada.percent_difference_vs_models(
        rad, scen, test_case=1)


def test_zawada_percent_difference_equal(zawada_roots):
    for root in zawada_roots.values():
        _write_zawada(root)
    ref = torch_support.jax_reference(lambda: _percent_difference(sk), ())
    got = _percent_difference(skt)
    assert got.shape == (3, 4, 3)
    np.testing.assert_array_equal(got, ref)


def _absent(pkg):
    raised = "none"
    try:
        pkg.test_util.zawada.load_scenario(0, 0, 0, 0)
    except FileNotFoundError:
        raised = "FileNotFoundError"
    return {"comparison_file_none": np.array(
        pkg.test_util.zawada.comparison_file() is None),
        "load_scenario": np.array(raised)}


def test_zawada_comparison_file_absent(zawada_roots):
    """With no file under either root, ``comparison_file()`` is None in
    both packages and ``load_scenario`` raises ``FileNotFoundError``."""
    ref = torch_support.jax_reference(lambda: _absent(sk), ())
    got = _absent(skt)
    assert bool(got["comparison_file_none"])
    assert {k: str(v) for k, v in got.items()} == {
        k: str(v) for k, v in ref.items()}
