"""The port's data-reading host modules against the JAX package's, on
synthetic files written to ``tmp_path`` (nothing is downloaded): the
atomic-oxygen climatology (its table is the port's own copy), the
MIPAS / FASCODE reference atmospheres and GloSSAC, ``SolarModel``,
``HITRANLineDatabase`` under ``SASKTRAN2_TPU_TORCH_DB_ROOT``, the named
cross-section absorbers and ``BaumIceCrystal``, the Ciddor refractive
index, and ``units`` and ``constants``; each package reads its files from
its own database root. The cases are those of ``tests/test_climatology.py``,
``test_mipas.py``, ``test_misc_components.py``, ``test_optical_database.py``,
``test_baum.py`` and ``test_refraction.py`` that need no download. The
JAX side of each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_host_data.npz``
(``tests/torch_support.py``)."""

import datetime

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch import scenarios
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """A database root for each package: the JAX package's
    (``SASKTRAN2_TPU_DB_ROOT``) and the port's
    (``SASKTRAN2_TPU_TORCH_DB_ROOT``), keyed by package."""
    out = {sk: tmp_path / "jax", skt: tmp_path / "port"}
    monkeypatch.setenv("SASKTRAN2_TPU_DB_ROOT", str(out[sk]))
    monkeypatch.setenv("SASKTRAN2_TPU_TORCH_DB_ROOT", str(out[skt]))
    return out


def _assert_tree_equal(got, ref, rtol=0.0):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _assert_tree_equal(got[k], ref[k], rtol)
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_tree_equal(a, b, rtol)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


# --- atomic oxygen ----------------------------------------------------------

def _atomic_oxygen(pkg):
    ao = pkg.climatology.atomic_oxygen
    alts = np.arange(30000.0, 141000.0, 2500.0)
    return {
        "june_equator": ao.number_density(alts, 6, 0.0),
        "july_20n": ao.number_density(alts, 7.0, 20.0),
        "date": ao.number_density(alts, datetime.date(2020, 1, 17), -33.0),
        "wrap": ao.number_density(alts, 12.99, 79.0),
        "fills": ao.number_density(alts, 1, 40.0, lower_fill_value=1e6,
                                   upper_fill_value=None),
    }


def test_atomic_oxygen_matches_jax():
    ref = torch_support.jax_reference(lambda: _atomic_oxygen(sk), ())
    got = _atomic_oxygen(skt)
    _assert_tree_equal(got, ref)
    peak = np.arange(30000.0, 141000.0, 2500.0)[
        np.argmax(got["june_equator"])]
    assert 85000.0 <= peak <= 105000.0
    with pytest.raises(ValueError):
        skt.climatology.atomic_oxygen.number_density(np.zeros(1), 0.5, 0.0)
    with pytest.raises(ValueError):
        skt.climatology.atomic_oxygen.number_density(np.zeros(1), 6, 85.0)


# --- MIPAS / FASCODE reference atmospheres -----------------------------------

ATM_TEXT = """! Synthetic RFM-format reference atmosphere for tests
! comment lines start with !
         5 ! No. levels in profiles
*HGT [km]
   0.0,  10.0,  20.0,
  30.0,  40.0
*PRE [mb]
 1013.25, 264.99, 55.29,
 11.97, 2.87
*TEM [K]
 288.15, 223.25, 216.65,
 226.51, 250.35
*O3 [ppmv]
 0.03, 0.1, 4.5,
 8.0, 7.5
*H2O [ppmv]
 7000.0, 50.0, 4.0,
 4.5, 5.5
*END
"""

MINOR_TEXT = """! minor species file
         5
*HGT [km]
 0.0 10.0 20.0 30.0 40.0
*NO2 [ppmv]
 1e-5 2e-5 1e-3 4e-3 2e-3
*END
"""


def _mipas(pkg):
    """The profiles of the synthetic files, read from the package's
    database root (``climatology/fascode/std.atm`` and the minor-species
    file), the constituents they give, and the atmosphere's pressure and
    temperature after ``add_to_atmosphere``."""
    mipas = pkg.climatology.mipas
    xs = pkg.optical.TabulatedCrossSectionAbsorber(
        np.array([300.0, 600.0]), np.array([1e-24, 1e-25]))
    data = mipas._load_profiles("fascode", "std")
    o3 = mipas.constituent("O3", xs)
    no2 = mipas.constituent("NO2", xs)
    config = pkg.Config(num_streams=2)
    geometry = pkg.Geometry1D(0.6, 0.0, 6372000.0,
                              np.linspace(0, 40000, 9),
                              geometry_type=pkg.GeometryType.PlaneParallel)
    atmo = pkg.Atmosphere(geometry, config,
                          wavelengths_nm=np.array([330.0, 550.0]))
    mipas.add_to_atmosphere(atmo, {"O3": xs})
    return {
        "profiles": {k: v for k, v in data.items()},
        "o3": [o3.altitudes_m, o3.vmr], "no2": [no2.altitudes_m, no2.vmr],
        "pressure": np.asarray(atmo.pressure_pa),
        "temperature": np.asarray(atmo.temperature_k),
    }


def test_mipas_matches_jax(roots):
    for pkg in (sk, skt):
        d = roots[pkg] / "climatology" / "fascode"
        d.mkdir(parents=True)
        (d / "std.atm").write_text(ATM_TEXT)
        minor = pkg.climatology.mipas._MINOR_FILES["fascode"]
        (d / minor).write_text(MINOR_TEXT)
    ref = torch_support.jax_reference(lambda: _mipas(sk),
                                      (ATM_TEXT, MINOR_TEXT))
    got = _mipas(skt)
    _assert_tree_equal(got, ref)
    np.testing.assert_allclose(got["no2"][1][2], 1e-9)
    with pytest.raises(KeyError):
        skt.climatology.mipas.constituent(
            "CH4", None, atm_data=skt.climatology.mipas.read_atm(ATM_TEXT),
            minor_data=skt.climatology.mipas.read_atm(MINOR_TEXT))


# --- GloSSAC ----------------------------------------------------------------

def _glossac_arrays():
    rng = np.random.default_rng(21)
    alts_km = np.arange(5.0, 40.0, 1.0)
    lats = np.arange(-77.5, 78, 5.0)
    table = rng.uniform(1e-4, 1e-2, (12, alts_km.size, lats.size, 2))
    return {
        "coord_month": np.arange(1, 13), "coord_alt": alts_km,
        "coord_lat": lats, "coord_wavelengths_glossac": np.array([525.0,
                                                                  1020.0]),
        "Stratospheric_Background": table,
        "dims_Stratospheric_Background": np.array(
            ["month", "alt", "lat", "wavelengths_glossac"]),
    }


def _glossac(pkg, path):
    g = pkg.climatology.glossac
    ds = g.load_glossac_raw_data(path=path)
    alts = np.linspace(0.0, 60000.0, 31)
    return {f"{month}_{lat}_{wl}": g.stratospheric_background(
                month, lat, alts, wl, dataset=ds)
            for month, lat, wl in ((1, 0.0, 525.0), (6, 33.3, 1020.0),
                                   (12, -80.0, 525.0))}


def test_glossac_matches_jax(tmp_path, roots):
    path = tmp_path / "glossac.npz"
    arrays = _glossac_arrays()
    np.savez(path, **arrays)
    ref = torch_support.jax_reference(lambda: _glossac(sk, path), arrays)
    _assert_tree_equal(_glossac(skt, path), ref)
    with pytest.raises(FileNotFoundError):
        skt.climatology.glossac.load_glossac_raw_data(
            path=None, version="missing")


# --- SolarModel -------------------------------------------------------------

def _solar(pkg):
    """``SolarModel`` in its three modes on explicit arrays, with the
    solar-distance scaling, and from a cached source file."""
    solar = pkg.solar
    wl = np.linspace(300.0, 700.0, 401)
    irr = 1.0 + 0.5 * np.sin(wl / 20.0)
    at = np.array([333.3, 400.0, 512.25, 650.0])
    out = {"sample": solar.SolarModel(wl, irr).irradiance(at),
           "distance": solar.SolarModel(wl, irr).irradiance(
               at, solardistance=1.7)}
    for mode in ("average", "integrate"):
        out[mode] = solar.SolarModel(wl, irr, mode=mode,
                                     resolution_nm=10.0).irradiance(at)
    out["source"] = solar.SolarModel(
        source=solar.model.HSRS_2022).irradiance(at)
    return out


def test_solar_model_matches_jax(roots):
    wl = np.linspace(300.0, 700.0, 401)
    irr = 1.0 + 0.5 * np.sin(wl / 20.0)
    for pkg in (sk, skt):
        d = roots[pkg] / "solar"
        d.mkdir(parents=True)
        np.savez(d / "solar_irradiance_hsrs_2022_11_30_extended.npz",
                 coord_wavelength=wl, irradiance=2.0 * irr,
                 dims_irradiance=np.array(["wavelength"]))
    ref = torch_support.jax_reference(lambda: _solar(sk), (wl, irr))
    got = _solar(skt)
    _assert_tree_equal(got, ref)
    with pytest.raises(FileNotFoundError, match="missing_source"):
        skt.solar.SolarModel(source="missing_source")


# --- HITRAN line files ------------------------------------------------------

def _catalogue_tree(cat):
    return {k: np.asarray(getattr(cat, k)) for k in (
        "nu0", "intensity", "gamma_air", "gamma_self", "n_air", "delta_air",
        "elower", "einstein_a", "iso_id", "g_upper", "g_lower")} | {
        "quanta": np.array([f"{u}|{lo}" for u, lo in zip(
            cat.quanta_upper, cat.quanta_lower)])}


def test_hitran_line_database_matches_jax(roots):
    """``HITRANLineDatabase`` reads ``<root>/hitran/lines/O2.par`` (the
    dayglow cell's file) from the port's own root."""
    for pkg in (sk, skt):
        scenarios.write_dayglow_par(str(roots[pkg]))

    def load(pkg):
        db = pkg.database.HITRANLineDatabase()
        return _catalogue_tree(db.load_catalogue("O2"))

    ref = torch_support.jax_reference(lambda: load(sk),
                                      scenarios.dayglow_par_lines())
    got = load(skt)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    db = skt.database.HITRANLineDatabase()
    assert db.path("o2") == roots[skt] / "hitran" / "lines" / "O2.par"
    assert got["nu0"].size == scenarios.O2A16_NUM_LINES
    with pytest.raises(FileNotFoundError, match="CO2"):
        db.load_catalogue("CO2")
    with pytest.raises(ValueError, match="molar mass"):
        db.load_catalogue("XY")


def test_download_helpers_stay_refused():
    """The download helpers, refused until the port had a web layer, now
    resolve to the port's own ``database/web.py`` (its contracts:
    ``tests/test_torch_web_database.py``)."""
    from sasktran2_tpu_torch.database import web

    for name in ("WebDatabase", "ZipWebDatabase", "StandardDatabase",
                 "download_zenodo_record"):
        got = getattr(skt.database, name)
        assert got is getattr(web, name)
        assert got.__module__ == "sasktran2_tpu_torch.database.web"
        assert got is not getattr(sk.database, name)


# --- named absorbers and Baum ice crystals -------------------------------------

NAMED = {"O3DBM": "o3/dbm", "O3Serdyuchenko": "o3/serdyuchenko",
         "O3BirkWagner": "o3/birkwagner", "NO2Vandaele": "no2/vandaele"}


def _named(pkg):
    at = np.array([260.0, 433.3, 500.0])
    kw = {"altitudes_m": np.array([0.0, 1e4, 2e4]),
          "temperature_k": np.array([280.0, 220.0, 250.0]),
          "pressure_pa": np.array([1e5, 2e4, 5e3])}
    out = {name: getattr(pkg.optical, name)().cross_sections(at, **kw)
           for name in NAMED}
    out["HITRANUV"] = pkg.optical.HITRANUV("so2").cross_sections(at, **kw)
    out["HITRANTabulated"] = pkg.optical.HITRANTabulated(
        "CH4").cross_sections(at, **kw)
    return out


def test_named_absorbers_match_jax(roots):
    wl = np.linspace(200.0, 800.0, 31)
    t = np.array([220.0, 280.0])
    rels = [*NAMED.values(), "so2/hitran2022", "ch4/hitran_01nm_res"]
    for pkg in (sk, skt):
        with pytest.raises(FileNotFoundError, match="o3/dbm.nc"):
            pkg.optical.O3DBM()
        for i, rel in enumerate(rels):
            path = roots[pkg] / "cross_sections" / f"{rel}.npz"
            path.parent.mkdir(parents=True, exist_ok=True)
            xs = (1e-24 * (i + 1)
                  * np.exp(-((wl - 255.0 - 40 * i) / 60.0) ** 2)[None, :]
                  * np.array([[1.1], [0.9]]))
            np.savez(path, coord_wavelength_nm=wl, coord_temperature_k=t,
                     dims_xs=np.array(["temperature_k", "wavelength_nm"]),
                     xs=xs)
    ref = torch_support.jax_reference(lambda: _named(sk), (wl, t, rels))
    _assert_tree_equal(_named(skt), ref)


def _write_baum(tmp_path, nleg=8):
    """A synthetic Baum table (``tests/test_baum.py:10-43``)."""
    wl = np.array([500.0, 1000.0, 2000.0])
    deff = np.array([10.0, 60.0, 120.0])
    models = np.array(["general_habit_mixture", "solid_columns"],
                      dtype="U32")
    rng = np.random.default_rng(2)
    xs_total = rng.uniform(0.5, 2.0, (models.size, deff.size, wl.size))
    lm = np.zeros((nleg, models.size, deff.size, wl.size))
    lm[0] = 1.0
    lm[1] = rng.uniform(1.2, 2.4, lm[1].shape)
    arrays = {"coord_wavelength_nm": wl, "coord_effective_diameter_um": deff,
              "coord_particle_model": models,
              "coord_legendre": np.arange(nleg)}
    dims4 = np.array(["legendre", "particle_model", "effective_diameter_um",
                      "wavelength_nm"])
    dims3 = dims4[1:]
    arrays["xs_total"] = xs_total
    arrays["xs_scattering"] = 0.9 * xs_total
    for name in ("xs_total", "xs_scattering"):
        arrays[f"dims_{name}"] = dims3
    for name in ("lm_a1", "lm_a2", "lm_a3", "lm_a4", "lm_b1", "lm_b2"):
        arrays[name] = lm if name == "lm_a1" else 0.1 * lm
        arrays[f"dims_{name}"] = dims4
    p = tmp_path / "baum_test.npz"
    np.savez(p, **arrays)
    return p


def _baum(pkg, path):
    out = {}
    for model in ("general_habit_mixture", "solid_columns"):
        b = pkg.optical.BaumIceCrystal(model, max_moments=4,
                                       db_filepath=path)
        props = b.scattering_properties(
            np.array([750.0, 1500.0]), altitudes_m=np.array([0.0, 1.0, 2.0]),
            effective_diameter_um=np.array([35.0, 60.0, 100.0]))
        out[model] = {k: np.asarray(v) for k, v in props.items()}
    return out


def test_baum_ice_crystal_matches_jax(tmp_path):
    path = _write_baum(tmp_path)
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    ref = torch_support.jax_reference(lambda: _baum(sk, path), arrays)
    _assert_tree_equal(_baum(skt, path), ref)
    with pytest.raises(ValueError, match="Unknown Baum particle model"):
        skt.optical.BaumIceCrystal("plates", db_filepath=path)
    with pytest.raises(ValueError, match="only contains"):
        skt.optical.BaumIceCrystal(max_moments=100, db_filepath=path)


# --- refraction, units, constants ----------------------------------------------

def _ciddor(pkg):
    f = pkg.optical.refraction.ciddor_index_of_refraction
    rng = np.random.default_rng(8)
    t = rng.uniform(190.0, 320.0, 40)
    p = 10.0 ** rng.uniform(0.0, 5.0, 40)
    q = rng.uniform(0.0, 0.02, 40)
    return {"published": np.array([
                f(293.15, 101325.0, 0.0, 450.0, 633.0),
                f(293.15, 60000.0, 0.0, 450.0, 633.0),
                f(323.15, 100000.0, 0.0, 450.0, 633.0),
                f(293.15, 101325.0, 0.0, 450.0, 1700.0)]),
            "profile": f(t, p, q, 400.0, 550.0)}


def test_ciddor_matches_jax():
    ref = torch_support.jax_reference(lambda: _ciddor(sk), ())
    got = _ciddor(skt)
    _assert_tree_equal(got, ref)
    np.testing.assert_allclose(got["published"][0], 1.0002718, atol=5e-8)


def test_units_and_constants_equal():
    for name in ("K_BOLTZMANN", "PLANCK", "SPEED_OF_LIGHT"):
        assert getattr(skt.constants, name) == getattr(sk.constants, name)
    x = np.array([200.0, 500.0, 13100.0])
    for name in ("celsius_to_kelvin", "kelvin_to_celsius",
                 "wavlength_nm_to_wavenumber_cminv",
                 "wavenumber_cminv_to_wavlength_nm",
                 "wavelength_nm_to_wavenumber_cminv",
                 "wavenumber_cminv_to_wavelength_nm"):
        np.testing.assert_array_equal(getattr(skt.units, name)(x),
                                      getattr(sk.units, name)(x))
