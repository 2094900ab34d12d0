"""The port's line-list and population volume-emission-rate constituents
against the JAX package's, on the cases of ``tests/test_lineemission.py``:
the constituent arrays (the Doppler-broadened emission source and the
``photon_ver`` derivative mapping, which the port sums over the lines
with torch), the line lists a ``PopulationEmissionRate`` builds, and the
engine's radiance and ``wf_<name>_photon_ver`` at 1e-10 in float64, on
a ground-viewing emission-only case and on a small limb scan with DO
multiple scatter. The JAX side of each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_lineemission.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

O2_MOLAR_MASS = 0.0319988


def _dev(pkg):
    return {"device": "cpu"} if pkg is skt else {}


def _setup(pkg, wavelengths, nalt=12):
    """The JAX test's emission-only ground-viewing case
    (``tests/test_lineemission.py:17-33``)."""
    config = pkg.Config(
        num_streams=2,
        multiple_scatter_source=pkg.MultipleScatterSource.NoSource,
        single_scatter_source=pkg.SingleScatterSource.NoSource,
        emission_source=pkg.EmissionSource.VolumeEmissionRate,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0, 100000, nalt),
        geometry_type=pkg.GeometryType.PlaneParallel,
    )
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.3, 1.0, 2e5))
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wavelengths)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo.storage.solar_irradiance[:] = 0.0
    return config, geometry, viewing, atmo


def _record(iso, nu0, s, a, elower, qup, qlo, gp, gpp):
    """A 160-column HITRAN record with global quanta
    (``tests/test_lineemission.py:93-116``)."""
    line = (
        f"{7:2d}{iso:1d}{nu0:12.6f}{s:10.3E}{a:10.3E}"
        f"{0.05:5.3f}{0.04:5.3f}{elower:10.4f}{0.70:4.2f}{0.0:8.6f}"
    )
    line += f"{qup:>15}{qlo:>15}"
    line += " " * (146 - len(line))
    line += f"{gp:7.1f}{gpp:7.1f}"
    assert len(line) == 160
    return line


# two A-band lines (b0->X0), one hot-band line (b1->X1), one B-band line
# (b1->X0)
QUANTA_ROWS = [
    _record(1, 13120.0, 1e-25, 0.060, 2.0, "b 0", "X 0", 5.0, 3.0),
    _record(1, 13112.0, 2e-25, 0.020, 10.0, "b 0", "X 0", 5.0, 7.0),
    _record(1, 13125.0, 1e-24, 0.045, 1400.0, "b 1", "X 1", 7.0, 5.0),
    _record(1, 14520.0, 5e-26, 0.070, 2.0, "b 1", "X 0", 5.0, 3.0),
]


@pytest.fixture
def catalogues(tmp_path):
    """The quanta file parsed by each package's ``load_hitran_par``."""
    p = tmp_path / "o2_quanta.par"
    p.write_text("\n".join(QUANTA_ROWS) + "\n")
    return {pkg: pkg.optical.load_hitran_par(p, O2_MOLAR_MASS)
            for pkg in (sk, skt)}


def _spectral_integral_case(pkg):
    wl0 = 762.0
    wavelengths = np.linspace(wl0 - 0.5, wl0 + 0.5, 4001)
    _, _, _, atmo = _setup(pkg, wavelengths)
    alts = atmo.model_geometry.altitudes()
    ver = np.linspace(1.0, 2.0, alts.size) * 1e9
    con = pkg.constituent.LineListVolumeEmissionRate(
        alts, ver, np.array([wl0 - 0.05, wl0 + 0.05]),
        np.array([0.25, 0.75]), **_dev(pkg))
    return wavelengths, ver, atmo, con


def test_line_list_emission_source_matches_jax():
    """The broadened emission source and the ``photon_ver`` mapping of
    the JAX test's two-line case; the source integrates to VER / 4 pi."""

    def arrays(pkg):
        _, _, atmo, con = _spectral_integral_case(pkg)
        con.add_to_atmosphere(atmo)
        source = np.array(atmo.storage.emission_source)
        con.register_derivative(atmo, "airglow")
        m = atmo.storage.get_derivative_mapping("wf_airglow_photon_ver")
        return {"source": source, "d_emission": np.array(m.d_emission),
                "interpolator": np.array(m.interpolator)}

    ref = torch_support.jax_reference(lambda: arrays(sk), ())
    got = arrays(skt)
    for k, v in ref.items():
        assert torch_support.rel_err(got[k], v) <= 1e-12, k
    wavelengths, ver, _, _ = _spectral_integral_case(skt)
    integral = np.trapezoid(got["source"], wavelengths, axis=1)
    np.testing.assert_allclose(integral, ver / (4 * np.pi), rtol=1e-6)


def test_line_list_weight_normalization_and_validation():
    alts = np.linspace(0, 100e3, 5)
    ll = skt.constituent.LineListVolumeEmissionRate
    con = ll(alts, np.ones(5), np.array([760.0, 765.0]),
             np.array([2.0, 6.0]), device="cpu")
    np.testing.assert_allclose(con.weights, [[0.25, 0.75]] * 5)
    with pytest.raises(ValueError, match="positive finite"):
        ll(alts, np.ones(5), np.array([-760.0]), np.array([1.0]),
           device="cpu")
    with pytest.raises(ValueError, match="row sums"):
        ll(alts, np.ones(5), np.array([760.0, 765.0]),
           np.array([0.0, 0.0]), device="cpu")


def _photon_ver_case(pkg):
    """The JAX test's engine case of ``wf_airglow_photon_ver``
    (``tests/test_lineemission.py:68-88``)."""
    wavelengths = np.linspace(761.8, 762.2, 41)
    config, geometry, viewing, atmo = _setup(pkg, wavelengths)
    alts = atmo.model_geometry.altitudes()
    ver = np.exp(-((alts - 60e3) / 15e3) ** 2) * 1e9 + 1e7
    atmo["airglow"] = pkg.constituent.LineListVolumeEmissionRate(
        alts, ver, np.array([762.0]), np.array([1.0]), **_dev(pkg))
    return config, geometry, viewing, atmo


def _limb_case(pkg):
    """A small limb scan with DO multiple scatter on a 2-point SZA grid:
    4 streams, exact single scatter, VER emission, Rayleigh + Lambertian
    0.3 beside a two-line emission whose weights vary with altitude."""
    wavelengths = np.linspace(761.9, 762.1, 9)
    alts = np.linspace(0.0, 100000.0, 12)
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.Exact,
        emission_source=pkg.EmissionSource.VolumeEmissionRate,
        num_singlescatter_moments=4,
        num_do_sza=2,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=alts, geometry_type=pkg.GeometryType.Spherical,
    )
    viewing = pkg.ViewingGeometry()
    for tangent in (30000.0, 70000.0):
        viewing.add_ray(pkg.TangentAltitudeSolar(tangent, 0.4, 2e5, 0.6))
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wavelengths)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    ver = np.exp(-((alts - 65e3) / 12e3) ** 2) * 1e4 + 1.0
    share = np.linspace(0.2, 0.8, alts.size)
    atmo["airglow"] = pkg.constituent.LineListVolumeEmissionRate(
        alts, ver, np.array([761.95, 762.04]),
        np.stack([share, 1.0 - share], axis=1), **_dev(pkg))
    return config, geometry, viewing, atmo


def _population_case(pkg, cat):
    """The JAX test's population engine case
    (``tests/test_lineemission.py:161-186``)."""
    wl_line = 1e7 / 13120.0
    wavelengths = wl_line + np.linspace(-0.01, 0.01, 41)
    config, geometry, viewing, atmo = _setup(pkg, wavelengths)
    alts = atmo.model_geometry.altitudes()
    temp = np.asarray(atmo.temperature_k)
    pops = {"altitude": alts, "temperature": temp,
            "O2(b)": np.exp(-((alts - 90e3) / 10e3) ** 2) * 1e10}
    atmo["airglow"] = pkg.constituent.PopulationEmissionRate(
        pops, cat, **_dev(pkg))
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("case", ["photon_ver", "limb_do"])
def test_line_list_engine_matches_jax(case):
    build = {"photon_ver": _photon_ver_case, "limb_do": _limb_case}[case]
    ref_case = build(sk)

    def jax_side():
        engine = sk.Engine(*ref_case[:3])
        return engine, engine.calculate_radiance(ref_case[3])

    ref = torch_support.jax_engine_reference(jax_side, ref_case)
    config, geometry, viewing, atmo = build(skt)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    assert "wf_airglow_photon_ver" in got.keys()
    torch_support.assert_outputs_match(got, ref)


def _line_lists(con):
    return {"n": np.array(con.num_line_list_emissions),
            "lists": [{"ver": con.line_list_photon_ver(i),
                       "wavelengths": con.line_list_wavelengths_nm(i),
                       "weights": con.line_list_weights(i)}
                      for i in range(con.num_line_list_emissions)]}


def test_population_emission_rate_builds_bands(catalogues):
    alts = np.linspace(50e3, 100e3, 6)
    temp = np.linspace(250.0, 180.0, 6)
    pops = {"altitude": alts, "temperature": temp,
            "O2(b)": np.full(6, 1e10), "O2(b, v=1)": np.full(6, 2e9)}
    for model in ("einstein_a_branching", "hitran_line_strength"):
        def lists(pkg, model=model):
            return _line_lists(pkg.constituent.PopulationEmissionRate(
                pops, catalogues[pkg], line_weight_model=model,
                **_dev(pkg)))

        ref = torch_support.jax_reference(
            lambda: lists(sk), (pops, QUANTA_ROWS, model))
        got = lists(skt)
        assert int(got["n"]) == int(ref["n"]) == 2
        for a, b in zip(got["lists"], ref["lists"]):
            for k, v in b.items():
                np.testing.assert_allclose(a[k], v, rtol=1e-12, atol=0,
                                           err_msg=(model, k))
    # A band: b0->X0 x2 + b1->X1; B band: b1->X0; VER = pop x A
    expected_a = 1e10 * 7.58e-2 + 2e9 * 7.0e-2
    np.testing.assert_allclose(got["lists"][0]["ver"], expected_a)
    np.testing.assert_allclose(got["lists"][1]["ver"], 2e9 * 7.0e-2)


def test_population_engine_matches_jax(catalogues):
    ref_case = _population_case(sk, catalogues[sk])

    def jax_side():
        engine = sk.Engine(*ref_case[:3])
        return engine, engine.calculate_radiance(ref_case[3])

    ref = torch_support.jax_engine_reference(jax_side, ref_case)
    config, geometry, viewing, atmo = _population_case(skt, catalogues[skt])
    got = skt.Engine(config, geometry, viewing,
                     device="cpu").calculate_radiance(atmo)
    # a population emission registers no weighting function
    assert not any(k.startswith("wf_airglow") for k in got.keys())
    torch_support.assert_outputs_match(got, ref)
    rad = got["radiance"].to_numpy()[:, 0, 0]
    wavelengths = 1e7 / 13120.0 + np.linspace(-0.01, 0.01, 41)
    assert abs(wavelengths[np.argmax(rad)] - 1e7 / 13120.0) < 0.05


def test_population_emission_needs_o2_b():
    with pytest.raises(ValueError, match="O2\\(b\\)"):
        skt.constituent.PopulationEmissionRate(
            {"altitude": np.zeros(2), "temperature": np.ones(2)},
            catalogue=skt.optical.LineCatalogue(
                *(np.ones(1),) * 7, molar_mass=O2_MOLAR_MASS),
            device="cpu")
