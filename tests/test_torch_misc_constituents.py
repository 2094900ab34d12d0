"""The port's misc constituents (``constituent/misc.py``: manual optical
properties, solar irradiance, collision-induced absorption, air-mass
factors) against the JAX package's: the atmosphere's arrays and
derivative mappings bit-equal, and engine outputs at 1e-10 in float64 on
the cases of ``tests/test_misc_components.py`` and ``tests/test_amf.py``.
The box air-mass factor is a difference of an extinction and a
single-scatter-albedo gradient scaled by 1 / extinction, and its upper
levels are ill-conditioned: with the JAX test's background absorber the
JAX package's own fast path and generic route differ on it by up to
1.5e-9 at the top, so ``air_mass_factor`` is held level by level to the
larger of 1e-10 and that difference at the level, as the aerosol's own
weighting functions are in ``tests/test_torch_scatterer.py``. In pure
Rayleigh the albedo sits on the solvers' ceiling and the AMF is
ill-posed at every level (the JAX routes differ by up to 1.0e-4): there
it is only required finite and positive, and every other output is held
at 1e-10. The port's own AMF is held to a finite difference of ln I at
5e-3 as ``tests/test_amf.py`` holds the JAX package's. The JAX side of
each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_misc_constituents.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

WAVELENGTHS = np.array([330.0, 450.0, 600.0])
ALTITUDES = np.linspace(0.0, 100000.0, 20)


def _config(pkg, nstr=4):
    return pkg.Config(
        num_streams=nstr,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
    )


def _geometry(pkg):
    return pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES,
        geometry_type=pkg.GeometryType.PlaneParallel,
    )


def _viewing(pkg):
    viewing = pkg.ViewingGeometry()
    for mu in (0.5, 0.8):
        viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.3, mu, 200000.0))
    return viewing


def _misc_atmosphere(pkg, config, geometry):
    """US76 + Rayleigh + Lambertian with every misc constituent but the
    air-mass factor: a manual absorbing aerosol with an ssa and Legendre
    moments, an O2-O2-like collision-induced absorber, and a tabulated
    solar spectrum interpolated onto the wavelengths."""
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.2)
    rng = np.random.default_rng(6)
    ext = 1e-6 * np.exp(-ALTITUDES / 3000.0)[:, None] * rng.uniform(
        0.8, 1.2, (1, WAVELENGTHS.size))
    ssa = rng.uniform(0.85, 0.95, ALTITUDES.size)
    g = 0.6
    leg = np.array([(2 * ell + 1) * g**ell for ell in range(6)])
    atmo["manual"] = pkg.constituent.ManualOpticalProperties(
        extinction=ext, ssa=ssa, leg_coeff=leg)
    atmo["cia"] = pkg.constituent.CollisionInducedAbsorber(
        np.linspace(300.0, 650.0, 8), 10.0 ** rng.uniform(-58, -56, 8),
        0.2095, 0.2095, "O2", "O2")
    atmo["solar"] = pkg.constituent.SolarIrradiance(
        irradiance=np.linspace(0.8, 1.9, 12),
        wavelengths_nm=np.linspace(300.0, 650.0, 12))
    return atmo


def _arrays(pkg):
    """The atmosphere's optical arrays and every derivative mapping after
    the constituent pipeline, and an air-mass factor's mapping."""
    config, geometry = _config(pkg), _geometry(pkg)
    atmo = _misc_atmosphere(pkg, config, geometry)
    atmo["amf"] = pkg.constituent.AirMassFactor()
    atmo.internal_object()
    s = atmo.storage
    out = {"extinction": np.asarray(s.total_extinction),
           "ssa": np.asarray(s.ssa), "leg_coeff": np.asarray(s.leg_coeff),
           "solar": np.asarray(s.solar_irradiance)}
    for name, m in s.derivative_mappings.items():
        out[name] = {
            "d_extinction": np.asarray(m.d_extinction),
            "d_ssa": np.asarray(m.d_ssa),
            "log_radiance_space": np.array(m.log_radiance_space),
        }
    return out


def test_misc_constituent_arrays_match_jax():
    ref = torch_support.jax_reference(lambda: _arrays(sk), ())
    got = _arrays(skt)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(got[k][kk], vv, err_msg=(k, kk))
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert bool(got["air_mass_factor"]["log_radiance_space"])


def _misc_case(pkg):
    config, geometry = _config(pkg), _geometry(pkg)
    return (config, geometry, _viewing(pkg),
            _misc_atmosphere(pkg, config, geometry))


def test_misc_engine_matches_jax():
    case = _misc_case(sk)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    config, geometry, viewing, atmo = _misc_case(skt)
    got = skt.Engine(config, geometry, viewing,
                     device="cpu").calculate_radiance(atmo)
    assert "wf_manual_extinction" in got.keys()
    torch_support.assert_outputs_match(got, ref)


def _amf_case(pkg, background, extra=None):
    """``tests/test_amf.py``'s case: 4 streams, 20 altitudes, 330 nm, one
    ground-viewing ray, US76 + Rayleigh + Lambertian 0.3 with an
    ``AirMassFactor``, and with ``background`` its weak absorber
    (5e-7 exp(-z / 8 km)); ``extra`` adds an extinction perturbation."""
    config = _config(pkg)
    geometry = _geometry(pkg)
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.0, 0.8, 200000.0))
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=np.array([330.0]))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    atmo["amf"] = pkg.constituent.AirMassFactor()
    if background:
        atmo["background"] = pkg.constituent.ManualOpticalProperties(
            extinction=5e-7 * np.exp(-ALTITUDES / 8000.0))
    if extra is not None:
        atmo["pert"] = pkg.constituent.ManualOpticalProperties(
            extinction=extra)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("background", [True, False])
def test_air_mass_factor_engine_matches_jax(background):
    case = _amf_case(sk, background)
    generic_case = _amf_case(sk, background)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    def jax_generic_side():
        engine = sk.Engine(*generic_case[:3])
        engine._twostream_fast_ok = lambda: False
        return engine, engine.calculate_radiance(generic_case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    generic = torch_support.jax_engine_reference(jax_generic_side,
                                                 generic_case)
    config, geometry, viewing, atmo = _amf_case(skt, background)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    assert set(got.keys()) == set(ref.keys())
    for key in ref.keys():
        a, b = got[key].to_numpy(), ref[key].to_numpy()
        assert got[key].dims == ref[key].dims, key
        assert np.all(np.isfinite(a)), key
        if key != "air_mass_factor":
            assert torch_support.rel_err(a, b) <= 1e-10, (
                key, torch_support.rel_err(a, b))
    amf, ref_amf = got["air_mass_factor"].to_numpy(), ref[
        "air_mass_factor"].to_numpy()
    assert amf.shape == (len(ALTITUDES), 1, 1, 1)
    assert np.all(amf > 0)
    if background:
        # level by level: 1e-10, or the JAX routes' difference where larger
        scale = np.max(np.abs(ref_amf))
        err = np.abs(amf - ref_amf).reshape(len(ALTITUDES), -1).max(1)
        routes = np.abs(generic["air_mass_factor"].to_numpy() - ref_amf
                        ).reshape(len(ALTITUDES), -1).max(1)
        assert np.all(err <= np.maximum(1e-10, routes / scale) * scale), (
            err / scale, routes / scale)


def test_air_mass_factor_vs_finite_difference():
    """The port's box AMF against -d ln I / d tau by finite differences
    of a pure-absorber perturbation (``tests/test_amf.py:62-92``)."""
    config, geometry, viewing, atmo = _amf_case(skt, True)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    out = engine.calculate_radiance(atmo)
    amf = out["air_mass_factor"].to_numpy()
    base_i = float(out["radiance"].to_numpy()[0, 0, 0])
    base_ext = atmo.unscaled_extinction[:, 0].copy()
    widths = np.gradient(ALTITUDES)
    widths[0] /= 2
    widths[-1] /= 2
    for i in (0, 5, 10, len(ALTITUDES) - 1):
        dk = 1e-3 * base_ext[i]
        pert = np.zeros(len(ALTITUDES))
        pert[i] = dk
        _, _, _, atmo_p = _amf_case(skt, True, extra=pert)
        rad_p = float(engine.calculate_radiance(atmo_p)["radiance"]
                      .to_numpy()[0, 0, 0])
        amf_fd = -(np.log(rad_p) - np.log(base_i)) / (dk * widths[i])
        np.testing.assert_allclose(amf[i, 0, 0, 0], amf_fd, rtol=5e-3)


def test_air_mass_factor_float32_call_warns():
    """A float32 call that asks for box AMFs (a log-radiance-space
    mapping) warns and stays in float32; a float64 one, or one without
    box AMFs, does not warn."""
    import warnings

    import torch

    cases = [(_amf_case(skt, True), torch.float32, True),
             (_amf_case(skt, True), torch.float64, False),
             (_misc_case(skt), torch.float32, False)]
    for (config, geometry, viewing, atmo), dtype, warns in cases:
        engine = skt.Engine(config, geometry, viewing, device="cpu")
        engine._dtype = dtype
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = engine.calculate_radiance(atmo)
        hits = [w for w in caught if "ill-conditioned in float32"
                in str(w.message)]
        assert len(hits) == (1 if warns else 0), (dtype, caught)
        assert out["radiance"].to_numpy().dtype == (
            np.float32 if dtype == torch.float32 else np.float64)
