"""The port's flux observers against the JAX package, in float64 on the
CPU, at 4 streams, 13 altitudes and 3 wavelengths, with inputs made from
numpy seeds:

* ``solve_nstream_m0_levels``: the level fields and the beam
  transmissions, and the gradients of a random linear functional of them,
  to 1e-10 of their largest magnitude;
* the engine: radiance, the four flux types and every ``wf_*`` (the flux
  rows included) to 1e-10 of each variable's largest magnitude, on the
  scenarios of ``tests/test_flux.py`` (a Rayleigh-like raw atmosphere with
  black, reflecting and partly absorbing surfaces; observers at the
  ground, inside and at the top of the atmosphere; all four flux types)
  cut to 4 streams and 13 altitudes, plus a spherical US76 + Rayleigh case
  with two solar zenith angles and log-radiance weighting functions.

The JAX side of the parity tests is read from
``sasktran2_tpu_torch/data/golden_test_torch_flux.npz``
(``tests/torch_support.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import disco_nstream as nstream_ref
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import disco_nstream
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

LEVEL_KEYS = ("i_plus_top", "i_minus_top", "i_plus_bot", "i_minus_bot")
WAVELENGTHS = np.array([320.0, 450.0, 600.0])
ALL_TYPES = ("Upwelling", "Downwelling", "Actinic", "Divergence")


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


@pytest.mark.parametrize(("chapman", "include_ss"), [(False, True),
                                                     (True, False)])
def test_solve_nstream_m0_levels(chapman, include_ss):
    P, W, nstr, mu0 = 8, 3, 4, 0.6
    rng = np.random.default_rng(21 + int(chapman))
    dtau = rng.uniform(0.01, 0.5, size=(P, W))
    omega = rng.uniform(0.5, 0.99, size=(P, W))
    g = rng.uniform(0.0, 0.7, size=(P, W))
    beta = (2 * np.arange(nstr)[:, None, None] + 1) * g[None] ** (
        np.arange(nstr)[:, None, None])
    albedo = rng.uniform(0.1, 0.5, size=W)
    inputs = (dtau, omega, beta, albedo)
    f0 = np.array([1.0, 0.8, 1.3])
    chap = (np.tril(np.ones((P, P))) / mu0
            * (1.0 + 0.02 * np.arange(P)[None, :] / P)) if chapman else None
    tables_ref = disco_ref.build_mode_tables(nstr, nstr, mu0, np.array([0.5]),
                                             num_azimuth=1)
    tables = mode_tables_from_reference(tables_ref)
    kw = {"include_ss": include_ss, "chapman": chap}

    def ref_fn(*args):
        lv, t_top, t_ground = nstream_ref.solve_nstream_m0_levels(
            *args, tables_ref, f0=jnp.asarray(f0), **kw)
        return [lv[k] for k in LEVEL_KEYS] + [t_top, t_ground]

    def cotangents(outputs):
        rng = np.random.default_rng(4)
        return [rng.normal(size=np.shape(r)) for r in outputs]

    ref, ref_grads = torch_support.jax_vjp_reference(ref_fn, inputs,
                                                     cotangents)
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    lv, t_top, t_ground = disco_nstream.solve_nstream_m0_levels(
        *ts, tables, f0=torch.tensor(f0), **kw)
    got = [lv[k] for k in LEVEL_KEYS] + [t_top, t_ground]
    for name, a, b in zip(LEVEL_KEYS + ("t_top", "t_ground"), got, ref):
        assert a.shape == b.shape, name
        assert _rel_err(a.detach().numpy(), np.asarray(b)) <= 1e-10, name
    cts = cotangents(ref)
    grads = torch.autograd.grad(
        got, ts, grad_outputs=[torch.tensor(c) for c in cts])
    for name, gr, rg in zip(("dtau", "omega", "beta", "albedo"), grads,
                            ref_grads):
        assert _rel_err(gr.numpy(), np.asarray(rg)) <= 1e-10, name


def test_solve_nstream_m0_levels_refuses_thermal():
    """A thermal source given by only one of its two level arrays is
    refused (the complete source is held against the JAX package in
    ``tests/test_torch_thermal.py``)."""
    P, W = 3, 2
    t = torch.ones((P, W), dtype=torch.float64)
    tables = mode_tables_from_reference(
        disco_ref.build_mode_tables(4, 4, 0.6, np.array([0.5]), num_azimuth=1))
    for kw in ({"thermal_b0": t}, {"thermal_b1_bottom": t}):
        with pytest.raises(ValueError, match="thermal_b0 and thermal_b1"):
            disco_nstream.solve_nstream_m0_levels(
                t, 0.5 * t, torch.ones((4, P, W), dtype=torch.float64),
                torch.ones(W, dtype=torch.float64), tables, **kw)


# --- the engine --------------------------------------------------------------

def _pure_scattering(pkg, config, geometry, ssa, albedo):
    """``sasktran2_tpu.test_util.default_pure_scattering_atmosphere`` at
    three wavelengths: a 7 km scale-height extinction, Rayleigh phase,
    constant ssa and albedo, raw-input weighting functions."""
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS,
                          calculate_derivatives=True)
    alts = geometry.altitudes()
    atmo.storage.total_extinction[:] = (
        7e-5 * np.exp(-alts / 7000.0)[:, None] * np.array([1.0, 0.6, 0.3])
    )
    atmo.storage.ssa[:] = ssa
    atmo.leg_coeff.a1[0] = 1.0
    atmo.leg_coeff.a1[2] = 0.5
    atmo.surface.albedo[:] = albedo
    return atmo


def _rayleigh(pkg, config, geometry, ssa, albedo):
    del ssa
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(albedo)
    return atmo


# name -> (ssa, albedo, flux types, observer (cos_sza, altitude)s,
#          geometry type, single scatter, atmosphere)
CASES = {
    "black_conservative": (
        1.0, 0.0, ("Upwelling", "Downwelling"),
        [(0.6, a) for a in (0.0, 10000.0, 60000.0)], "PlaneParallel",
        "DiscreteOrdinates", _pure_scattering),
    "reflecting": (
        1.0, 1.0, ("Upwelling", "Downwelling"),
        [(0.6, a) for a in (0.0, 10000.0, 60000.0)], "PlaneParallel",
        "DiscreteOrdinates", _pure_scattering),
    "absorbing_all_types": (
        0.7, 0.3, ALL_TYPES,
        [(0.6, a) for a in (19000.0, 20000.0, 21000.0, 0.0)],
        "PlaneParallel", "DiscreteOrdinates", _pure_scattering),
    "spherical_two_sza_rayleigh": (
        None, 0.3, ("Actinic", "Divergence", "Upwelling"),
        [(0.6, 5000.0), (0.3, 30000.0), (0.6, 45000.0), (0.3, 0.0)],
        "Spherical", "Exact", _rayleigh),
}


def _engine_case(pkg, name, ref_atmo=None):
    ssa, albedo, types, observers, gtype, ss, make_atmo = CASES[name]
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=getattr(pkg.SingleScatterSource, ss),
        num_singlescatter_moments=4,
        flux_types=tuple(getattr(pkg.FluxType, t) for t in types),
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 60000.0, 13),
        geometry_type=getattr(pkg.GeometryType, gtype),
    )
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.0, 0.8, 200000.0))
    for cos_sza, alt in observers:
        viewing.add_flux_observer(pkg.FluxObserverSolar(cos_sza, alt))
    if ref_atmo is not None:
        atmo = torch_support.carry_atmosphere(ref_atmo, geometry, config)
    else:
        atmo = make_atmo(pkg, config, geometry, ssa, albedo)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", list(CASES))
def test_engine_flux_matches_jax(name):
    config, geometry, viewing, atmo = _engine_case(sk, name)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    config, geometry, viewing, atmo_t = _engine_case(skt, name, atmo)
    got = skt.Engine(config, geometry, viewing, device="cpu")\
        .calculate_radiance(atmo_t)
    assert set(got.keys()) == set(ref.keys())
    flux_keys = [k for k in ref.keys() if k.endswith("_flux")]
    assert len(flux_keys) == len(CASES[name][2]) * (
        1 + sum(k.startswith("wf_") for k in ref.keys()
                if not k.endswith("_flux")))
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert a.dims == b.dims, key
        a, b = a.to_numpy(), b.to_numpy()
        assert a.shape == b.shape, key
        assert np.all(np.isfinite(a)), key
        assert _rel_err(a, b) <= 1e-10, (key, _rel_err(a, b))


def test_flux_without_do_has_no_flux_outputs():
    """As in the JAX engine, flux observers of an engine with no DO source
    produce no flux variables."""
    config, geometry, viewing, _ = _engine_case(skt, "black_conservative")
    config.multiple_scatter_source = skt.MultipleScatterSource.NoSource
    config.single_scatter_source = skt.SingleScatterSource.Exact
    atmo = _pure_scattering(skt, config, geometry, 0.9, 0.3)
    out = skt.Engine(config, geometry, viewing, device="cpu")\
        .calculate_radiance(atmo)
    assert not [k for k in out.keys() if k.endswith("_flux")]
    assert "wf_extinction" in out.keys()
