"""The port's BRDF surfaces against the JAX package, in float64 on the CPU,
with inputs made from numpy seeds:

* ``rt.disco.brdf_azimuth_moments`` for each of the four kernels
  (Lambertian, Kokhanovsky snow, MODIS, weighted): the moments to 1e-12
  and their gradient with respect to the kernel arguments to 1e-10;
* ``solve_nstream`` over a MODIS BRDF at 2, 4 and 8 streams, every
  azimuth mode: radiance to 1e-10 and the gradients with respect to dtau,
  omega, beta, albedo and the BRDF arguments to 1e-10 of their largest
  magnitude;
* the engine with Jacobians over MODIS, Kokhanovsky and weighted
  surfaces on ground-viewing rays at 2 to 8 streams (nstr = 2 takes the
  N-stream solver, not the two-stream one), from constituents and from a
  raw-input atmosphere carried over by ``params.atmosphere_from_reference``:
  radiance and every ``wf_*`` to 1e-10 of each variable's largest
  magnitude (the cases of ``tests/test_brdf.py``);
* a BRDF turns the azimuth-mode truncation off: the engine's radiance
  differs from the same solve cut to the phase expansion's 3 modes;
* BRDF limb scans, BRDF flux observers, polarized BRDF and a BRDF without
  a DO source take the generic route, as in the JAX package, and match its
  engine at 1e-10.

The JAX side of the parity tests is read from
``sasktran2_tpu_torch/data/golden_test_torch_brdf.npz``
(``tests/torch_support.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu.rt import brdf as brdf_ref
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import disco_nstream as nstream_ref
from sasktran2_tpu_torch.ops.quadrature import streams
from sasktran2_tpu_torch.params import (
    brdf_from_reference,
    mode_tables_from_reference,
)
from sasktran2_tpu_torch.rt import brdf, disco, disco_nstream
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

WAVELENGTHS = np.array([350.0, 500.0, 700.0])
USER_MU = np.array([0.5, 0.9, 0.3])
USER_UP = np.array([True, True, False])
USER_AZI = np.array([0.3, 1.2, 2.5])


def _rel_err(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale > 0 else 1.0)


def _kernel_pair(name):
    """(JAX kernel, port kernel, arguments [W, nargs]) of one kernel."""
    rng = np.random.default_rng(3)
    W = len(WAVELENGTHS)
    modis = np.stack([rng.uniform(0.1, 0.4, W), rng.uniform(0.0, 0.2, W),
                      rng.uniform(0.0, 0.1, W)], axis=-1)
    snow = rng.uniform(0.01, 0.2, size=(W, 1))
    lamb = rng.uniform(0.1, 0.5, size=(W, 1))
    if name == "lambertian":
        return brdf_ref.LambertianKernel(), brdf.LambertianKernel(), lamb
    if name == "snow":
        return (brdf_ref.SnowKokhanovskyKernel(),
                brdf.SnowKokhanovskyKernel(), snow)
    if name == "modis":
        return brdf_ref.MODISKernel(), brdf.MODISKernel(), modis
    weights = rng.uniform(0.2, 0.8, size=(W, 3))
    ref = brdf_ref.WeightedKernel([brdf_ref.SnowKokhanovskyKernel(),
                                   brdf_ref.MODISKernel(),
                                   brdf_ref.LambertianKernel()])
    return ref, brdf_from_reference(ref), np.concatenate(
        [snow, modis, lamb, weights], axis=-1)


@pytest.mark.parametrize("name", ["lambertian", "snow", "modis", "weighted"])
def test_brdf_azimuth_moments_match_jax(name):
    ref_kernel, kernel, args = _kernel_pair(name)
    assert type(kernel).__name__ == type(ref_kernel).__name__
    mu, _ = streams(8)
    mu0, m_idx = 0.6, np.arange(8)

    def ref_fn(a):
        return disco_ref.brdf_azimuth_moments(
            ref_kernel, a, jnp.asarray(mu), jnp.asarray(USER_MU), mu0,
            jnp.asarray(m_idx), jnp.float64)

    ref, vjp = jax.vjp(ref_fn, jnp.asarray(args))
    a_t = torch.tensor(args, requires_grad=True)
    got = disco.brdf_azimuth_moments(
        kernel, a_t, torch.tensor(mu), torch.tensor(USER_MU), mu0, m_idx)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert _rel_err(got[k].detach().numpy(), np.asarray(ref[k])) <= 1e-12
    rng = np.random.default_rng(4)
    cts = {k: rng.normal(size=np.shape(v)) for k, v in ref.items()}
    (ref_grad,) = vjp({k: jnp.asarray(c) for k, c in cts.items()})
    (grad,) = torch.autograd.grad(
        [got[k] for k in ref], a_t,
        grad_outputs=[torch.tensor(cts[k]) for k in ref])
    assert _rel_err(grad.numpy(), np.asarray(ref_grad)) <= 1e-10


def _layer_inputs(P, W, nstr, seed):
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 0.5, size=(P, W))
    omega = rng.uniform(0.5, 0.99, size=(P, W))
    g = rng.uniform(0.0, 0.7, size=(P, W))
    ls = np.arange(max(nstr, 3))[:, None, None]
    beta = (2 * ls + 1) * g[None] ** ls
    albedo = rng.uniform(0.1, 0.5, size=W)
    return dtau, omega, beta, albedo


@pytest.mark.parametrize("nstr", [2, 4, 8])
def test_solve_nstream_brdf_matches_jax(nstr):
    mu0 = 0.6
    tables_ref = disco_ref.build_mode_tables(nstr, nstr, mu0, USER_MU)
    tables = mode_tables_from_reference(tables_ref)
    _, _, args = _kernel_pair("modis")
    inputs = (*_layer_inputs(6, len(WAVELENGTHS), nstr, 10 + nstr), args)
    f0 = np.array([1.0, 0.8, 1.3])

    def ref_fn(dtau, omega, beta, albedo, brdf_args):
        return nstream_ref.solve_nstream(
            dtau, omega, beta, albedo, tables_ref, USER_UP, USER_AZI,
            f0=jnp.asarray(f0), brdf=brdf_ref.MODISKernel(),
            brdf_args=brdf_args)

    (ref,), ref_grads = torch_support.jax_vjp_reference(
        ref_fn, inputs,
        lambda outs: [np.random.default_rng(1).normal(size=outs[0].shape)])
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    got = disco_nstream.solve_nstream(
        *ts[:4], tables, USER_UP, USER_AZI, f0=torch.tensor(f0),
        brdf=brdf.MODISKernel(), brdf_args=ts[4])
    assert got.shape == ref.shape == (3, 3)
    assert _rel_err(got.detach().numpy(), ref) <= 1e-10
    ct = np.random.default_rng(1).normal(size=ref.shape)
    # the Lambertian albedo does not enter under a BRDF: no gradient
    grads = torch.autograd.grad(got, ts, grad_outputs=torch.tensor(ct),
                                allow_unused=True)
    for name, g, rg in zip(("dtau", "omega", "beta", "albedo", "brdf_args"),
                           grads, ref_grads):
        if name == "albedo":
            assert g is None and np.all(np.asarray(rg) == 0.0)
            continue
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, name


# --- the engine --------------------------------------------------------------

def _surface(pkg, name):
    c = pkg.constituent
    if name == "modis":
        return c.MODIS(0.25, 0.15, 0.05)
    if name == "snow":
        return c.SnowKokhanovsky()
    return c.WeightedBRDF({
        "snow": (c.SnowKokhanovsky(), 0.7),
        "soil": (c.MODIS(0.2, 0.1, [0.05, 0.02, 0.08]), [0.3, 0.2, 0.25]),
        "lake": (c.LambertianSurface(0.04), 0.1),
    })


# name -> (nstr, geometry type, surface, atmosphere carried from the
# JAX side's raw state)
CASES = {
    "modis_nstr4_planeparallel": (4, "PlaneParallel", "modis", False),
    "snow_nstr8_pseudospherical": (8, "PseudoSpherical", "snow", False),
    "weighted_nstr4_planeparallel": (4, "PlaneParallel", "weighted", False),
    "modis_nstr2_raw": (2, "PlaneParallel", "modis", True),
}


def _engine_case(pkg, name, ref_atmo=None):
    nstr, geometry_type, surface, _ = CASES[name]
    config = pkg.Config(
        num_streams=nstr,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=max(nstr, 4),
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 11),
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )
    viewing = pkg.ViewingGeometry()
    for mu, azi in ((0.5, 0.5), (0.9, 2.0), (1.0, 0.0)):
        viewing.add_ray(pkg.GroundViewingSolar(0.6, azi, mu, 200000.0))
    if ref_atmo is not None:
        return config, geometry, viewing, torch_support.carry_atmosphere(
            ref_atmo, geometry, config)
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = _surface(pkg, surface)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", list(CASES))
def test_engine_brdf_matches_jax(name):
    config, geometry, viewing, atmo = _engine_case(sk, name)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    carried = CASES[name][3]
    config, geometry, viewing, atmo_t = _engine_case(
        skt, name, ref_atmo=atmo if carried else None)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo_t)
    assert engine._num_azi_eff is None
    assert set(got.keys()) == set(ref.keys())
    assert any(k.startswith("wf_surface") for k in ref.keys())
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert a.dims == b.dims, key
        err = _rel_err(a.to_numpy(), b.to_numpy())
        assert err <= 1e-10, (key, err)


def test_brdf_solves_every_azimuth_mode():
    """Under a BRDF the engine solves all nstr modes: the same engine cut
    to the 3 modes of the Rayleigh phase expansion gives another
    radiance, while a Lambertian surface gives the same radiance both
    ways."""
    results = {}
    for surface in ("modis", "lambertian"):
        config, geometry, viewing, atmo = _engine_case(
            skt, "modis_nstr4_planeparallel")
        if surface == "lambertian":
            atmo["surface"] = skt.constituent.LambertianSurface(0.3)
        atmo.calculate_derivatives = False
        engine = skt.Engine(config, geometry, viewing, device="cpu")
        full = engine.calculate_radiance(atmo)["radiance"].to_numpy()
        engine._effective_num_azimuth = lambda core_np: 3
        cut = engine.calculate_radiance(atmo)["radiance"].to_numpy()
        results[surface] = _rel_err(cut, full)
    assert results["modis"] > 1e-4
    assert results["lambertian"] <= 1e-13


def _limb_viewing(pkg):
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.TangentAltitudeSolar(20000.0, 0.0, 200000.0, 0.6))
    return viewing


def _ground_viewing(pkg, flux=False):
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    if flux:
        viewing.add_flux_observer(pkg.FluxObserverSolar(0.6, 10000.0))
    return viewing


def _outside_case(pkg, case, ref_atmo=None):
    """A MODIS surface where the JAX package takes its generic route: a
    limb ray, a flux observer, polarized radiance, no DO source."""
    ms = (pkg.MultipleScatterSource.NoSource if case == "no_do"
          else pkg.MultipleScatterSource.DiscreteOrdinates)
    ss = (pkg.SingleScatterSource.Exact if case == "no_do"
          else pkg.SingleScatterSource.DiscreteOrdinates)
    config = pkg.Config(
        num_streams=4, num_stokes=3 if case == "polarized" else 1,
        multiple_scatter_source=ms, single_scatter_source=ss,
        num_singlescatter_moments=4,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 6),
        geometry_type=pkg.GeometryType.Spherical,
    )
    viewing = (_limb_viewing(pkg) if case == "limb"
               else _ground_viewing(pkg, flux=case == "flux"))
    if ref_atmo is not None:
        return config, geometry, viewing, torch_support.carry_atmosphere(
            ref_atmo, geometry, config)
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=np.array([500.0]))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.MODIS(0.25, 0.15, 0.05)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("case", ["limb", "flux", "polarized", "no_do"])
def test_brdf_outside_the_fast_path_matches_jax(case):
    """The configurations the JAX package sends to its generic route take
    the port's generic route too, with the reference's behaviour: the
    BRDF reaches only ground-viewing DO groups, so a limb scan, the flux
    solve and exact single scatter see the core albedo (0 under MODIS),
    and every output matches at 1e-10."""
    config, geometry, viewing, atmo = _outside_case(sk, case)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    config, geometry, viewing, atmo_t = _outside_case(skt, case, atmo)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo_t)
    assert not engine._fast_route
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    assert engine._polarized_fast_ok() == ref.extra["polarized_fast_ok"]
    assert set(got.keys()) == set(ref.keys())
    assert any(k.startswith("wf_surface") for k in ref.keys())
    for key in ref.keys():
        a, b = got[key], ref[key]
        assert a.dims == b.dims, key
        err = _rel_err(a.to_numpy(), b.to_numpy())
        assert err <= 1e-10, (key, err)


def test_brdf_from_reference_maps_every_kernel():
    """Every JAX-side kernel class maps to the port's class of the same
    name, a weighted kernel member by member; an unknown class raises."""
    ref = brdf_ref.WeightedKernel([
        brdf_ref.WeightedKernel([brdf_ref.LambertianKernel()]),
        brdf_ref.SnowKokhanovskyKernel(), brdf_ref.MODISKernel(),
    ])
    got = brdf_from_reference(ref)
    assert isinstance(got, brdf.WeightedKernel)
    assert [type(k) for k in got.kernels] == [
        brdf.WeightedKernel, brdf.SnowKokhanovskyKernel, brdf.MODISKernel]
    assert isinstance(got.kernels[0].kernels[0], brdf.LambertianKernel)
    assert got.num_args == ref.num_args == 9
    with pytest.raises(NotImplementedError, match="no BRDF kernel"):
        brdf_from_reference(object())
