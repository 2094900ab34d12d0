"""The port's two-stream solver (``rt/twostream.py``) and its nstr = 2
engine path against the JAX package, in float64 on the CPU.

``solve_twostream``: radiance, and the gradients of a random functional of
it with respect to dtau, omega, beta and albedo, to 1e-10 of their largest
magnitude, at W = 8 wavelengths and P = 20 layers (the cases of
``tests/test_twostream.py``: both solar zeniths with up- and downwelling
users, and a chapman matrix with a solar spectrum f0). The engine:
radiance and every ``wf_*`` to 1e-10 of each variable's largest magnitude,
with ``MultipleScatterSource.TwoStream`` in plane-parallel geometry and
DO at nstr = 2 in pseudo-spherical geometry, 14 altitudes, 3 wavelengths,
two ground-viewing rays.

The JAX side of the parity tests is read from
``sasktran2_tpu_torch/data/golden_test_torch_twostream.npz``
(``tests/torch_support.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu.rt import twostream as twostream_ref
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import twostream
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401


def _rel_err(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _inputs(W=8, P=20, L=6, seed=0):
    rng = np.random.default_rng(seed)
    dtau = rng.uniform(0.01, 0.4, (P, W))
    omega = rng.uniform(0.2, 0.95, (P, W))
    g = rng.uniform(0.0, 0.8, (P, W))
    ls = np.arange(L)[:, None, None]
    beta = (2 * ls + 1) * g[None] ** ls
    albedo = rng.uniform(0.0, 0.9, W)
    return dtau, omega, beta, albedo


# name -> (mu0, user_mu, user_up, user_azimuth, chapman, f0, seed)
SOLVER_CASES = {
    "mu0_0.6_up": (0.6, [0.7, 0.3], [True, True], [0.0, 1.2], False, False, 0),
    "mu0_0.35_down": (0.35, [0.7, 0.3], [False, False], [0.0, 1.2], False,
                      False, 0),
    "chapman_f0": (0.5, [0.6], [True], [0.0], True, True, 5),
}


@pytest.mark.parametrize("name", list(SOLVER_CASES))
def test_solve_twostream_and_gradients(name):
    mu0, user_mu, user_up, user_azi, chapman, f0, seed = SOLVER_CASES[name]
    inputs = _inputs(seed=seed)
    P, W = inputs[0].shape
    tables_ref = disco_ref.build_mode_tables(
        2, inputs[2].shape[0], mu0, np.array(user_mu), num_azimuth=2)
    tables = mode_tables_from_reference(tables_ref)
    rng = np.random.default_rng(11)
    kw = {
        "chapman": np.tril(rng.uniform(1.5, 2.5, (P, P))) if chapman
        else None,
        "f0": rng.uniform(0.5, 2.0, W) if f0 else None,
    }
    user_up, user_azi = np.array(user_up), np.array(user_azi)

    def ref_fn(*args):
        return twostream_ref.solve_twostream(
            *args, tables_ref, user_up, user_azi,
            chapman=kw["chapman"],
            f0=None if kw["f0"] is None else jnp.asarray(kw["f0"]),
        )

    (ref,), ref_grads = torch_support.jax_vjp_reference(
        ref_fn, inputs,
        lambda outs: [np.random.default_rng(1).normal(size=outs[0].shape)])
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = twostream.solve_twostream(
        *ts, tables, user_up, user_azi, chapman=kw["chapman"],
        f0=None if kw["f0"] is None else torch.tensor(kw["f0"]),
    )
    assert out.shape == ref.shape == (len(user_mu), W)
    assert _rel_err(out.detach().numpy(), ref) <= 1e-10
    ct = np.random.default_rng(1).normal(size=ref.shape)
    grads = torch.autograd.grad(out, ts, grad_outputs=torch.tensor(ct))
    for k, g, rg in zip(("dtau", "omega", "beta", "albedo"), grads,
                        ref_grads):
        assert _rel_err(g.numpy(), np.asarray(rg)) <= 1e-10, k


def _engine_case(pkg, ms, geometry_type, ref_atmo=None):
    config = pkg.Config(
        num_streams=2,
        multiple_scatter_source=getattr(pkg.MultipleScatterSource, ms),
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0, 60000, 14),
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.3, 0.8, 2e5))
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 1.1, 0.5, 2e5))
    if ref_atmo is not None:
        return config, geometry, viewing, torch_support.carry_atmosphere(
            ref_atmo, geometry, config)
    atmo = pkg.Atmosphere(geometry, config,
                          wavelengths_nm=np.array([310.0, 400.0, 550.0]))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface([0.1, 0.3, 0.2])
    return config, geometry, viewing, atmo


@pytest.mark.parametrize(("ms", "geometry_type"), [
    ("TwoStream", "PlaneParallel"),
    ("DiscreteOrdinates", "PseudoSpherical"),
])
def test_engine_twostream_matches_jax(ms, geometry_type):
    config, geometry, viewing, atmo = _engine_case(sk, ms, geometry_type)

    def jax_side():
        engine = sk.Engine(config, geometry, viewing)
        return engine, engine.calculate_radiance(atmo)

    ref = torch_support.jax_engine_reference(
        jax_side, (config, geometry, viewing, atmo))
    config, geometry, viewing, atmo_t = _engine_case(
        skt, ms, geometry_type, atmo)
    got = skt.Engine(config, geometry, viewing, device="cpu")\
        .calculate_radiance(atmo_t)
    assert set(got.keys()) == set(ref.keys())
    assert len([k for k in ref.keys() if k.startswith("wf_")]) == 3
    for key in ref.keys():
        a, b = got[key].to_numpy(), ref[key].to_numpy()
        assert a.shape == b.shape, key
        assert _rel_err(a, b) <= 1e-10, (key, _rel_err(a, b))
