"""``Engine.calculate_radiance(atmosphere, mesh=)`` and the port's
``parallel`` module, on the CPU.

* ``make_mesh``: the mesh's shape and axis names, every visible CUDA
  device by default (none here: it raises), and a mesh that does not fit
  its devices refused.
* ``shard_core_wavelength`` / ``shard_core``: W = 8 and W = 11 over 8
  devices, the blocks as equal as they can be (11: 2, 2, 2, 1, 1, 1, 1,
  1) and in wavelength order, no padding; ``shard_core`` splits only the
  wavelength-leading keys of the JAX package's spec and copies the rest;
  ``sharded_radiance_fn`` runs a function per block and concatenates its
  results in wavelength order.
* The engine: the two-stream case of ``tests/test_mesh_api.py``
  (W = 8 and 11) split over 8 "cpu" devices equals the whole call to
  1e-12 and the JAX package's engine to 1e-10 of each variable's largest
  magnitude; so do, against the port's whole call, a 2D limb scan and a
  successive-orders limb scan (whose transport plans are kept once per
  device) split over three.

The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_mesh.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch import scenarios
from sasktran2_tpu_torch.parallel import (
    make_mesh,
    shard_core,
    shard_core_wavelength,
    sharded_radiance_fn,
)
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

CPU8 = ["cpu"] * 8


def test_make_mesh_shapes(monkeypatch):
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"wavelength": 8, "los": 1}
    assert mesh.axis_names == ("wavelength", "los")
    assert mesh.wavelength_devices == [torch.device("cpu")] * 8
    mesh = make_mesh(n_wavelength=3, n_los=2, devices=CPU8)
    assert mesh.shape == {"wavelength": 3, "los": 2}
    assert len(mesh.wavelength_devices) == 3
    assert make_mesh(n_los=2, devices=CPU8).shape == {"wavelength": 4,
                                                      "los": 2}
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(n_wavelength=5, n_los=2, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize(("W", "sizes"), [(8, [1] * 8),
                                          (11, [2, 2, 2, 1, 1, 1, 1, 1]),
                                          (3, [1, 1, 1])])
def test_shard_core_wavelength_blocks(W, sizes):
    rng = np.random.default_rng(W)
    core = {
        "extinction": torch.tensor(rng.uniform(size=(W, 5))),
        "leg_coeff": rng.uniform(size=(W, 5, 3)),
        "albedo": torch.tensor(rng.uniform(size=W)),
    }
    blocks, W_in = shard_core_wavelength(core, make_mesh(devices=CPU8))
    assert W_in == W
    assert [b["albedo"].shape[0] for b in blocks] == sizes
    for k, v in core.items():
        whole = torch.cat([b[k] for b in blocks]).numpy()
        np.testing.assert_array_equal(whole, np.asarray(v), err_msg=k)
        assert all(isinstance(b[k], torch.Tensor) for b in blocks)


def test_shard_core_replicates_the_rest():
    W = 11
    core = {"extinction": torch.arange(W * 2.0).reshape(W, 2),
            "albedo": torch.arange(float(W)),
            "brdf_args": torch.arange(W * 3.0).reshape(W, 3)}
    blocks = shard_core(core, make_mesh(devices=CPU8))
    assert [b["extinction"].shape[0] for b in blocks] == [2, 2, 2, 1, 1, 1,
                                                          1, 1]
    for b in blocks:
        torch.testing.assert_close(b["brdf_args"], core["brdf_args"])


def test_sharded_radiance_fn_order():
    def fn(core):
        x = core["extinction"]
        return [2.0 * x, x.sum(1)]

    core = {"extinction": torch.arange(22.0).reshape(11, 2)}
    out = sharded_radiance_fn(fn, make_mesh(devices=CPU8))(core)
    torch.testing.assert_close(out[0], 2.0 * core["extinction"])
    torch.testing.assert_close(out[1], core["extinction"].sum(1))
    single = sharded_radiance_fn(lambda c: c["extinction"] + 1.0,
                                 make_mesh(devices=CPU8))(core)
    torch.testing.assert_close(single, core["extinction"] + 1.0)


def _setup(pkg, W):
    """``tests/test_mesh_api.py``'s case at W wavelengths."""
    config = pkg.Config(
        num_streams=2,
        multiple_scatter_source=pkg.MultipleScatterSource.TwoStream,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0, 60000, 11),
        geometry_type=pkg.GeometryType.PlaneParallel,
    )
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.GroundViewingSolar(0.6, 0.3, 0.8, 2e5))
    atmo = pkg.Atmosphere(geometry, config,
                          wavelengths_nm=np.linspace(300.0, 700.0, W))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    return config, geometry, viewing, atmo


def _assert_same(got, ref, tol=1e-12):
    assert set(got.keys()) == set(ref.keys())
    for key in ref.keys():
        assert got[key].dims == ref[key].dims, key
        a, b = got[key].to_numpy(), ref[key].to_numpy()
        assert a.shape == b.shape, key
        assert torch_support.rel_err(a, b) <= tol, (
            key, torch_support.rel_err(a, b))


@pytest.mark.parametrize("W", [8, 11])
def test_mesh_split_matches_whole_and_jax(W):
    ref_case = _setup(sk, W)

    def jax_side():
        engine = sk.Engine(*ref_case[:3])
        return engine, engine.calculate_radiance(ref_case[3])

    ref = torch_support.jax_engine_reference(jax_side, ref_case)
    config, geometry, viewing, atmo = _setup(skt, W)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    whole = engine.calculate_radiance(atmo)
    split = engine.calculate_radiance(atmo, mesh=make_mesh(devices=CPU8))
    _assert_same(split, whole)
    torch_support.assert_outputs_match(split, ref)
    np.testing.assert_array_equal(split.coords["wavelength"],
                                  atmo.wavelengths_nm)


def _so_case(pkg):
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.SuccessiveOrders,
        num_successive_orders_incoming=16,
        num_successive_orders_iterations=4,
        single_scatter_source=pkg.SingleScatterSource.Exact,
    )
    geometry = pkg.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 6),
        geometry_type=pkg.GeometryType.Spherical,
    )
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.TangentAltitudeSolar(30000.0, 0.3, 200000.0, 0.6))
    atmo = pkg.Atmosphere(geometry, config,
                          wavelengths_nm=np.linspace(350.0, 650.0, 5))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(0.3)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", ["2d", "so"])
def test_mesh_split_of_2d_and_so(name):
    if name == "2d":
        case = scenarios.tomo2d_case(
            skt, "float64", np.array([300.0, 450.0, 600.0, 750.0]),
            num_altitudes=11, angles_deg=np.linspace(-20.0, 20.0, 5))
    else:
        case = _so_case(skt)
    engine = skt.Engine(*case[:3], device="cpu")
    whole = engine.calculate_radiance(case[3])
    split = engine.calculate_radiance(
        case[3], mesh=make_mesh(devices=["cpu"] * 3))
    _assert_same(split, whole)
    if name == "so":
        assert [k for k in engine._lazy.keys() if k[0] == "so_plans"] == [
            ("so_plans", torch.device("cpu"))]


def test_shared_state_under_threads():
    """What the ``mesh=`` threads share: a launch count (here the torch-op
    block-Thomas count, which the CPU increments under the same lock as the
    kernels' counts) loses no update, and a 2D operator set is built once
    per (device, dtype) however many threads ask for it at once; with a
    switch interval short enough to interleave them."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from sasktran2_tpu_torch.ops import lanes
    from sasktran2_tpu_torch.rt import raytrace2d, singlescatter

    K, calls, threads = 26, 30, 16
    rng = np.random.default_rng(1)
    di = torch.tensor(rng.normal(size=(2, K, K, 1))) + 8.0 * torch.eye(
        K, dtype=torch.float64)[..., None]
    lo, up = 0.1 * di.clone(), 0.1 * di.clone()
    r = torch.tensor(rng.normal(size=(2, K, 1)))
    rays = singlescatter.Rays2D(raytrace2d.trace_2d(
        np.linspace(0.0, 60000.0, 4), np.linspace(-0.2, 0.2, 3), 6372000.0,
        0.6, [skt.TangentAltitude(10000.0, 2e5)]))

    def work(_):
        for _ in range(calls):
            lanes._thomas_batched(lo, di, up, r)
        return rays.on("cpu", torch.float64)

    before = lanes.TORCH_OP_THOMAS_CALLS_BY_K.get(K, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            futures = [pool.submit(work, i) for i in range(threads)]
            ops = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert lanes.TORCH_OP_THOMAS_CALLS_BY_K[K] - before == threads * calls
    assert all(o is ops[0] for o in ops)
