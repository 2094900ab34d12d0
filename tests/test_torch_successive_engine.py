"""The port's ``Engine`` with successive orders against ``sasktran2_tpu.
Engine``, in float64 on the CPU: each package builds its own config,
geometry, viewing geometry and US76 + Rayleigh + Lambertian atmosphere
from the same numpy inputs, and radiance and every ``wf_*`` agree to
1e-10 of each variable's largest magnitude (per Stokes component for a
polarized engine), on 12 altitudes (0-60 km, spherical), 4 streams, a
6 x 6 direction grid and 8 iterations:

* scalar, nadir and limb rays in one engine;
* DO-initialised (``init_successive_orders_with_discrete_ordinates``);
* the SZA grid (3 profiles) at a high solar zenith angle;
* refracted internal rays (``multiple_scatter_refraction``);
* a bright (albedo 0.8) surface;
* polarized limb and nadir rays, where U's sign is the test.

Both engines take the generic route (no fast path runs successive
orders). The JAX side of every case is read from
``sasktran2_tpu_torch/data/golden_test_torch_successive_engine.npz``
(``tests/torch_support.py``; its engine compiles took 4-21 s each cold).
"""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

ALTITUDES = np.linspace(0.0, 60000.0, 12)
WAVELENGTHS = np.array([350.0, 500.0])
N_INDEX = 1.0 + 2.8e-4 * np.exp(-ALTITUDES / 8000.0)

# name -> (config overrides, cos_sza, rays as (class name, arguments),
# albedo, with a refractive index)
CASES = {
    "scalar": ({}, 0.6, [
        ("GroundViewingSolar", (0.6, 0.5, 0.8, 200000.0)),
        ("TangentAltitudeSolar", (20000.0, 0.4, 200000.0, 0.6)),
        ("TangentAltitudeSolar", (40000.0, 2.0, 200000.0, 0.6)),
    ], 0.3, False),
    "doinit": ({"init_successive_orders_with_discrete_ordinates": True}, 0.6, [
        ("GroundViewingSolar", (0.6, 0.5, 0.8, 200000.0)),
        ("TangentAltitudeSolar", (20000.0, 0.4, 200000.0, 0.6)),
    ], 0.3, False),
    "sza_grid": ({"num_successive_orders_sza": 3}, 0.15, [
        ("TangentAltitudeSolar", (20000.0, 0.6, 200000.0, 0.15)),
    ], 0.0, False),
    "refraction": ({"multiple_scatter_refraction": True}, 0.7, [
        ("GroundViewingSolar", (0.7, 0.4, 0.3, 200000.0)),
    ], 0.3, True),
    "reflective": ({}, 0.7, [
        ("GroundViewingSolar", (0.7, 0.4, 0.8, 200000.0)),
        ("TangentAltitudeSolar", (10000.0, 1.0, 200000.0, 0.7)),
    ], 0.8, False),
    "polarized": ({"num_stokes": 3}, 0.6, [
        ("TangentAltitudeSolar", (20000.0, 0.4, 200000.0, 0.6)),
        ("TangentAltitudeSolar", (35000.0, 1.2, 200000.0, 0.6)),
        ("GroundViewingSolar", (0.6, 2.0, 0.7, 200000.0)),
    ], 0.3, False),
}


def so_case(pkg, name):
    """(config, geometry, viewing, atmosphere) of one case, built with
    ``pkg`` (the JAX package or the port)."""
    kw, cos_sza, rays, albedo, refracted = CASES[name]
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.SuccessiveOrders,
        single_scatter_source=pkg.SingleScatterSource.Exact,
        num_singlescatter_moments=4,
        num_successive_orders_iterations=8,
        num_successive_orders_incoming=36,
        **kw,
    )
    geometry = pkg.Geometry1D(
        cos_sza=cos_sza, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=ALTITUDES, geometry_type=pkg.GeometryType.Spherical,
    )
    if refracted:
        geometry.refractive_index = N_INDEX
    viewing = pkg.ViewingGeometry()
    for cls, args in rays:
        viewing.add_ray(getattr(pkg, cls)(*args))
    atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS)
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo["surface"] = pkg.constituent.LambertianSurface(albedo)
    return config, geometry, viewing, atmo


@pytest.mark.parametrize("name", list(CASES))
def test_successive_orders_engine_matches_jax(name):
    case = so_case(sk, name)

    def jax_side():
        engine = sk.Engine(*case[:3])
        return engine, engine.calculate_radiance(case[3])

    ref = torch_support.jax_engine_reference(jax_side, case)
    config, geometry, viewing, atmo = so_case(skt, name)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    got = engine.calculate_radiance(atmo)
    assert not engine._fast_route
    assert engine._twostream_fast_ok() == ref.extra["twostream_fast_ok"]
    assert engine._polarized_fast_ok() == ref.extra["polarized_fast_ok"]
    torch_support.assert_outputs_match(got, ref)
    assert sum(k.startswith("wf_") for k in ref.keys()) >= 3
    rad = got["radiance"].to_numpy()
    assert np.all(rad[..., 0] > 0.0)
    if name == "polarized":
        # U is odd in azimuth: it is the component that flips sign if the
        # direction grid's azimuth convention is mixed up
        u = rad[..., 2]
        assert np.max(np.abs(u)) > 1e-3 * np.max(rad[..., 0])
        u_ref = ref["radiance"].to_numpy()[..., 2]
        assert np.all(np.sign(u) == np.sign(u_ref))
