"""The PyTorch port's host-side tables and numpy copies, pinned to the JAX
package's originals: DO angular tables, the Jacobi tournament, the
chapman factors, and the US76 / Rayleigh / Lambertian atmosphere."""

import numpy as np
import pytest
import torch

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu.climatology import us76 as us76_ref
from sasktran2_tpu.ops import eigen as eigen_ref
from sasktran2_tpu.ops import lanes as lanes_ref
from sasktran2_tpu.optical import rayleigh as rayleigh_ref
from sasktran2_tpu.rt import disco as disco_ref
from sasktran2_tpu_torch.device import resolve_dtype
from sasktran2_tpu_torch.ops import eigen
from sasktran2_tpu_torch.params import mode_tables_from_reference
from sasktran2_tpu_torch.rt import disco
from tests.torch_support import one_torch_thread  # noqa: F401


@pytest.mark.parametrize(("nstr", "nleg", "mu0", "user_mu", "num_azimuth"), [
    (4, 4, 0.6, [0.5, 0.9], None),
    (16, 16, 0.35, [0.4, 0.6, 0.8, 1.0], 3),
    (8, 12, 0.8, [0.3], 5),
])
def test_build_mode_tables_equal(nstr, nleg, mu0, user_mu, num_azimuth):
    ref = disco_ref.build_mode_tables(
        nstr, nleg, mu0, np.array(user_mu), num_azimuth=num_azimuth
    )
    got = disco.build_mode_tables(
        nstr, nleg, mu0, np.array(user_mu), num_azimuth=num_azimuth
    )
    carried = mode_tables_from_reference(ref)
    for field in ("lam_stream", "lam_sun", "lam_user", "parity", "mu", "w",
                  "user_mu"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
        np.testing.assert_array_equal(
            getattr(carried, field), getattr(ref, field)
        )
    assert got.mu0 == ref.mu0 == carried.mu0


def test_clamp_constants_equal():
    assert disco.SSA_CEILING == disco_ref.SSA_CEILING
    assert disco.KMIN == disco_ref.KMIN


@pytest.mark.parametrize("n", [2, 4, 8, 16, 24, 32])
def test_tournament_schedule_equal(n):
    assert eigen._tournament_schedule(n) == eigen_ref._tournament_schedule(n)
    for got, ref in zip(eigen.stacked_round_tables(n),
                        lanes_ref._stacked_round_tables(n)):
        np.testing.assert_array_equal(got, ref)


def _ground_case(pkg, geometry_type, solar_refraction=False):
    config = pkg.Config(
        num_streams=4,
        multiple_scatter_source=pkg.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=pkg.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
    )
    config.solar_refraction = solar_refraction
    geometry = pkg.Geometry1D(
        cos_sza=0.3, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 12),
        geometry_type=getattr(pkg.GeometryType, geometry_type),
    )
    viewing = pkg.ViewingGeometry()
    for mu0, muv in ((0.3, 0.7), (0.5, 1.0)):
        viewing.add_ray(pkg.GroundViewingSolar(
            cos_sza=mu0, relative_azimuth=0.2, cos_viewing_zenith=muv,
            observer_altitude_m=200000.0,
        ))
    return config, geometry, viewing


@pytest.mark.parametrize("geometry_type", [
    sk.GeometryType.PlaneParallel,
    sk.GeometryType.PseudoSpherical,
    sk.GeometryType.Spherical,
])
def test_chapman_equal(geometry_type):
    name = geometry_type.name
    ref = sk.Engine(*_ground_case(sk, name))._chapman_cache("float64")
    got = skt.Engine(*_ground_case(skt, name), device="cpu")._chapman
    assert set(got) == set(ref) and len(got) == 2
    for mu0, c in ref.items():
        if c is None:
            assert got[mu0] is None
        else:
            np.testing.assert_array_equal(got[mu0], c)


def test_us76_and_bates_equal():
    z = np.linspace(0.0, 120000.0, 61)
    for got, ref in zip(skt.climatology.us76_pressure_temperature(z),
                        us76_ref.us76_pressure_temperature(z)):
        np.testing.assert_array_equal(got, ref)
    wl_um = np.linspace(0.2, 1.5, 50)
    for got, ref in zip(
        skt.optical.rayleigh.rayleigh_cross_section_bates(wl_um),
        rayleigh_ref.rayleigh_cross_section_bates(wl_um),
    ):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("albedo", [0.3, [0.1, 0.4, 0.2]])
def test_constituent_atmosphere_equal(albedo):
    """The port's constituents on the port's Atmosphere give the
    reference's internal_object() and derivative mappings."""
    wl = np.array([300.0, 450.0, 700.0])
    atmos = []
    for pkg in (sk, skt):
        config, geometry, _ = _ground_case(pkg, "PlaneParallel")
        atmo = pkg.Atmosphere(geometry, config, wavelengths_nm=wl)
        pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
        atmo["rayleigh"] = pkg.constituent.Rayleigh()
        atmo["surface"] = pkg.constituent.LambertianSurface(albedo)
        atmos.append(atmo)
    ref_atmo, got_atmo = atmos
    ref, got = ref_atmo.internal_object(), got_atmo.internal_object()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    ref_maps = ref_atmo.storage.derivative_mappings
    got_maps = got_atmo.storage.derivative_mappings
    assert set(got_maps) == set(ref_maps)
    for name, m in ref_maps.items():
        for field in ("d_extinction", "d_ssa", "d_leg_coeff", "scat_factor"):
            np.testing.assert_array_equal(
                getattr(got_maps[name], field), getattr(m, field)
            )
    for name, m in ref_atmo.surface.derivative_mappings.items():
        np.testing.assert_array_equal(
            got_atmo.surface.derivative_mappings[name].d_brdf, m.d_brdf
        )


def test_dtype_policy():
    assert resolve_dtype("float32", "cpu") == torch.float64
    assert resolve_dtype("float64", "cpu") == torch.float64
    assert resolve_dtype("float32", "cuda") == torch.float32
    assert resolve_dtype("float64", "cuda") == torch.float64
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
