"""The port's native-grid 2D constituents (``VMRAbsorber2D``,
``NumberDensityScatterer2D``, ``ExtinctionScatterer2D``) and 2D
atmosphere storage against the JAX package's, in float64 on the CPU.

* The constituent pipeline (numpy in both packages): the core arrays on
  the flattened (angle, altitude) locations and every derivative mapping
  (``*_location``) equal, for each constituent over US76 (tiled per
  location) and Rayleigh; ``params.atmosphere_from_reference`` carries a
  2D atmosphere over with its mappings.
* The checks of ``tests/test_constituents2d.py``: the absorber's
  extinction, and the refusals (a field of the wrong rank or shape, a
  1D atmosphere) with the JAX package's exceptions and messages.
* Engine level, radiance, ``los_optical_depth`` and every ``wf_*`` to
  1e-10 of each variable's largest magnitude: the horizontally uniform
  absorber's transmission of ``test_constituents2d.py`` (with weighting
  functions), single scatter over an ``ExtinctionScatterer2D``, and a
  small tomo2d (``scenarios.tomo2d_case`` cut to 21 altitudes by 9
  horizontal angles and 3 wavelengths: Rayleigh, the 2D aerosol and the
  2D absorber, 40 limb rays in 4 images).

The JAX side of the engine cases is read from
``sasktran2_tpu_torch/data/golden_test_torch_constituents2d.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch import scenarios
from sasktran2_tpu_torch.params import atmosphere_from_reference
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

RE = 6372000.0


class _FlatXS:
    """Constant cross-section optical property."""

    def __init__(self, xs):
        self.xs = xs

    def cross_sections(self, wavelengths_nm, altitudes_m=None, **kwargs):
        W = len(np.atleast_1d(wavelengths_nm))
        A = len(np.atleast_1d(altitudes_m))
        return np.full((A, W), self.xs)


def _setup2d(pkg, nh=5, nalt=9, ss=False):
    config = pkg.Config(
        single_scatter_source=(pkg.SingleScatterSource.Exact if ss
                               else pkg.SingleScatterSource.NoSource),
        multiple_scatter_source=pkg.MultipleScatterSource.NoSource,
        occultation_source=(pkg.OccultationSource.NoSource if ss
                            else pkg.OccultationSource.Standard),
        output_los_optical_depth=True,
        num_streams=2,
        num_singlescatter_moments=4,
    )
    geometry = pkg.Geometry2D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=RE,
        altitude_grid_m=np.linspace(0, 80000, nalt),
        horizontal_angle_grid_radians=np.linspace(-0.5, 0.5, nh),
    )
    viewing = pkg.ViewingGeometry()
    viewing.add_ray(pkg.TangentAltitude(20000.0, 2e5, 0.0, 0.0))
    if ss:
        viewing.add_ray(pkg.TangentAltitude(35000.0, 2e5, 0.2, 0.0))
    return config, geometry, viewing


def _constituent(pkg, name, nh, nalt):
    if name == "vmr2d":
        vmr = np.outer(np.linspace(0.5, 1.5, nh), np.full(nalt, 1e-6))
        return pkg.constituent.VMRAbsorber2D(_FlatXS(1e-25), vmr)
    hg = pkg.constituent.HGScatteringOptical(xs_total=1e-13, ssa=0.9, g=0.5,
                                             nleg=4)
    if name == "numden2d":
        nd = np.outer(np.linspace(1.0, 2.0, nh), np.full(nalt, 1e7))
        return pkg.constituent.NumberDensityScatterer2D(hg, nd)
    ext = np.outer(np.linspace(1.0, 2.0, nh),
                   1e-5 * np.exp(-np.linspace(0, 80000, nalt) / 8000.0))
    return pkg.constituent.ExtinctionScatterer2D(hg, ext, 550.0)


def _atmosphere(pkg, name, nh=5, nalt=9, ss=False, wavelengths=(550.0, 600.0)):
    config, geometry, viewing = _setup2d(pkg, nh, nalt, ss)
    atmo = pkg.Atmosphere(geometry, config,
                          wavelengths_nm=np.array(wavelengths))
    pkg.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo.pressure_pa = np.tile(atmo.pressure_pa, nh)
    atmo.temperature_k = np.tile(atmo.temperature_k, nh)
    atmo["rayleigh"] = pkg.constituent.Rayleigh()
    atmo[name] = _constituent(pkg, name, nh, nalt)
    return config, geometry, viewing, atmo


def _assert_atmospheres_equal(got, ref):
    ref_core, got_core = ref.internal_object(), got.internal_object()
    assert set(got_core) == set(ref_core)
    for k, v in ref_core.items():
        np.testing.assert_array_equal(got_core[k], v, err_msg=k)
    ref_maps = ref.storage.derivative_mappings
    got_maps = got.storage.derivative_mappings
    assert set(got_maps) == set(ref_maps)
    for name, m in ref_maps.items():
        for field in ("d_extinction", "d_ssa", "d_emission", "d_leg_coeff",
                      "scat_factor", "interpolator", "interp_dim",
                      "assign_name", "log_radiance_space"):
            a, b = getattr(got_maps[name], field), getattr(m, field)
            if b is None:
                assert a is None, (name, field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {field}")


CONSTITUENTS = ["vmr2d", "numden2d", "ext2d"]


@pytest.mark.parametrize("name", CONSTITUENTS)
def test_2d_constituent_pipeline_equal(name):
    got = _atmosphere(skt, name)[3]
    ref = _atmosphere(sk, name)[3]
    _assert_atmospheres_equal(got, ref)
    nloc = 5 * 9
    assert got.storage.total_extinction.shape == (nloc, 2)
    assert got.storage.derivative_mappings[f"wf_{name}"].interp_dim == (
        f"{name}_location")


@pytest.mark.parametrize("name", CONSTITUENTS)
def test_atmosphere_from_reference_2d(name):
    """A 2D atmosphere carried into the port keeps its core arrays and
    its ``*_location`` mappings."""
    ref = _atmosphere(sk, name)[3]
    ref.internal_object()
    config, geometry, _ = _setup2d(skt)
    got = atmosphere_from_reference(ref, geometry, config)
    _assert_atmospheres_equal(got, ref)
    assert not np.shares_memory(got.storage.total_extinction,
                                ref.storage.total_extinction)


def test_vmr_absorber_2d_extinction():
    """``tests/test_constituents2d.py::test_vmr_absorber_2d_extinction`` on
    the port: the extinction is vmr x N_air x xs per location."""
    config, geometry, _ = _setup2d(skt)
    nh, nalt = geometry.num_horizontal, geometry.num_altitudes
    atmo = skt.Atmosphere(geometry, config,
                          wavelengths_nm=np.array([550.0, 600.0]))
    alts = geometry.altitudes()
    atmo.pressure_pa = 101325.0 * np.exp(-alts / 8000.0)
    atmo.temperature_k = np.full(nalt, 250.0)
    vmr = np.outer(np.linspace(0.5, 1.5, nh), np.full(nalt, 1e-6))
    atmo["gas"] = skt.constituent.VMRAbsorber2D(_FlatXS(1e-25), vmr)
    atmo.internal_object()
    from sasktran2_tpu_torch.util.state import EquationOfState

    nd = EquationOfState(atmo.pressure_pa, atmo.temperature_k,
                         None).air_numberdensity["N"]
    np.testing.assert_allclose(
        atmo.storage.total_extinction[:, 0],
        vmr.ravel() * np.tile(nd, nh) * 1e-25, rtol=1e-12)
    assert "wf_gas" in atmo.storage.derivative_mappings


@pytest.mark.parametrize("case", ["rank", "shape", "geometry1d"])
def test_vmr_absorber_2d_validation(case):
    """The refusals of ``test_constituents2d.py``, in both packages."""
    for pkg in (sk, skt):
        config, geometry, _ = _setup2d(pkg)
        if case == "rank":
            with pytest.raises(ValueError, match="horizontal, altitude"):
                pkg.constituent.VMRAbsorber2D(_FlatXS(1e-25), np.ones(5))
            continue
        if case == "geometry1d":
            geometry = pkg.Geometry1D(0.6, 0.0, RE, np.linspace(0, 80000, 9),
                                      geometry_type=pkg.GeometryType.Spherical)
        atmo = pkg.Atmosphere(geometry, config,
                              wavelengths_nm=np.array([550.0]))
        atmo.pressure_pa = np.full(geometry.num_altitudes, 1e5)
        atmo.temperature_k = np.full(geometry.num_altitudes, 250.0)
        shape = (3, 4) if case == "shape" else (5, 9)
        atmo["gas"] = pkg.constituent.VMRAbsorber2D(
            _FlatXS(1e-25), np.ones(shape) * 1e-6)
        error, match = ((ValueError, "does not match") if case == "shape"
                        else (TypeError, "Geometry2D"))
        with pytest.raises(error, match=match):
            atmo.internal_object()


def _engine_case(pkg, name):
    if name == "uniform_vmr":
        # test_constituents2d.py::test_uniform_2d_vmr_matches_1d_los_od,
        # with weighting functions
        config, geometry, viewing = _setup2d(pkg, nh=11, nalt=17)
        nalt = geometry.num_altitudes
        alts = geometry.altitudes()
        atmo = pkg.Atmosphere(geometry, config,
                              wavelengths_nm=np.array([550.0]))
        atmo.pressure_pa = 101325.0 * np.exp(-alts / 8000.0)
        atmo.temperature_k = np.full(nalt, 250.0)
        vmr2d = np.tile(np.full(nalt, 1e-6), (geometry.num_horizontal, 1))
        atmo["gas"] = pkg.constituent.VMRAbsorber2D(_FlatXS(1e-21), vmr2d)
        return config, geometry, viewing, atmo
    if name == "extinction_scatterer":
        return _atmosphere(pkg, "ext2d", ss=True)
    # a small tomo2d: 21 altitudes x 9 angles, 3 wavelengths
    return scenarios.tomo2d_case(
        pkg, "float64", np.array([300.0, 450.0, 600.0]), num_altitudes=21,
        angles_deg=np.linspace(-20.0, 20.0, 9))


@pytest.mark.parametrize("name", ["uniform_vmr", "extinction_scatterer",
                                  "tomo2d_small"])
def test_engine_2d_constituents_match_jax(name):
    ref_case = _engine_case(sk, name)

    def jax_side():
        engine = sk.Engine(*ref_case[:3])
        return engine, engine.calculate_radiance(ref_case[3])

    ref = torch_support.jax_engine_reference(jax_side, ref_case)
    config, geometry, viewing, atmo = _engine_case(skt, name)
    got = skt.Engine(config, geometry, viewing,
                     device="cpu").calculate_radiance(atmo)
    torch_support.assert_outputs_match(got, ref)
    if name == "tomo2d_small":
        assert got["wf_aero"].to_numpy().shape == (21 * 9, 3, 40, 1)
        assert got["wf_aero"].dims[0] == "aero_location"
