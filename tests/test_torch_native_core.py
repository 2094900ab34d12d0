"""The engine's handoff from the atmosphere, on the CPU in float64.

``Engine.calculate_radiance`` takes the storage's arrays as they lie
(``Atmosphere.internal_object(native=True)``) and makes the
wavelength-leading tensors on the device (``params.upload_core``). Here,
in each configuration whose storage differs in kind (scalar, polarized
with its interleaved greeks, ``Geometry2D``'s one row per location, the
integrated line shape's reduced storage, delta-m's replaced arrays, a BRDF's
arguments):

* the tensors a call hands ``Engine._compute`` equal, key by key, bit for
  bit, with the same dtypes, shapes and strides, what
  ``params.core_from_reference`` makes of the wavelength-leading dict that
  ``Atmosphere.internal_object()`` returns;
* the radiance and every ``wf_*`` equal, bit for bit, those of the same
  engine fed the host's wavelength-leading copies;
* the call's tensors own their memory: writing into the atmosphere's
  storage and surface after the call leaves them as they were.
"""

import numpy as np
import pytest
import torch

import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch import engine as engine_module
from sasktran2_tpu_torch.atmosphere import wavelength_leading
from sasktran2_tpu_torch.params import core_from_reference
from tests.torch_support import one_torch_thread  # noqa: F401

ALTITUDES = np.linspace(0.0, 60000.0, 13)
WAVELENGTHS = np.linspace(300.0, 600.0, 6)
RE = 6372000.0


def _config(**kw):
    base = {
        "num_streams": 4,
        "multiple_scatter_source": skt.MultipleScatterSource.DiscreteOrdinates,
        "single_scatter_source": skt.SingleScatterSource.DiscreteOrdinates,
        "num_singlescatter_moments": 4,
        "dtype": "float64",
    }
    return skt.Config(**{**base, **kw})


def _absorber(altitudes):
    """A VMR absorber on a smooth tabulated cross section."""
    wl = np.linspace(250.0, 650.0, 41)
    xs = 1e-24 * (1.5 + np.sin(wl / 17.0))
    return skt.constituent.VMRAltitudeAbsorber(
        skt.optical.TabulatedCrossSectionAbsorber(wl, xs), altitudes,
        8e-6 * np.exp(-((altitudes - 25000.0) / 8000.0) ** 2))


def _aerosol(nleg):
    return skt.constituent.NumberDensityScatterer(
        skt.constituent.HGScatteringOptical(1e-13, 0.95, 0.7, nleg=nleg),
        ALTITUDES, 5e7 * np.exp(-ALTITUDES / 3000.0))


def _ground_case(config, wavelengths=WAVELENGTHS, **atmo_kw):
    geometry = skt.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=RE,
        altitude_grid_m=ALTITUDES,
        geometry_type=skt.GeometryType.PlaneParallel,
    )
    viewing = skt.ViewingGeometry()
    for mu in (0.5, 0.9):
        viewing.add_ray(skt.GroundViewingSolar(0.6, 0.5, mu, 200000.0))
    atmo = skt.Atmosphere(geometry, config, wavelengths_nm=wavelengths,
                          **atmo_kw)
    skt.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = skt.constituent.Rayleigh()
    atmo["absorber"] = _absorber(ALTITUDES)
    atmo["surface"] = skt.constituent.LambertianSurface(0.3)
    return config, geometry, viewing, atmo


def _geometry2d_case():
    nh, nalt = 5, 9
    config = _config(
        single_scatter_source=skt.SingleScatterSource.Exact,
        multiple_scatter_source=skt.MultipleScatterSource.NoSource,
        occultation_source=skt.OccultationSource.NoSource,
    )
    geometry = skt.Geometry2D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=RE,
        altitude_grid_m=np.linspace(0.0, 80000.0, nalt),
        horizontal_angle_grid_radians=np.linspace(-0.5, 0.5, nh),
    )
    viewing = skt.ViewingGeometry()
    viewing.add_ray(skt.TangentAltitude(20000.0, 2e5, 0.0, 0.0))
    viewing.add_ray(skt.TangentAltitude(35000.0, 2e5, 0.2, 0.0))
    atmo = skt.Atmosphere(geometry, config, wavelengths_nm=WAVELENGTHS[:3])
    skt.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo.pressure_pa = np.tile(atmo.pressure_pa, nh)
    atmo.temperature_k = np.tile(atmo.temperature_k, nh)
    atmo["rayleigh"] = skt.constituent.Rayleigh()
    atmo["aerosol"] = skt.constituent.NumberDensityScatterer2D(
        skt.constituent.HGScatteringOptical(1e-13, 0.9, 0.5, nleg=4),
        np.outer(np.linspace(1.0, 2.0, nh), np.full(nalt, 1e7)))
    return config, geometry, viewing, atmo


def _case(name):
    if name == "scalar":
        return _ground_case(_config())
    if name == "polarized":
        return _ground_case(_config(num_stokes=3))
    if name == "geometry2d":
        return _geometry2d_case()
    if name == "lineshape":
        config = _config(
            num_singlescatter_moments=8,
            spectral_grid_mode=skt.SpectralGridMode.AtmosphereIntegratedLineShape,
        )
        out = skt.basis.Grid.from_gaussians(np.array([502.0, 505.0, 508.0]),
                                            1.0)
        case = _ground_case(config, wavelengths=np.linspace(500.0, 510.0, 41),
                            spectral_grid=out)
        case[3]["aerosol"] = _aerosol(8)
        return case
    if name == "delta_m":
        case = _ground_case(_config(num_singlescatter_moments=8,
                                    delta_m_scaling=True))
        case[3]["aerosol"] = _aerosol(8)
        return case
    case = _ground_case(_config())                         # brdf
    case[3]["surface"] = skt.constituent.MODIS(0.1, 0.05, 0.02)
    return case


CASES = ["scalar", "polarized", "geometry2d", "lineshape", "delta_m", "brdf"]


def _host_transpose(x, axes):
    """The host's wavelength-leading copy the engine uploaded before."""
    return np.ascontiguousarray(np.transpose(x, axes))


def _call(engine, atmo):
    """(outputs, the core tensors the call handed ``_compute``)."""
    seen = {}
    compute = engine._compute

    def keep(core, wrt):
        seen.update(core)
        return compute(core, wrt)

    engine._compute = keep
    try:
        out = engine.calculate_radiance(atmo)
    finally:
        del engine._compute
    return out, {k: v.detach() for k, v in seen.items()}


@pytest.mark.parametrize("name", CASES)
def test_uploaded_core_equals_the_host_layout(name, monkeypatch):
    config, geometry, viewing, atmo = _case(name)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    out, core = _call(engine, atmo)

    ref = core_from_reference(atmo.internal_object(), "cpu", engine._dtype)
    assert list(core) == list(ref)
    for k, v in ref.items():
        assert core[k].dtype == v.dtype, k
        assert core[k].shape == v.shape, k
        assert core[k].stride() == v.stride(), k
        np.testing.assert_array_equal(core[k].numpy(), v.numpy(), err_msg=k)
    # each greek is its accessor's rows of the stack
    for k, greek in (("leg_coeff", "a1"), ("leg_a2", "a2"), ("leg_a3", "a3"),
                     ("leg_b1", "b1")):
        if k in core:
            np.testing.assert_array_equal(
                core[k].numpy(),
                np.transpose(getattr(atmo.leg_coeff, greek), (2, 1, 0)))
    assert ("leg_b1" in core) == (config.num_stokes == 3)

    # the same engine fed the host's wavelength-leading copies
    monkeypatch.setattr(
        engine_module, "upload_core",
        lambda native, nstokes, device, dtype: core_from_reference(
            wavelength_leading(native, nstokes, _host_transpose), device,
            dtype))
    old, old_core = _call(engine, atmo)
    assert set(old_core) == set(core)
    names = sorted(out.keys())
    assert names == sorted(old.keys())
    assert "radiance" in names and any(n.startswith("wf_") for n in names)
    for n in names:
        np.testing.assert_array_equal(out[n].to_numpy(), old[n].to_numpy(),
                                      err_msg=n)


@pytest.mark.parametrize("name", ["scalar", "polarized"])
def test_the_calls_core_owns_its_memory(name):
    config, geometry, viewing, atmo = _case(name)
    engine = skt.Engine(config, geometry, viewing, device="cpu")
    _, core = _call(engine, atmo)
    before = {k: v.clone() for k, v in core.items()}
    s = atmo.storage
    for arr in (s.total_extinction, s.ssa, s.emission_source, s.leg_coeff,
                s.solar_irradiance, atmo.surface.albedo,
                atmo.surface.emission):
        arr[...] = 7.0
    for k, v in core.items():
        assert torch.equal(v, before[k]), k
    # and the next call's reset of the storage, in place, reaches none
    engine.calculate_radiance(atmo)
    for k, v in core.items():
        assert torch.equal(v, before[k]), k
