"""The engine cases that ``chip_smoke.py`` drives and that
``tools/make_torch_golden.py`` computes reference values for. All of them
have weighting functions on, 101 altitudes from 0 to 100 km (P = 100
layers) and cos_sza = 0.6; all but the thermal ones use a US76 + Rayleigh
+ Lambertian 0.3 atmosphere and the 1024-point grid
``np.linspace(280, 800, 1024)`` nm.

* ``smoke_case``: 16 streams, discrete-ordinates single and multiple
  scatter, plane-parallel geometry, four ground-viewing rays
  (cos_viewing_zenith 0.4, 0.6, 0.8, 1.0, relative azimuth 0.5, observer
  at 200 km). Rayleigh gives 3 azimuth modes, BVP blocks of K = 16 and
  eigensolves of n = 8.
* ``limb_case``: bench.py's flagship limb workload
  (``_build_engine_limb16``): 16 streams, exact single scatter, DO
  multiple scatter on a 2-point solar-zenith grid, spherical geometry, 20
  limb rays with tangent altitudes 10-80 km (relative azimuth 0.4,
  observer at 200 km).
* ``twostream_case``: bench.py's ``_build_engine_2str``: the two-stream
  solver with DO single scatter, plane-parallel geometry, one
  ground-viewing ray (cos_viewing_zenith 0.8, relative azimuth 0.3).
* ``flux16_case``: ``smoke_case``'s streams and sources, one
  ground-viewing ray and flux observers at 0, 5, 10, 20, 40 and 80 km
  with all four flux types (upwelling, downwelling, actinic,
  divergence): the m = 0 level solve at K = 16, n = 8.
* ``pol4_case``: the engine-level counterpart of bench.py's
  ``pol3_4str_1k``: ``smoke_case`` with ``num_stokes = 3`` at 4 streams
  (eigensolves of n = 6, BVP blocks of K = 12).
* ``pol16_case``: the same at 16 streams (n = 24; K = 48 blocks, which
  the Thomas kernel does not take: the torch-op loop, as the reference's
  scan).
* ``limbpol16_case``: ``limb_case`` with ``num_stokes = 3``: exact
  polarized single scatter and the vector DO source on a 2-point
  solar-zenith grid, at ``LIMBPOL_NUM_LOS`` tangent altitudes from 10 to
  80 km. Each line of sight is three Jacobian rows (I, Q, U), each of
  which recomputes the six checkpointed 16-stream vector modes (about
  33 s per line of sight and call with Jacobians on an H100), so the scan
  is cut from bench.py's 20 lines of sight to 3, the most that keeps
  ``chip_smoke.py`` near half its time limit (PERF.md section 4 has the
  arithmetic); streams, layers and wavelengths are not cut.

* ``brdf16_case``: ``smoke_case`` over the MODIS surface of
  ``tests/test_brdf.py:72`` (f_iso 0.25, f_vol 0.15, f_geo 0.05) in place
  of the Lambertian 0.3, with its three weighting functions. A BRDF turns
  the azimuth-mode truncation off, so all 16 modes run.
* ``thermal16_case``: night-side thermal infrared: ``THERMAL_WAVELENGTHS``
  (4,000-15,000 nm), the solar beam off, US76 + Rayleigh + an absorber of
  constant VMR 4e-4 with a smooth tabulated cross section from 1e-28 to
  1e-24 m^2 (``absorber_cross_section``; nadir optical depth about 0.01 to
  90) + ``ThermalEmission`` + ``SurfaceThermalEmission(288.15, 0.98)`` +
  Lambertian 0.02, DO emission, on ``smoke_case``'s four rays plus
  ``flux16_case``'s six observers and four flux types.
* ``thermallimb16_case``: the same atmosphere on ``limb_case``'s 20 limb
  rays, with DO single scatter (DO emission requires it).

The cells of the generic per-wavelength route (the configurations the
JAX engine's gates ``_twostream_fast_ok`` and ``_polarized_fast_ok`` send
there), all at 4 streams polarized (eigensolves of n = 6, BVP blocks of
K = 12) but the first:

* generic16: ``smoke_case`` with the fast path's gate replaced by
  ``lambda: False`` (``chip_smoke.py`` does it), against the same golden
  file (the generic route computes the same function);
* ``polbrdf4_case``: ``pol4_case`` over ``brdf16_case``'s MODIS surface,
  every azimuth mode;
* ``polflux4_case``: ``pol4_case`` with ``flux16_case``'s six observers
  and four flux types (12 radiance and 24 flux outputs);
* ``polthermallimb4_case``: ``thermallimb16_case`` polarized at 4
  streams, ``POLTHERMAL_NUM_LOS`` lines of sight.

``POL16_SOLVER_*`` is the solver-level case of the 16-stream polarized
check: the JAX package cannot compile its polarized engine at 16 streams
on the CPU, so ``tools/make_torch_golden.py`` stores the inputs and
outputs of ``solve_nstream_vector`` on ``pol16_case``'s layers instead.
"""

from __future__ import annotations

import os

import numpy as np

NUM_WAVELENGTHS = 1024
# the 8 wavelengths of the 1024-point grid that the golden file holds
GOLDEN_INDICES = np.linspace(0, NUM_WAVELENGTHS - 1, 8).round().astype(int)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN_PATH = os.path.join(DATA, "golden_nstr16.npz")
GOLDEN_LIMB_PATH = os.path.join(DATA, "golden_limb16.npz")
GOLDEN_2STR_PATH = os.path.join(DATA, "golden_2str.npz")
GOLDEN_FLUX16_PATH = os.path.join(DATA, "golden_flux16.npz")
GOLDEN_POL4_PATH = os.path.join(DATA, "golden_pol4.npz")
GOLDEN_POL16_SOLVER_PATH = os.path.join(DATA, "golden_pol16_solver.npz")
GOLDEN_BRDF16_PATH = os.path.join(DATA, "golden_brdf16.npz")
GOLDEN_THERMAL16_PATH = os.path.join(DATA, "golden_thermal16.npz")
GOLDEN_THERMALLIMB16_PATH = os.path.join(DATA, "golden_thermallimb16.npz")
GOLDEN_POLBRDF4_PATH = os.path.join(DATA, "golden_polbrdf4.npz")
GOLDEN_POLFLUX4_PATH = os.path.join(DATA, "golden_polflux4.npz")
GOLDEN_POLTHERMALLIMB4_PATH = os.path.join(DATA, "golden_polthermallimb4.npz")
LIMB_TANGENTS_M = np.linspace(10000.0, 80000.0, 20)
LIMBPOL_NUM_LOS = 3
POLTHERMAL_NUM_LOS = 20
# the cases whose Q and U are gated against the largest |I|
# (``golden_error``'s ``qu_scale``): thermal emission with the sun off
# polarizes only a trace
QU_SCALE = {"polthermallimb4": "I"}
FLUX_ALTITUDES_M = (0.0, 5000.0, 10000.0, 20000.0, 40000.0, 80000.0)
# the pol16 solver-level case: the four rays of smoke_case, the azimuth
# modes a Rayleigh atmosphere needs, and the golden file's wavelengths
POL16_SOLVER_USER_MU = np.array([0.4, 0.6, 0.8, 1.0])
POL16_SOLVER_AZIMUTH = 0.5
POL16_SOLVER_NUM_AZIMUTH = 3


def smoke_wavelengths():
    return np.linspace(280.0, 800.0, NUM_WAVELENGTHS)


def thermal_wavelengths():
    """The thermal cases' grid: 1024 points from 4,000 to 15,000 nm."""
    return np.linspace(4000.0, 15000.0, NUM_WAVELENGTHS)


def absorber_cross_section():
    """(wavelengths_nm, cross_section_m2) of the thermal cases' absorber:
    a smooth spectrum on a 20 nm grid over 3,900-15,100 nm, the sum of
    eight sinusoids of random amplitude and phase (numpy seed 0) scaled so
    that log10 of the cross section spans -28 to -24."""
    rng = np.random.default_rng(0)
    wl = np.linspace(3900.0, 15100.0, 561)
    x = (wl - wl[0]) / (wl[-1] - wl[0])
    s = sum(
        rng.normal() / f * np.sin(2.0 * np.pi * f * x + rng.uniform(0.0, 6.3))
        for f in range(1, 9)
    )
    s = (s - s.min()) / (s.max() - s.min())
    return wl, 10.0 ** (-28.0 + 4.0 * s)


def smoke_case(sk, dtype: str, wavelengths_nm, num_stokes=1, nstr=16,
               flux_types=None):
    """(config, geometry, viewing, atmosphere) of the case, built from
    ``sk``: the port (``sasktran2_tpu_torch``) or the JAX package
    (``sasktran2_tpu``), whose classes and constituents mirror each
    other."""
    config = sk.Config(
        num_streams=nstr,
        num_stokes=num_stokes,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=nstr,
        dtype=dtype,
        **({} if flux_types is None else {"flux_types": flux_types}),
    )
    geometry = _geometry(sk, sk.GeometryType.PlaneParallel)
    viewing = sk.ViewingGeometry()
    for mu in (0.4, 0.6, 0.8, 1.0):
        viewing.add_ray(sk.GroundViewingSolar(
            cos_sza=0.6, relative_azimuth=0.5, cos_viewing_zenith=mu,
            observer_altitude_m=200000.0,
        ))
    return config, geometry, viewing, _atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def _atmosphere(sk, config, geometry, wavelengths_nm):
    atmo = sk.Atmosphere(geometry, config, wavelengths_nm=wavelengths_nm)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    return atmo


def _thermal_atmosphere(sk, config, geometry, wavelengths_nm):
    atmo = sk.Atmosphere(geometry, config, wavelengths_nm=wavelengths_nm)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    xs_wl, xs = absorber_cross_section()
    alts = geometry.altitudes()
    atmo["absorber"] = sk.constituent.VMRAltitudeAbsorber(
        sk.optical.TabulatedCrossSectionAbsorber(xs_wl, xs), alts,
        np.full(len(alts), 4e-4),
    )
    atmo["thermal"] = sk.constituent.ThermalEmission()
    atmo["surface_emission"] = sk.constituent.SurfaceThermalEmission(
        288.15, 0.98)
    atmo["surface"] = sk.constituent.LambertianSurface(0.02)
    atmo.storage.solar_irradiance[:] = 0.0          # night side
    return atmo


def _geometry(sk, geometry_type):
    return sk.Geometry1D(
        cos_sza=0.6,
        solar_azimuth=0.0,
        earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 101),
        geometry_type=geometry_type,
    )


def limb_case(sk, dtype: str, wavelengths_nm, num_stokes=1,
              tangents_m=LIMB_TANGENTS_M):
    """(config, geometry, viewing, atmosphere) of the 16-stream limb scan,
    built from ``sk`` as ``smoke_case`` is."""
    config = sk.Config(
        num_streams=16,
        num_stokes=num_stokes,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.Exact,
        num_singlescatter_moments=16,
        num_do_sza=2,
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.Spherical)
    viewing = sk.ViewingGeometry()
    for talt in tangents_m:
        viewing.add_ray(sk.TangentAltitudeSolar(float(talt), 0.4, 2e5, 0.6))
    return config, geometry, viewing, _atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def twostream_case(sk, dtype: str, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of the two-stream engine
    case, built from ``sk`` as ``smoke_case`` is."""
    config = sk.Config(
        num_streams=2,
        multiple_scatter_source=sk.MultipleScatterSource.TwoStream,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.PlaneParallel)
    viewing = sk.ViewingGeometry()
    viewing.add_ray(sk.GroundViewingSolar(0.6, 0.3, 0.8, 2e5))
    return config, geometry, viewing, _atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def flux16_case(sk, dtype: str, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of the 16-stream flux case,
    built from ``sk`` as ``smoke_case`` is."""
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=16,
        flux_types=(
            sk.FluxType.Upwelling, sk.FluxType.Downwelling,
            sk.FluxType.Actinic, sk.FluxType.Divergence,
        ),
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.PlaneParallel)
    viewing = sk.ViewingGeometry()
    viewing.add_ray(sk.GroundViewingSolar(0.6, 0.5, 0.8, 200000.0))
    for alt in FLUX_ALTITUDES_M:
        viewing.add_flux_observer(sk.FluxObserverSolar(0.6, alt))
    return config, geometry, viewing, _atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def pol4_case(sk, dtype: str, wavelengths_nm):
    """``smoke_case`` polarized at 4 streams."""
    return smoke_case(sk, dtype, wavelengths_nm, num_stokes=3, nstr=4)


def pol16_case(sk, dtype: str, wavelengths_nm):
    """``smoke_case`` polarized at 16 streams."""
    return smoke_case(sk, dtype, wavelengths_nm, num_stokes=3, nstr=16)


def limbpol16_case(sk, dtype: str, wavelengths_nm):
    """``limb_case`` polarized, on ``LIMBPOL_NUM_LOS`` lines of sight."""
    return limb_case(
        sk, dtype, wavelengths_nm, num_stokes=3,
        tangents_m=np.linspace(10000.0, 80000.0, LIMBPOL_NUM_LOS),
    )


def brdf16_case(sk, dtype: str, wavelengths_nm):
    """``smoke_case`` over a MODIS BRDF surface."""
    config, geometry, viewing, atmo = smoke_case(sk, dtype, wavelengths_nm)
    atmo["surface"] = sk.constituent.MODIS(0.25, 0.15, 0.05)
    return config, geometry, viewing, atmo


def thermal16_case(sk, dtype: str, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of the 16-stream thermal
    infrared case with fluxes, built from ``sk`` as ``smoke_case`` is."""
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        emission_source=sk.EmissionSource.DiscreteOrdinates,
        num_singlescatter_moments=16,
        flux_types=(
            sk.FluxType.Upwelling, sk.FluxType.Downwelling,
            sk.FluxType.Actinic, sk.FluxType.Divergence,
        ),
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.PlaneParallel)
    viewing = sk.ViewingGeometry()
    for mu in (0.4, 0.6, 0.8, 1.0):
        viewing.add_ray(sk.GroundViewingSolar(
            cos_sza=0.6, relative_azimuth=0.5, cos_viewing_zenith=mu,
            observer_altitude_m=200000.0,
        ))
    for alt in FLUX_ALTITUDES_M:
        viewing.add_flux_observer(sk.FluxObserverSolar(0.6, alt))
    return config, geometry, viewing, _thermal_atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def thermallimb16_case(sk, dtype: str, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of the 16-stream thermal
    limb scan: ``limb_case``'s geometry and rays, ``thermal16_case``'s
    atmosphere."""
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        emission_source=sk.EmissionSource.DiscreteOrdinates,
        num_singlescatter_moments=16,
        num_do_sza=2,
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.Spherical)
    viewing = sk.ViewingGeometry()
    for talt in LIMB_TANGENTS_M:
        viewing.add_ray(sk.TangentAltitudeSolar(float(talt), 0.4, 2e5, 0.6))
    return config, geometry, viewing, _thermal_atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def polbrdf4_case(sk, dtype: str, wavelengths_nm):
    """``pol4_case`` over ``brdf16_case``'s MODIS surface."""
    config, geometry, viewing, atmo = pol4_case(sk, dtype, wavelengths_nm)
    atmo["surface"] = sk.constituent.MODIS(0.25, 0.15, 0.05)
    return config, geometry, viewing, atmo


def polflux4_case(sk, dtype: str, wavelengths_nm):
    """``pol4_case`` with ``flux16_case``'s observers and flux types."""
    config, geometry, viewing, atmo = smoke_case(
        sk, dtype, wavelengths_nm, num_stokes=3, nstr=4,
        flux_types=(sk.FluxType.Upwelling, sk.FluxType.Downwelling,
                    sk.FluxType.Actinic, sk.FluxType.Divergence),
    )
    for alt in FLUX_ALTITUDES_M:
        viewing.add_flux_observer(sk.FluxObserverSolar(0.6, alt))
    return config, geometry, viewing, atmo


def polthermallimb4_case(sk, dtype: str, wavelengths_nm):
    """``thermallimb16_case`` with ``num_stokes = 3`` at 4 streams, on
    ``POLTHERMAL_NUM_LOS`` tangent altitudes from 10 to 80 km."""
    config = sk.Config(
        num_streams=4,
        num_stokes=3,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        emission_source=sk.EmissionSource.DiscreteOrdinates,
        num_singlescatter_moments=4,
        num_do_sza=2,
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.Spherical)
    viewing = sk.ViewingGeometry()
    for talt in np.linspace(10000.0, 80000.0, POLTHERMAL_NUM_LOS):
        viewing.add_ray(sk.TangentAltitudeSolar(float(talt), 0.4, 2e5, 0.6))
    return config, geometry, viewing, _thermal_atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def golden_error(name, got, ref, stokes_axis=-1, qu_scale="own"):
    """The error of ``got`` against the golden ``ref`` by which a case is
    gated: for ``radiance`` and the ``*_flux`` variables the largest error
    relative to the element; for a polarized radiance (three Stokes
    components on ``stokes_axis``) I per element and Q, U relative to the
    largest |Q| and |U|, so that a component near zero is not held to
    itself; for ``wf_*`` and gradients the largest error relative to the
    variable's largest magnitude. Where the reference is exactly zero (the
    divergence flux of a conservative atmosphere) the error is absolute.
    ``qu_scale="I"`` holds Q and U to the largest |I| instead, for a case
    whose polarization is only a trace (thermal emission with the sun
    off)."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = np.abs(got - ref)

    def nonzero(x):
        return np.where(x > 0.0, x, 1.0)

    per_element = name == "radiance" or (
        name.endswith("_flux") and not name.startswith("wf_"))
    if name == "radiance" and ref.shape[stokes_axis] == 3:
        i_err = np.take(err, 0, stokes_axis) / nonzero(
            np.abs(np.take(ref, 0, stokes_axis)))
        scale = {c: np.max(np.abs(np.take(ref, c if qu_scale == "own" else 0,
                                          stokes_axis))) for c in (1, 2)}
        qu = [np.max(np.take(err, c, stokes_axis)) / nonzero(scale[c])
              for c in (1, 2)]
        return float(max(np.max(i_err), *qu))
    if per_element:
        return float(np.max(err / nonzero(np.abs(ref))))
    return float(np.max(err) / nonzero(np.max(np.abs(ref))))
