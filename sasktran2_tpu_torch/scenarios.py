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
  the Thomas kernel's pivoting branch solves, as the reference's scan
  solves them with a pivoted solve).
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

The successive-orders cells, on ``limb_case``'s 20 limb rays with exact
single scatter, 16 moments, the reference's SO defaults (110 incoming
directions: a 10 x 10 grid; 50 iterations) and ``SO_NUM_WAVELENGTHS`` = 64
wavelengths on 280-800 nm, spherical geometry on ``SO_ALTITUDES_M``
(0-100 km at 2 km, 51 levels: the host build of the SO geometry, Python
loops over every internal ray, grows about as A^2.1 and is the cut's
reason; PERF.md section 4):

* ``solimb16_case``: one SZA profile;
* ``solimb16_doinit_case``: the field seeded by a 16-stream, 16-mode DO
  solve (K1 at K = 16, K3 at n = 8);
* ``polsolimb16_case``: ``num_stokes = 3``.

The optical cell, ``o2a16_case``: an O2 A-band line-by-line calculation
with a Mie aerosol, as O2 A-band cloud, aerosol-layer-height and
surface-pressure retrievals (TROPOMI, OCO-2, GOSAT) run it. ``smoke_case``'s
geometry, streams and sources (16 streams, DO single and multiple
scatter, plane-parallel, 101 altitudes, four ground-viewing rays) over
US76 + Rayleigh + Lambertian 0.3, with

* O2 as ``VMRAltitudeAbsorber(LineAbsorber(o2a16_catalogue()), altitudes,
  0.2095)``: 1,500 synthetic lines (numpy seed ``O2A16_SEED``; no line list
  is in the repository) with nu0 uniform in 12,990-13,175 cm^-1, S
  log-uniform in 1e-27-1e-23 cm^-1/(molec cm^-2), gamma_air 0.030-0.055,
  gamma_self gamma_air + 0.005, n_air 0.6-0.8, delta_air -0.012 to
  -0.005, E'' 0-2,000 cm^-1, the 25 cm^-1 cutoff and chunks of 512;
* an ``ExtinctionScatterer`` on a Mie table (``o2a16_mie_table``: a
  ``MieDatabase`` of a lognormal distribution, refractive index
  1.44 + 1e-7 i, 750-780 nm every 5 nm, median radius 60-200 nm x mode
  width 1.5-1.7, the default 1,000 radii, 481 angles and 64 moments), at
  median radius 120 nm and mode width 1.6 on every level, its extinction
  at 765 nm decaying with a 2 km scale height to an optical depth of 0.1.
  The refractive index is sulfate-like. Its imaginary part is positive
  because the Mie formulas of both packages (xi = psi - i chi) take an
  absorbing index as n + ik: 1.44 - 1e-7 i gives an ssa above 1, which
  both engines' input validation refuses;
* ``SpectralGridMode.EngineIntegratedLineShape`` on the fine grid
  ``O2A16_WAVENUMBERS`` (4,096 points, 13,000 + 0.04 k cm^-1, 759.7-769.2
  nm) mapped onto 82 Gaussians of 6.5 cm^-1 FWHM (about 0.38 nm, TROPOMI
  band 6) spaced 1.7 cm^-1, at least 2 FWHM inside the fine grid
  (``o2a16_output_grid``). The grid step is about 2.5 Doppler
  half-widths, wider than an operational line-by-line grid (about 0.01
  cm^-1): the cut that keeps ``chip_smoke.py`` inside its limit.

``o2a16_check_indices`` picks the 16 fine wavenumbers of the
Monochromatic correctness check: the cores of the 6 strongest lines
inside the grid, 5 points in their wings (0.2 cm^-1 off the centre) and
the 5 grid points farthest from any line stronger than 1e-25.

The host-side slice's cells:

* ``dayglowlimb16_case``: an O2 A-band dayglow limb scan, as OSIRIS and
  SCIAMACHY O2 A-band dayglow VER and temperature retrievals run it. The
  rays come from a ``LimbVertical`` container
  (``LimbVertical.from_tangent_parameters`` with a forced sun at solar
  zenith 60 and azimuth 30 degrees; ``DAYGLOW_TANGENTS_M``, 21 tangent
  altitudes 60-100 km every 2 km; the tangent point at 20 N 40 E, the
  observer at 600 km, viewing azimuth 90 degrees, reference altitude
  80 km), and the model geometry from ``container.model_geometry`` on
  0-100 km every 1 km (spherical). 16 streams, exact single scatter, DO
  multiple scatter on ``limb_case``'s 2-point SZA grid, VER emission,
  Monochromatic, on ``DAYGLOW_WAVENUMBERS`` (4,096 points 0.005 cm^-1
  apart from 13,100 cm^-1, which resolves the emission lines' Doppler
  width of about 0.014 cm^-1). US76 + Rayleigh + Lambertian 0.3; the
  sun in photon units (``DAYGLOW_SOLAR_PHOTONS``, through
  ``SolarIrradiance``); O2 as a ``LineAbsorber`` on the catalogue that
  ``HITRANLineDatabase().load_catalogue("O2")`` reads from the file that
  ``write_dayglow_par`` writes (no HITRAN file is in the repository:
  o2a16's 1,500 seeded lines with a seeded Einstein A, g' and g'' and
  global quanta "b 0"/"X 0", or "b 1"/"X 1" for a seeded
  ``DAYGLOW_HOT_SHARE`` of them); and the airglow as a
  ``LineListVolumeEmissionRate`` of the O2(b, v = 0, 1, 2) populations
  that ``Yankovsky().solve`` gives (``dayglow_populations``) on the
  model grid. Its backgrounds: O2 and N2 from US76, O from
  ``climatology.atomic_oxygen`` (month 7, the tangent latitude), O3 and
  CO2 at fixed densities; its photolysis rates are each reaction's
  published top-of-atmosphere rate at every altitude (the optically thin
  limit: flux-driven rates need O2 and O3 cross sections, which are not
  in the repository). ``emission="population"`` puts the same
  populations through ``PopulationEmissionRate`` instead.
  ``dayglowlimb16_check_indices`` picks its 8 golden wavenumbers.
* ``amf16_case``: ``smoke_case`` over a weak background absorber (that of
  ``tests/test_amf.py``) with ``AirMassFactor``: the box air-mass factors
  that DOAS trace-gas retrievals ask for, which they run in float64 (in
  float32 the AMF is ill-conditioned and the engine warns).

The 2D cell:

* ``tomo2d_case``: tomographic limb retrievals along the orbit track
  (OSIRIS, OMPS-LP and ALTIUS ozone and aerosol), which need horizontal
  gradients: a ``Geometry2D`` of 101 altitudes (0-100 km) by 41
  horizontal angles (-20 to 20 degrees), 40 ``TangentAltitude`` rays (4
  images at -6, -2, 2 and 6 degrees, 10 tangent altitudes each from 10
  to 55 km, observer at 600 km), exact single scatter, 64 wavelengths on
  280-800 nm, with Jacobians. Cut from operational tomography's about 100
  images per orbit at 1-2 km vertical sampling to 4 images at 5 km, for
  the host 2D tracer's time (about 0.4 s per ray); its absorber's cross
  section is synthetic (``tomo2d_cross_section``). The golden file holds
  its ``wf_*`` (each [4,141, W, 40, 1]) at the two wavelengths of
  ``TOMO2D_WF_POSITIONS`` only.

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
SO_ALTITUDES_M = np.linspace(0.0, 100000.0, 51)
SO_NUM_WAVELENGTHS = 64
# the 8 wavelengths of the SO cells' 64-point grid that their golden
# files hold
SO_GOLDEN_INDICES = np.linspace(
    0, SO_NUM_WAVELENGTHS - 1, 8).round().astype(int)
GOLDEN_SOLIMB16_PATH = os.path.join(DATA, "golden_solimb16.npz")
GOLDEN_SOLIMB16_DOINIT_PATH = os.path.join(DATA, "golden_solimb16_doinit.npz")
GOLDEN_POLSOLIMB16_PATH = os.path.join(DATA, "golden_polsolimb16.npz")
# the cases whose Q and U are gated against the largest |I|
# (``golden_error``'s ``qu_scale``): thermal emission with the sun off
# polarizes only a trace
QU_SCALE = {"polthermallimb4": "I"}
FLUX_ALTITUDES_M = (0.0, 5000.0, 10000.0, 20000.0, 40000.0, 80000.0)
# the pol16 solver-level case: the four rays of smoke_case, the azimuth
# modes a Rayleigh atmosphere needs, and the golden file's wavelengths
POL16_SOLVER_USER_MU = np.array([0.4, 0.6, 0.8, 1.0])
# the optical cell
GOLDEN_O2A16_PATH = os.path.join(DATA, "golden_o2a16.npz")
O2A16_SEED = 2095
O2A16_NUM_LINES = 1500
O2A16_WAVENUMBERS = 13000.0 + 0.04 * np.arange(4096)
O2A16_FWHM_CMINV = 6.5
O2A16_SPACING_CMINV = 1.7
O2A16_MIE_WAVELENGTHS_NM = np.arange(750.0, 780.1, 5.0)
O2A16_MEDIAN_RADII_NM = np.array([60.0, 80.0, 100.0, 120.0, 160.0, 200.0])
O2A16_MODE_WIDTHS = np.array([1.5, 1.6, 1.7])
O2A16_REFRACTIVE_INDEX = 1.44 + 1e-7j
O2A16_AEROSOL_OD = 0.1
O2A16_SCALE_HEIGHT_M = 2000.0
# the levels at which the golden file holds the cross sections
O2A16_XS_LEVELS = np.linspace(0, 100, 10).round().astype(int)
# the host-side slice's cells
GOLDEN_DAYGLOWLIMB16_PATH = os.path.join(DATA, "golden_dayglowlimb16.npz")
GOLDEN_AMF16_PATH = os.path.join(DATA, "golden_amf16.npz")
DAYGLOW_TANGENTS_M = np.arange(60000.0, 100001.0, 2000.0)
DAYGLOW_ALTITUDES_M = np.linspace(0.0, 100000.0, 101)
DAYGLOW_WAVENUMBERS = 13100.0 + 0.005 * np.arange(4096)
DAYGLOW_SEED = 762
DAYGLOW_HOT_SHARE = 0.1
# the solar spectral irradiance near 762 nm, about 1.23 W m^-2 nm^-1, in
# photons m^-2 s^-1 nm^-1 (the emission's units)
DAYGLOW_SOLAR_PHOTONS = 4.72e18
# O3 and CO2 number densities [m^-3] (``tests/test_photchem.py:17-25``)
DAYGLOW_O3_M3 = 1.0e14
DAYGLOW_CO2_M3 = 6.0e17
DAYGLOW_MONTH = 7.0
AMF16_BACKGROUND_M1 = 5e-7
# the 2D cell
GOLDEN_TOMO2D_PATH = os.path.join(DATA, "golden_tomo2d.npz")
TOMO2D_NUM_ALTITUDES = 101
TOMO2D_ANGLES_DEG = np.arange(-20.0, 20.1, 1.0)
TOMO2D_IMAGE_ANGLES_DEG = (-6.0, -2.0, 2.0, 6.0)
TOMO2D_TANGENTS_M = np.arange(10000.0, 55001.0, 5000.0)
TOMO2D_OBSERVER_M = 600000.0
# the golden file's wavelengths (``SO_GOLDEN_INDICES`` of the 64-point
# grid) and, among them, the two at which it holds every ``wf_*``: 280 nm
# in the absorber's UV band and 577 nm in its visible one
TOMO2D_WF_POSITIONS = np.array([0, 4])
POL16_SOLVER_AZIMUTH = 0.5
POL16_SOLVER_NUM_AZIMUTH = 3


def smoke_wavelengths():
    return np.linspace(280.0, 800.0, NUM_WAVELENGTHS)


def so_wavelengths():
    """The SO cells' grid: 64 points from 280 to 800 nm."""
    return np.linspace(280.0, 800.0, SO_NUM_WAVELENGTHS)


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


def solimb16_case(sk, dtype: str, wavelengths_nm, num_stokes=1,
                  do_init=False):
    """(config, geometry, viewing, atmosphere) of the successive-orders
    limb scan, built from ``sk`` as ``smoke_case`` is."""
    config = sk.Config(
        num_streams=16,
        num_stokes=num_stokes,
        multiple_scatter_source=sk.MultipleScatterSource.SuccessiveOrders,
        single_scatter_source=sk.SingleScatterSource.Exact,
        num_singlescatter_moments=16,
        init_successive_orders_with_discrete_ordinates=do_init,
        dtype=dtype,
    )
    geometry = sk.Geometry1D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=SO_ALTITUDES_M,
        geometry_type=sk.GeometryType.Spherical,
    )
    viewing = sk.ViewingGeometry()
    for talt in LIMB_TANGENTS_M:
        viewing.add_ray(sk.TangentAltitudeSolar(float(talt), 0.4, 2e5, 0.6))
    return config, geometry, viewing, _atmosphere(
        sk, config, geometry, wavelengths_nm
    )


def solimb16_doinit_case(sk, dtype: str, wavelengths_nm):
    """``solimb16_case`` seeded by the DO solution."""
    return solimb16_case(sk, dtype, wavelengths_nm, do_init=True)


def polsolimb16_case(sk, dtype: str, wavelengths_nm):
    """``solimb16_case`` polarized (I, Q, U)."""
    return solimb16_case(sk, dtype, wavelengths_nm, num_stokes=3)


def _o2a16_lines():
    """The line parameters of the cell's synthetic list (numpy seed
    ``O2A16_SEED``)."""
    rng = np.random.default_rng(O2A16_SEED)
    n = O2A16_NUM_LINES
    gamma_air = rng.uniform(0.030, 0.055, n)
    return {
        "nu0": rng.uniform(12990.0, 13175.0, n),
        "intensity": 10.0 ** rng.uniform(-27.0, -23.0, n),
        "gamma_air": gamma_air,
        "gamma_self": gamma_air + 0.005,
        "n_air": rng.uniform(0.6, 0.8, n),
        "delta_air": rng.uniform(-0.012, -0.005, n),
        "elower": rng.uniform(0.0, 2000.0, n),
    }


def o2a16_catalogue(sk):
    """The cell's synthetic O2 A-band line list, a ``LineCatalogue`` of
    ``sk``."""
    return sk.optical.LineCatalogue(**_o2a16_lines(),
                                    molar_mass=31.98983e-3)


def o2a16_output_centers():
    """The output basis centres [cm^-1]: every 1.7 cm^-1 from 2 FWHM above
    the fine grid's start while 2 FWHM below its end (82 centres)."""
    lo = O2A16_WAVENUMBERS[0] + 2.0 * O2A16_FWHM_CMINV
    hi = O2A16_WAVENUMBERS[-1] - 2.0 * O2A16_FWHM_CMINV
    n = int(np.floor((hi - lo) / O2A16_SPACING_CMINV + 1e-9)) + 1
    return lo + O2A16_SPACING_CMINV * np.arange(n)


def o2a16_output_grid(sk):
    """The output basis: Gaussians of 6.5 cm^-1 FWHM at
    ``o2a16_output_centers``, in wavenumber."""
    return sk.basis.Grid.from_gaussians(o2a16_output_centers(),
                                        O2A16_FWHM_CMINV)


def o2a16_refractive_index(wavelength_nm):
    """The cell's constant, sulfate-like refractive index."""
    return O2A16_REFRACTIVE_INDEX


def o2a16_mie_table(sk, db_root, device=None):
    """The cell's Mie table, a ``MieDatabase`` of the port generated (on
    ``device``, None: the GPU) into ``db_root``, or read from there when a
    table of the same recipe is cached."""
    return sk.database.MieDatabase(
        sk.mie.LogNormalDistribution(),
        sk.mie.RefractiveIndex(o2a16_refractive_index, "sulfate_like_144"),
        O2A16_MIE_WAVELENGTHS_NM,
        db_root=db_root,
        median_radius=O2A16_MEDIAN_RADII_NM,
        mode_width=O2A16_MODE_WIDTHS,
        device=device,
    )


def o2a16_check_indices():
    """The 16 indices into ``O2A16_WAVENUMBERS`` of the Monochromatic
    check: line cores, wings and continuum."""
    lines = _o2a16_lines()
    nu0, s = lines["nu0"], lines["intensity"]
    grid = O2A16_WAVENUMBERS
    inside = (nu0 > grid[0] + 1.0) & (nu0 < grid[-1] - 1.0)
    strongest = np.argsort(np.where(inside, s, 0.0))[::-1][:6]
    cores = [int(np.argmin(np.abs(grid - nu0[i]))) for i in strongest]
    wings = [int(np.argmin(np.abs(grid - nu0[i] - 0.2)))
             for i in strongest[:5]]
    strong = nu0[s > 1e-25]
    dist = np.min(np.abs(grid[:, None] - strong[None, :]), axis=1)
    taken = set(cores) | set(wings)
    continuum = [int(i) for i in np.argsort(dist)[::-1]
                 if int(i) not in taken]
    picked = cores + wings
    for i in continuum:
        if all(abs(i - j) > 25 for j in picked):
            picked.append(i)
        if len(picked) == 16:
            break
    return np.array(sorted(picked))


def o2a16_case(sk, dtype: str, wavenumbers_cminv, mie_table,
               mode="EngineIntegratedLineShape", device=None):
    """(config, geometry, viewing, atmosphere) of the optical cell on the
    fine grid ``wavenumbers_cminv``, with the aerosol's optical property
    ``mie_table`` (a scatterer database of ``sk``) and the spectral grid
    mode ``mode`` (the output basis only where the mode integrates). For
    the port, ``device`` is where the line absorber runs (None: the
    GPU)."""
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=16,
        dtype=dtype,
        spectral_grid_mode=getattr(sk.SpectralGridMode, mode),
    )
    geometry = _geometry(sk, sk.GeometryType.PlaneParallel)
    viewing = sk.ViewingGeometry()
    for mu in (0.4, 0.6, 0.8, 1.0):
        viewing.add_ray(sk.GroundViewingSolar(
            cos_sza=0.6, relative_azimuth=0.5, cos_viewing_zenith=mu,
            observer_altitude_m=200000.0,
        ))
    kw = {}
    if mode != "Monochromatic":
        kw["spectral_grid"] = o2a16_output_grid(sk)
    atmo = sk.Atmosphere(geometry, config,
                         wavenumbers_cminv=np.asarray(wavenumbers_cminv),
                         **kw)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    alts = geometry.altitudes()
    port = sk.__name__.endswith("_torch")
    atmo["o2"] = sk.constituent.VMRAltitudeAbsorber(
        sk.optical.LineAbsorber(o2a16_catalogue(sk),
                                **({"device": device} if port else {})),
        alts, np.full(len(alts), 0.2095))
    h = O2A16_SCALE_HEIGHT_M
    atmo["aerosol"] = sk.constituent.ExtinctionScatterer(
        mie_table, alts, O2A16_AEROSOL_OD / h * np.exp(-alts / h), 765.0,
        param_values={"median_radius": np.full(len(alts), 120.0),
                      "mode_width": np.full(len(alts), 1.6)})
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    return config, geometry, viewing, atmo


def _dayglow_emission_parameters():
    """(Einstein A, g', g'', hot-band mask) of the dayglow cell's lines
    (numpy seed ``DAYGLOW_SEED``)."""
    rng = np.random.default_rng(DAYGLOW_SEED)
    n = O2A16_NUM_LINES
    einstein_a = rng.uniform(0.005, 0.1, n)
    g_upper = 2.0 * rng.integers(0, 31, n) + 1.0
    g_lower = 2.0 * rng.integers(0, 31, n) + 1.0
    hot = rng.uniform(size=n) < DAYGLOW_HOT_SHARE
    return einstein_a, g_upper, g_lower, hot


def dayglow_par_lines():
    """The 160-column HITRAN records of the dayglow cell's O2 line file:
    o2a16's lines (``_o2a16_lines``) with, from numpy seed
    ``DAYGLOW_SEED``, an Einstein A uniform in 0.005-0.1 s^-1, g' and g''
    of rotational levels (2J + 1, J up to 30), and the global quanta
    "b 1"/"X 1" (the hot band) for a ``DAYGLOW_HOT_SHARE`` of the lines,
    "b 0"/"X 0" for the rest, in the layout of
    ``tests/test_lineemission.py:93-116`` (delta_air in 8.5f, since a
    negative 8.6f takes 9 columns)."""
    lines = _o2a16_lines()
    einstein_a, g_upper, g_lower, hot = _dayglow_emission_parameters()
    rows = []
    for i in range(O2A16_NUM_LINES):
        qup, qlo = ("b 1", "X 1") if hot[i] else ("b 0", "X 0")
        row = (
            f"{7:2d}{1:1d}{lines['nu0'][i]:12.6f}"
            f"{lines['intensity'][i]:10.3E}{einstein_a[i]:10.3E}"
            f"{lines['gamma_air'][i]:5.3f}{lines['gamma_self'][i]:5.3f}"
            f"{lines['elower'][i]:10.4f}{lines['n_air'][i]:4.2f}"
            f"{lines['delta_air'][i]:8.5f}"
        )
        row += f"{qup:>15}{qlo:>15}"
        row += " " * (146 - len(row))
        row += f"{g_upper[i]:7.1f}{g_lower[i]:7.1f}"
        if len(row) != 160:
            msg = f"record {i} has {len(row)} columns, not 160"
            raise ValueError(msg)
        rows.append(row)
    return rows


def write_dayglow_par(db_root):
    """Write the dayglow cell's O2 line file where a HITRAN line database
    rooted at ``db_root`` reads it (``<db_root>/hitran/lines/O2.par``)
    and return its path."""
    path = os.path.join(db_root, "hitran", "lines", "O2.par")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(dayglow_par_lines()) + "\n")
    return path


def dayglow_container(sk):
    """The dayglow cell's ``LimbVertical`` container, of ``sk``."""
    return sk.viewinggeo.LimbVertical.from_tangent_parameters(
        sk.solar.SolarGeometryHandlerForced(60.0, 30.0),
        DAYGLOW_TANGENTS_M,
        tangent_latitude=20.0,
        tangent_longitude=40.0,
        time=None,
        observer_altitude=600000.0,
        viewing_azimuth=90.0,
        reference_altitude=80000.0,
    )


def dayglow_populations(sk, altitudes_m, temperature_k, pressure_pa,
                        latitude_deg=20.0):
    """O2(b, v = 0, 1, 2) number densities [m^-3] on ``altitudes_m`` from
    ``sk.photchem.Yankovsky().solve``: O2 and N2 from the pressure and
    temperature (VMR 0.2095 and 0.7808), O from
    ``sk.climatology.atomic_oxygen`` (month ``DAYGLOW_MONTH``), O3 and CO2
    fixed, and each photolysis channel at its reaction's published
    top-of-atmosphere rate at every altitude."""
    t = np.asarray(temperature_k, dtype=np.float64)
    n_air = np.asarray(pressure_pa, dtype=np.float64) / (
        sk.constants.K_BOLTZMANN * t)
    nz = t.size
    backgrounds = {
        "O2": 0.2095 * n_air,
        "N2": 0.7808 * n_air,
        "O": sk.climatology.atomic_oxygen.number_density(
            altitudes_m, DAYGLOW_MONTH, latitude_deg),
        "O3": np.full(nz, DAYGLOW_O3_M3),
        "CO2": np.full(nz, DAYGLOW_CO2_M3),
    }
    model = sk.photchem.Yankovsky()
    rates = {r.rate_name: np.full(nz, r.toa_rate_constant)
             for r in model.photo_reactions}
    pops = model.solve(t, backgrounds, rates)
    return {v: pops[f"O2(b, v={v})"] for v in (0, 1, 2)}


def dayglowlimb16_check_indices():
    """The 8 indices into ``DAYGLOW_WAVENUMBERS`` of the golden values:
    the cores of the 4 strongest emission lines in the grid (by
    Einstein A), the cores of the 2 strongest absorption lines among the
    rest, and the 2 grid points farthest from any line."""
    lines = _o2a16_lines()
    einstein_a = _dayglow_emission_parameters()[0]
    nu0, s = lines["nu0"], lines["intensity"]
    grid = DAYGLOW_WAVENUMBERS
    inside = (nu0 > grid[0] + 0.1) & (nu0 < grid[-1] - 0.1)
    # emission favours small E'' (the Boltzmann factor of E' at ~200 K)
    emit = np.where(inside, einstein_a * np.exp(
        -1.4387768775039339 * lines["elower"] / 200.0), 0.0)
    by_emission = list(np.argsort(emit)[::-1][:4])
    rest = np.where(inside, s, 0.0)
    rest[by_emission] = 0.0
    by_absorption = list(np.argsort(rest)[::-1][:2])
    picked = [int(np.argmin(np.abs(grid - nu0[i])))
              for i in by_emission + by_absorption]
    dist = np.min(np.abs(grid[:, None] - nu0[None, :]), axis=1)
    for i in np.argsort(dist)[::-1]:
        if all(abs(int(i) - j) > 25 for j in picked):
            picked.append(int(i))
        if len(picked) == 8:
            break
    return np.array(sorted(picked))


def dayglowlimb16_case(sk, dtype: str, wavenumbers_cminv,
                       emission="line_list", device=None):
    """(config, geometry, viewing, atmosphere) of the dayglow cell on
    ``wavenumbers_cminv``, built from ``sk``; the O2 line file must
    already be under ``sk``'s database root (``write_dayglow_par``).
    ``emission``: "line_list" (``LineListVolumeEmissionRate``) or
    "population" (``PopulationEmissionRate``). For the port, ``device``
    is where the line absorber and the emission spectra run (None: the
    GPU)."""
    port = sk.__name__.endswith("_torch")
    dev = {"device": device} if port else {}
    container = dayglow_container(sk)
    geometry = container.model_geometry(DAYGLOW_ALTITUDES_M)
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.Exact,
        emission_source=sk.EmissionSource.VolumeEmissionRate,
        num_singlescatter_moments=16,
        num_do_sza=2,
        dtype=dtype,
    )
    atmo = sk.Atmosphere(geometry, config,
                         wavenumbers_cminv=np.asarray(wavenumbers_cminv))
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    alts = geometry.altitudes()
    atmo["solar"] = sk.constituent.SolarIrradiance(
        irradiance=DAYGLOW_SOLAR_PHOTONS)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    catalogue = sk.database.HITRANLineDatabase().load_catalogue("O2")
    atmo["o2"] = sk.constituent.VMRAltitudeAbsorber(
        sk.optical.LineAbsorber(catalogue, **dev), alts,
        np.full(len(alts), 0.2095))
    pressure, temperature = sk.climatology.us76.us76_pressure_temperature(
        alts)
    pops = dayglow_populations(sk, alts, temperature, pressure)
    if emission == "population":
        atmo["airglow"] = sk.constituent.PopulationEmissionRate(
            {"altitude": alts, "temperature": temperature,
             "O2(b)": pops[0], "O2(b, v=1)": pops[1],
             "O2(b, v=2)": pops[2]},
            catalogue, **dev)
    else:
        phem = sk.photchem.emission
        band = phem.oxygen_a_band_from_catalogue(catalogue)
        ver, weights = phem.oxygen_a_band_line_list_weights_from_populations(
            band, temperature, pops[0], pops[1], pops[2])
        atmo["airglow"] = sk.constituent.LineListVolumeEmissionRate(
            alts, ver, band.wavelength_nm, weights, **dev)
    atmo["surface"] = sk.constituent.LambertianSurface(0.3)
    return config, geometry, container, atmo


def amf16_case(sk, dtype: str, wavelengths_nm):
    """``smoke_case`` with ``AirMassFactor``: the ``air_mass_factor``
    output, -d ln I / d tau of each layer, over a weak absorber of
    extinction ``AMF16_BACKGROUND_M1`` exp(-z / 8 km) as
    ``ManualOpticalProperties`` (``tests/test_amf.py:45-59``: about 5% of
    the Rayleigh extinction at 330 nm), so that the single-scatter albedo
    is below the solvers' ceiling of 1 - 1e-4 (``rt/disco.clamp_ssa``). In
    pure Rayleigh it sits on the ceiling, where the AMF is ill-posed: the
    JAX package's own two routes differ on it by 1.0e-4 of its largest
    magnitude at 4 streams (``tests/test_torch_misc_constituents.py``)."""
    config, geometry, viewing, atmo = smoke_case(sk, dtype, wavelengths_nm)
    alts = geometry.altitudes()
    atmo["background"] = sk.constituent.ManualOpticalProperties(
        extinction=AMF16_BACKGROUND_M1 * np.exp(-alts / 8000.0))
    atmo["amf"] = sk.constituent.AirMassFactor()
    return config, geometry, viewing, atmo


def tomo2d_case(sk, dtype: str, wavelengths_nm,
                num_altitudes=TOMO2D_NUM_ALTITUDES,
                angles_deg=TOMO2D_ANGLES_DEG):
    """(config, geometry, viewing, atmosphere) of the 2D tomographic limb
    cell, built from ``sk`` as ``smoke_case`` is: a ``Geometry2D`` of
    ``num_altitudes`` altitudes from 0 to 100 km by ``angles_deg``
    horizontal angles (cos_sza 0.6 at angle 0, the sun in the plane); 40
    ``TangentAltitude`` rays, 4 images at -6, -2, 2 and 6 degrees of 10
    tangent altitudes each (10-55 km, observer at 600 km); exact single
    scatter with 16 moments, no multiple scatter, the line-of-sight
    optical depth, full Jacobians; US76 pressure and temperature tiled
    over the angles with ``Rayleigh``, a ``NumberDensityScatterer2D``
    Henyey-Greenstein aerosol (xs 1e-13 m^2, ssa 0.95, g 0.7) peaking at
    20 km and growing twofold across the angles, and a ``VMRAbsorber2D``
    ozone-like absorber (an 8 ppm layer at 25 km, 0.8-1.2 across the
    angles) of a synthetic tabulated cross section with a UV and a
    visible band."""
    config = sk.Config(
        single_scatter_source=sk.SingleScatterSource.Exact,
        multiple_scatter_source=sk.MultipleScatterSource.NoSource,
        num_singlescatter_moments=16,
        output_los_optical_depth=True,
        dtype=dtype,
    )
    alts = np.linspace(0.0, 100000.0, num_altitudes)
    nh = len(angles_deg)
    geometry = sk.Geometry2D(
        cos_sza=0.6, solar_azimuth=0.0, earth_radius_m=6372000.0,
        altitude_grid_m=alts,
        horizontal_angle_grid_radians=np.deg2rad(angles_deg),
    )
    viewing = sk.ViewingGeometry()
    for image in TOMO2D_IMAGE_ANGLES_DEG:
        for talt in TOMO2D_TANGENTS_M:
            viewing.add_ray(sk.TangentAltitude(
                tangent_altitude_m=float(talt),
                observer_altitude_m=TOMO2D_OBSERVER_M,
                horizontal_angle_radians=float(np.deg2rad(image)),
                viewing_azimuth_radians=0.0,
            ))
    atmo = sk.Atmosphere(geometry, config, wavelengths_nm=wavelengths_nm)
    sk.climatology.us76.add_us76_standard_atmosphere(atmo)
    # Rayleigh on a 2D grid reads pressure and temperature per location
    atmo.pressure_pa = np.tile(atmo.pressure_pa, nh)
    atmo.temperature_k = np.tile(atmo.temperature_k, nh)
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    gauss = 1e6 * np.exp(-(((alts - 20000.0) / 8000.0) ** 2)) + 1.0
    atmo["aero"] = sk.constituent.NumberDensityScatterer2D(
        sk.constituent.HGScatteringOptical(
            xs_total=1e-13, ssa=0.95, g=0.7, nleg=16),
        np.outer(np.linspace(1.0, 2.0, nh), gauss),
    )
    xs_wl, xs = tomo2d_cross_section()
    atmo["ozone"] = sk.constituent.VMRAbsorber2D(
        sk.optical.TabulatedCrossSectionAbsorber(xs_wl, xs),
        np.outer(np.linspace(0.8, 1.2, nh),
                 8e-6 * np.exp(-(((alts - 25000.0) / 7000.0) ** 2))),
    )
    return config, geometry, viewing, atmo


def tomo2d_cross_section():
    """(wavelengths_nm, cross_section_m2) of tomo2d's absorber, on
    250-850 nm every 1 nm: 5e-25 exp(-((wl - 600) / 60)^2) + 1e-22
    exp(-((wl - 255) / 20)^2), a visible and a UV band (no ozone file is
    in the repository)."""
    wl = np.arange(250.0, 850.5, 1.0)
    return wl, (5e-25 * np.exp(-(((wl - 600.0) / 60.0) ** 2))
                + 1e-22 * np.exp(-(((wl - 255.0) / 20.0) ** 2)))


def golden_error(name, got, ref, stokes_axis=-1, qu_scale="own"):
    """The error of ``got`` against the golden ``ref`` by which a case is
    gated: for ``radiance`` and the ``*_flux`` variables the largest error
    relative to the element; for a polarized radiance (three Stokes
    components on ``stokes_axis``) I per element and Q, U relative to the
    largest |Q| and |U|, so that a component near zero is not held to
    itself; for ``wf_*`` and gradients the largest error relative to the
    variable's largest magnitude. Where the reference is exactly zero (the
    divergence flux of a conservative atmosphere) the error is absolute.
    The line-of-sight optical depth is gated per element, as radiance.
    ``qu_scale="I"`` holds Q and U to the largest |I| instead, for a case
    whose polarization is only a trace (thermal emission with the sun
    off)."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = np.abs(got - ref)

    def nonzero(x):
        return np.where(x > 0.0, x, 1.0)

    per_element = name in ("radiance", "los_optical_depth") or (
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
