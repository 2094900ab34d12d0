"""The engine cases that ``chip_smoke.py`` drives and that
``tools/make_torch_golden.py`` computes reference values for. All three
use a US76 + Rayleigh + Lambertian 0.3 atmosphere with weighting
functions on, 101 altitudes from 0 to 100 km (P = 100 layers),
cos_sza = 0.6, and the 1024-point grid ``np.linspace(280, 800, 1024)`` nm.

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
LIMB_TANGENTS_M = np.linspace(10000.0, 80000.0, 20)


def smoke_wavelengths():
    return np.linspace(280.0, 800.0, NUM_WAVELENGTHS)


def smoke_case(sk, dtype: str, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of the case, built from
    ``sk``: the port (``sasktran2_tpu_torch``) or the JAX package
    (``sasktran2_tpu``), whose classes and constituents mirror each
    other."""
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.DiscreteOrdinates,
        num_singlescatter_moments=16,
        dtype=dtype,
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


def _geometry(sk, geometry_type):
    return sk.Geometry1D(
        cos_sza=0.6,
        solar_azimuth=0.0,
        earth_radius_m=6372000.0,
        altitude_grid_m=np.linspace(0.0, 100000.0, 101),
        geometry_type=geometry_type,
    )


def limb_case(sk, dtype: str, wavelengths_nm):
    """(config, geometry, viewing, atmosphere) of the 16-stream limb scan,
    built from ``sk`` as ``smoke_case`` is."""
    config = sk.Config(
        num_streams=16,
        multiple_scatter_source=sk.MultipleScatterSource.DiscreteOrdinates,
        single_scatter_source=sk.SingleScatterSource.Exact,
        num_singlescatter_moments=16,
        num_do_sza=2,
        dtype=dtype,
    )
    geometry = _geometry(sk, sk.GeometryType.Spherical)
    viewing = sk.ViewingGeometry()
    for talt in LIMB_TANGENTS_M:
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
