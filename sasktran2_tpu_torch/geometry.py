"""Model geometry containers.

API-compatible with the reference ``sasktran2.Geometry1D`` / ``Geometry2D``
(``upstream SASKTRAN2 src/sasktran2/geometry.py:16-110``) but pure Python/numpy:
on TPU all geometry is *static* host-side precompute that parameterizes the
jit-compiled radiative transfer pipeline.

(Copy of ``sasktran2_tpu/geometry.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from .config import GeometryType, InterpolationMethod


class Geometry1D:
    """One-dimensional (altitude-resolved) spherical or plane-parallel
    atmosphere geometry."""

    def __init__(
        self,
        cos_sza: float,
        solar_azimuth: float,
        earth_radius_m: float,
        altitude_grid_m: np.ndarray,
        interpolation_method: InterpolationMethod = InterpolationMethod.LinearInterpolation,
        geometry_type: GeometryType = GeometryType.Spherical,
        reference_latitude_deg: float | None = None,
        reference_longitude_deg: float = 0.0,
    ):
        """``GeometryType.Ellipsoidal`` traces on the osculating sphere at
        the reference point: when ``reference_latitude_deg`` is given, the
        supplied ``earth_radius_m`` is replaced by the WGS84 osculating-
        spheroid radius there (reference ``geodetic.cpp:283`` —
        the reference core otherwise treats the ellipsoidal enum
        identically to spherical in its ray tracers)."""
        altitude_grid_m = np.ascontiguousarray(altitude_grid_m, dtype=np.float64)
        if altitude_grid_m.ndim != 1 or len(altitude_grid_m) < 2:
            msg = "altitude_grid_m must be a 1D array with at least 2 entries"
            raise ValueError(msg)
        if np.any(np.diff(altitude_grid_m) <= 0):
            msg = "altitude_grid_m must be strictly increasing"
            raise ValueError(msg)
        if not -1.0 <= cos_sza <= 1.0:
            msg = f"cos_sza must be in [-1, 1], got {cos_sza}"
            raise ValueError(msg)

        if (
            geometry_type == GeometryType.Ellipsoidal
            and reference_latitude_deg is not None
        ):
            from .geodetic import Geodetic

            g = Geodetic().from_lat_lon_alt(
                reference_latitude_deg, reference_longitude_deg, 0.0
            )
            earth_radius_m, _ = g.osculating_spheroid()

        self.cos_sza = float(cos_sza)
        self.solar_azimuth = float(solar_azimuth)
        self.earth_radius_m = float(earth_radius_m)
        self._altitude_grid = altitude_grid_m
        self.interpolation_method = interpolation_method
        self.geometry_type = geometry_type

    def altitudes(self) -> np.ndarray:
        """The altitude grid in meters (matches reference
        ``Geometry1D.altitudes()``)."""
        return self._altitude_grid

    @property
    def num_altitudes(self) -> int:
        return len(self._altitude_grid)

    @property
    def num_layers(self) -> int:
        return len(self._altitude_grid) - 1

    @property
    def refractive_index(self) -> np.ndarray:
        """Refractive index profile on the altitude grid (defaults to 1)."""
        if not hasattr(self, "_refractive_index"):
            self._refractive_index = np.ones_like(self._altitude_grid)
        return self._refractive_index

    @refractive_index.setter
    def refractive_index(self, value: np.ndarray):
        value = np.ascontiguousarray(value, dtype=np.float64)
        if value.shape != self._altitude_grid.shape:
            msg = "refractive_index must match the altitude grid shape"
            raise ValueError(msg)
        self._refractive_index = value


class Geometry2D(Geometry1D):
    """Structured spherical (altitude x horizontal-angle) geometry.

    Currently supports the transmission/single-scatter subset, mirroring the
    reference restriction (``src/sasktran2/engine.py:80-104``).
    """

    def __init__(
        self,
        cos_sza: float,
        solar_azimuth: float,
        earth_radius_m: float,
        altitude_grid_m: np.ndarray,
        horizontal_angle_grid_radians: np.ndarray,
        interpolation_method: InterpolationMethod = InterpolationMethod.LinearInterpolation,
    ):
        super().__init__(
            cos_sza,
            solar_azimuth,
            earth_radius_m,
            altitude_grid_m,
            interpolation_method,
            GeometryType.Spherical,
        )
        angles = np.ascontiguousarray(horizontal_angle_grid_radians, dtype=np.float64)
        if angles.ndim != 1 or len(angles) < 2 or np.any(np.diff(angles) <= 0):
            msg = "horizontal_angle_grid_radians must be 1D strictly increasing"
            raise ValueError(msg)
        if angles[-1] - angles[0] >= np.pi:
            msg = "horizontal angle span must be less than pi"
            raise ValueError(msg)
        self._horizontal_angles = angles

    def horizontal_angles(self) -> np.ndarray:
        return self._horizontal_angles

    @property
    def num_horizontal(self) -> int:
        return len(self._horizontal_angles)
