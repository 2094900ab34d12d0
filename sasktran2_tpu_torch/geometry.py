"""Model geometry container.

API-compatible with the reference ``sasktran2.Geometry1D`` / ``Geometry2D``
(``upstream SASKTRAN2 src/sasktran2/geometry.py:16-110``) but pure Python/numpy:
on TPU all geometry is *static* host-side precompute that parameterizes the
jit-compiled radiative transfer pipeline.

(Copy of ``sasktran2_tpu/geometry.py`` for the PyTorch port: ``Geometry1D``
only. The Ellipsoidal osculating-sphere radius and ``Geometry2D`` are not
ported yet; see ROADMAP.)
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
        """``GeometryType.Ellipsoidal`` with a ``reference_latitude_deg``
        (the WGS84 osculating-sphere radius) raises ``NotImplementedError``;
        without one it traces as spherical, as in the JAX package."""
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
            msg = (
                "GeometryType.Ellipsoidal with a reference latitude is not "
                "ported to the PyTorch engine yet (ROADMAP, Next: "
                "Ellipsoidal geometry)"
            )
            raise NotImplementedError(msg)

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

