"""Surface constituents of the port (counterpart of
``sasktran2_tpu/constituent/brdf.py``): ``LambertianSurface`` only, as a
numpy copy. BRDF surfaces come with the port's BRDF slice."""

from __future__ import annotations

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from .base import Constituent


class LambertianSurface(Constituent):
    """Wavelength-dependent Lambertian albedo. ``albedo`` may be a scalar or
    an array on ``wavelengths_nm`` (interpolated to the engine grid)."""

    def __init__(self, albedo, wavelengths_nm=None, wavelengths_interpolator=None):
        self.albedo = np.atleast_1d(np.asarray(albedo, dtype=np.float64))
        self.wavelengths_nm = (
            np.asarray(wavelengths_nm, dtype=np.float64)
            if wavelengths_nm is not None
            else None
        )

    def _albedo_on_grid(self, atmo):
        if self.albedo.size == 1:
            return np.full(atmo.num_wavelengths, self.albedo[0]), None
        if self.wavelengths_nm is None:
            if self.albedo.size != atmo.num_wavelengths:
                msg = "albedo array length must match the wavelength grid"
                raise ValueError(msg)
            return self.albedo.copy(), None
        interp = linear_interpolating_matrix(
            self.wavelengths_nm, atmo.wavelengths_nm, "extend"
        )
        return interp @ self.albedo, interp

    def add_to_atmosphere(self, atmo):
        alb, _ = self._albedo_on_grid(atmo)
        atmo.surface.albedo += alb

    def register_derivative(self, atmo, name: str):
        m = atmo.surface.get_derivative_mapping(f"wf_{name}_albedo")
        m.d_brdf[:] = 1.0
        m.interp_dim = "dummy"
