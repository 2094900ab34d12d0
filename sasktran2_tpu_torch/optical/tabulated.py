"""Tabulated cross-section absorber (wavelength, optional temperature axis).

Capability subset of the reference's N-dimensional absorber databases
(``rust/sasktran2-rs/src/optical/types/xsec_dbase.rs``).

(Numpy copy of ``sasktran2_tpu/optical/tabulated.py`` for the PyTorch
port; a test pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from .base import OpticalProperty


class TabulatedCrossSectionAbsorber(OpticalProperty):
    def __init__(self, wavelengths_nm, cross_section_m2, temperature_k=None):
        """cross_section_m2: [n_wavel] or [n_temp, n_wavel] with
        ``temperature_k`` the temperature grid."""
        self.wavelengths_nm = np.asarray(wavelengths_nm, dtype=np.float64)
        self.xs = np.asarray(cross_section_m2, dtype=np.float64)
        self.temperature_k = (
            np.asarray(temperature_k, dtype=np.float64)
            if temperature_k is not None
            else None
        )

    def cross_sections(
        self, wavelengths_nm, altitudes_m=None, pressure_pa=None,
        temperature_k=None, **kwargs,
    ):
        wmat = linear_interpolating_matrix(
            self.wavelengths_nm, np.atleast_1d(wavelengths_nm), "extend"
        )
        if self.xs.ndim == 1:
            xs_w = wmat @ self.xs  # [W]
            nalt = len(altitudes_m) if altitudes_m is not None else 1
            return np.broadcast_to(xs_w, (nalt, len(xs_w))).copy()
        # temperature-dependent: interpolate in T per altitude
        tmat = linear_interpolating_matrix(
            self.temperature_k, np.atleast_1d(temperature_k), "extend"
        )  # [A, n_temp]
        xs_tw = self.xs @ wmat.T  # [n_temp, W]
        return tmat @ xs_tw  # [A, W]
