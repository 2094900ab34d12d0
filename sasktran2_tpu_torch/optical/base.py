"""Optical property ABC (reference ``src/sasktran2/optical/base.py:23-45``).

(Numpy copy of ``sasktran2_tpu/optical/base.py`` for the PyTorch
port; a test pins it to the original.)
"""

from __future__ import annotations

import abc


class OpticalProperty(abc.ABC):
    @abc.abstractmethod
    def cross_sections(
        self, wavelengths_nm, altitudes_m=None, pressure_pa=None,
        temperature_k=None, **kwargs,
    ):
        """Cross section [m^2] on the (altitude x wavelength) grid."""
