"""Optical-property models of the port (numpy copies)."""

from .base import OpticalProperty
from .rayleigh import rayleigh_cross_section_bates
from .tabulated import TabulatedCrossSectionAbsorber

__all__ = [
    "OpticalProperty",
    "TabulatedCrossSectionAbsorber",
    "rayleigh_cross_section_bates",
]
