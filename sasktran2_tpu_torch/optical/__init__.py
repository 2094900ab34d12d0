"""Optical-property models of the port: numpy copies of the JAX package's
host models (Rayleigh, tabulated and database cross sections,
Henyey-Greenstein), and the line-by-line absorber and the Mie solution,
which run on the device."""

from .base import OpticalProperty
from .database import (
    AbsorberDatabase,
    OpticalDatabaseGenericAbsorber,
    OpticalDatabaseGenericScatterer,
    ScattererDatabase,
)
from .henyey import HenyeyGreenstein
from .line_absorber import (
    AERLineAbsorber,
    LineAbsorber,
    LineCatalogue,
    load_aer_line_file,
    load_hitran_par,
)
from .lineshape import voigt_profile, voigt_profile_complex, wofz
from .mie import MieOutput, compute_mie, mie_amplitudes, mie_efficiencies
from .rayleigh import rayleigh_cross_section_bates
from .tabulated import TabulatedCrossSectionAbsorber

__all__ = [
    "AERLineAbsorber",
    "AbsorberDatabase",
    "HenyeyGreenstein",
    "LineAbsorber",
    "LineCatalogue",
    "MieOutput",
    "OpticalDatabaseGenericAbsorber",
    "OpticalDatabaseGenericScatterer",
    "OpticalProperty",
    "ScattererDatabase",
    "TabulatedCrossSectionAbsorber",
    "compute_mie",
    "load_aer_line_file",
    "load_hitran_par",
    "mie_amplitudes",
    "mie_efficiencies",
    "rayleigh_cross_section_bates",
    "voigt_profile",
    "voigt_profile_complex",
    "wofz",
]
