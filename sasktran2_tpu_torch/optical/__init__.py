"""Optical-property models of the port: numpy copies of the JAX package's
host models (Rayleigh, tabulated, named and database cross sections, the
Baum ice crystals, Henyey-Greenstein, the Ciddor refractive index), and
the line-by-line absorber and the Mie solution,
which run on the device."""

from .base import OpticalProperty
from .baum import BaumIceCrystal
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
from .named import (
    HITRANUV,
    HITRANCollision,
    HITRANTabulated,
    NO2Vandaele,
    O3BirkWagner,
    O3DBM,
    O3Serdyuchenko,
)
from .rayleigh import rayleigh_cross_section_bates
from .tabulated import TabulatedCrossSectionAbsorber

__all__ = [
    "AERLineAbsorber",
    "AbsorberDatabase",
    "BaumIceCrystal",
    "HITRANCollision",
    "HITRANTabulated",
    "HITRANUV",
    "HenyeyGreenstein",
    "LineAbsorber",
    "LineCatalogue",
    "MieOutput",
    "NO2Vandaele",
    "O3BirkWagner",
    "O3DBM",
    "O3Serdyuchenko",
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

from . import refraction  # noqa: E402  (submodule: sk.optical.refraction)
