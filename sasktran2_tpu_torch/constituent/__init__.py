"""Constituents of the port: numpy copies of the JAX package's, so that
building an atmosphere never loads jax."""

from .base import Constituent
from .brdf import MODIS, LambertianSurface, SnowKokhanovsky, WeightedBRDF
from .emission import (
    LineListVolumeEmissionRate,
    PopulationEmissionRate,
    SurfaceThermalEmission,
    ThermalEmission,
    VolumeEmissionRate,
    planck_blackbody_radiance,
)
from .misc import (
    AirMassFactor,
    CollisionInducedAbsorber,
    ManualOpticalProperties,
    SolarIrradiance,
)
from .rayleigh import Rayleigh
from .scatterer import (
    ExtinctionScatterer,
    ExtinctionScatterer2D,
    GaussianHeightExtinction,
    HGScatteringOptical,
    MieScatteringOptical,
    NumberDensityScatterer,
    NumberDensityScatterer2D,
)
from .vmr_absorber import VMRAbsorber2D, VMRAltitudeAbsorber

# the reference's names for them
Manual = ManualOpticalProperties
MonochromaticVolumeEmissionRate = VolumeEmissionRate

__all__ = [
    "MODIS",
    "AirMassFactor",
    "CollisionInducedAbsorber",
    "Constituent",
    "ExtinctionScatterer",
    "ExtinctionScatterer2D",
    "GaussianHeightExtinction",
    "HGScatteringOptical",
    "LambertianSurface",
    "LineListVolumeEmissionRate",
    "Manual",
    "ManualOpticalProperties",
    "MieScatteringOptical",
    "MonochromaticVolumeEmissionRate",
    "NumberDensityScatterer",
    "NumberDensityScatterer2D",
    "PopulationEmissionRate",
    "Rayleigh",
    "SnowKokhanovsky",
    "SolarIrradiance",
    "SurfaceThermalEmission",
    "ThermalEmission",
    "VMRAbsorber2D",
    "VMRAltitudeAbsorber",
    "VolumeEmissionRate",
    "WeightedBRDF",
    "planck_blackbody_radiance",
]
