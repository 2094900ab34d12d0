"""Constituents of the port: numpy copies of the JAX package's, so that
building an atmosphere never loads jax."""

from .base import Constituent
from .brdf import MODIS, LambertianSurface, SnowKokhanovsky, WeightedBRDF
from .emission import (
    SurfaceThermalEmission,
    ThermalEmission,
    VolumeEmissionRate,
    planck_blackbody_radiance,
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
from .vmr_absorber import VMRAltitudeAbsorber

# the reference's name for it
MonochromaticVolumeEmissionRate = VolumeEmissionRate

__all__ = [
    "MODIS",
    "Constituent",
    "ExtinctionScatterer",
    "ExtinctionScatterer2D",
    "GaussianHeightExtinction",
    "HGScatteringOptical",
    "LambertianSurface",
    "MieScatteringOptical",
    "MonochromaticVolumeEmissionRate",
    "NumberDensityScatterer",
    "NumberDensityScatterer2D",
    "Rayleigh",
    "SnowKokhanovsky",
    "SurfaceThermalEmission",
    "ThermalEmission",
    "VMRAltitudeAbsorber",
    "VolumeEmissionRate",
    "WeightedBRDF",
    "planck_blackbody_radiance",
]
