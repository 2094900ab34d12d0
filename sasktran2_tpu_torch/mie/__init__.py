"""Particle size distributions, refractive indices and Mie ensemble
integration of the PyTorch port (``sasktran2_tpu/mie/``)."""

from .distribution import (
    FrozenDistribution,
    GammaDistribution,
    LogNormalDistribution,
    ParticleSizeDistribution,
    TriangularDistribution,
    UniformDistribution,
    integrate_mie,
)
from .refractive import H2SO4, Dust, Ice, RefractiveIndex, Water

__all__ = [
    "H2SO4",
    "Dust",
    "FrozenDistribution",
    "GammaDistribution",
    "Ice",
    "LogNormalDistribution",
    "ParticleSizeDistribution",
    "RefractiveIndex",
    "TriangularDistribution",
    "UniformDistribution",
    "Water",
    "integrate_mie",
]
