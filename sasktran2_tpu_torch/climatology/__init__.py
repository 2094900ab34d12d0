"""Climatologies of the port (numpy copies; importing them loads no jax)."""

from . import atomic_oxygen, glossac, mipas, us76
from .us76 import add_us76_standard_atmosphere, us76_pressure_temperature

__all__ = [
    "add_us76_standard_atmosphere",
    "atomic_oxygen",
    "glossac",
    "mipas",
    "us76",
    "us76_pressure_temperature",
]
