"""Solar irradiance model and solar-angle handlers.

(Copy of ``sasktran2_tpu/solar/__init__.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from .model import SolarModel
from .geometry import (
    SolarGeometryHandlerAstropy,
    SolarGeometryHandlerBase,
    SolarGeometryHandlerEphemeris,
    SolarGeometryHandlerForced,
    solar_angles_from_times,
    to_mjd,
)

__all__ = [
    "SolarModel",
    "SolarGeometryHandlerAstropy",
    "SolarGeometryHandlerBase",
    "SolarGeometryHandlerEphemeris",
    "SolarGeometryHandlerForced",
    "solar_angles_from_times",
    "to_mjd",
]
