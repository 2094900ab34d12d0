"""Viewing geometry policies.

API-compatible with the reference wrappers
(``upstream SASKTRAN2 src/sasktran2/viewinggeo/wrappers.py:13-321``). Each ray
policy resolves — given the model geometry — to an *observer ray* description
(observer radius, look-direction zenith cosine at a reference location,
relative solar azimuth, and per-ray cos-SZA) that the host-side ray tracer
consumes to produce static traced-ray tables.

(Copy of ``sasktran2_tpu/viewinggeo/__init__.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class ViewingGeometry:
    """Container of observer rays (reference ``ViewingGeometryContainer``)."""

    def __init__(self):
        self._rays = []
        self._flux_observers = []

    def add_ray(self, ray):
        self._rays.append(ray)

    def add_flux_observer(self, observer):
        self._flux_observers.append(observer)

    @property
    def observer_rays(self):
        return self._rays

    @property
    def flux_observers(self):
        return self._flux_observers


@dataclass
class TangentAltitudeSolar:
    """Limb-viewing ray defined by its tangent point.

    Parameters mirror the reference (``viewinggeo/wrappers.py:177``):
    tangent altitude [m], relative solar azimuth at the tangent point [rad],
    observer altitude [m], and cos(SZA) at the tangent point.
    """

    tangent_altitude_m: float
    relative_azimuth: float
    observer_altitude_m: float
    cos_sza: float


@dataclass
class TangentAltitude:
    """Geometry-relative limb ray (reference ``wrappers.py:126``)."""

    tangent_altitude_m: float
    observer_altitude_m: float
    horizontal_angle_radians: float = 0.0
    viewing_azimuth_radians: float = 0.0


@dataclass
class GroundViewingSolar:
    """Downward-looking ray with angles defined at the ground point
    (reference ``wrappers.py:218``)."""

    cos_sza: float
    relative_azimuth: float
    cos_viewing_zenith: float
    observer_altitude_m: float


@dataclass
class SolarAnglesObserverLocation:
    """Ray with angles defined at the observer location
    (reference ``wrappers.py:258``). Positive ``cos_viewing_zenith`` looks up,
    negative looks down."""

    cos_sza: float
    relative_azimuth: float
    cos_viewing_zenith: float
    observer_altitude_m: float


@dataclass
class FluxObserverSolar:
    """Location inside the atmosphere at which fluxes are evaluated."""

    cos_sza: float
    observer_altitude_m: float


from .containers import (  # noqa: E402  (depends on the classes above)
    LimbVertical,
    ViewingGeometryContainer,
    ecef_to_sasktran2_ray,
)

__all__ = [
    "FluxObserverSolar",
    "GroundViewingSolar",
    "LimbVertical",
    "SolarAnglesObserverLocation",
    "TangentAltitude",
    "TangentAltitudeSolar",
    "ViewingGeometry",
    "ViewingGeometryContainer",
    "ecef_to_sasktran2_ray",
]
