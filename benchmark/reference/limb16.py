"""The plain reference of the ``limb16`` configuration: radiance and weighting
functions of its rays, float64 by default, from ``plain.model``
(which reads the geometry, rays and solver from the configuration)."""

from .plain.model import WF_NAMES, radiance, reference

__all__ = ["WF_NAMES", "radiance", "reference"]
