"""sasktran2_tpu_torch — the PyTorch/CUDA port of sasktran2_tpu.

Same user contract as the JAX package, so a user changes one import line:

    import sasktran2_tpu_torch as sk
    engine = sk.Engine(config, geometry, viewing)   # runs on "cuda"
    out = engine.calculate_radiance(atmosphere)    # radiance + wf_*

The engine runs on the GPU unless the caller passes ``device="cpu"``; with
no GPU and no device named it raises. The configuration, geometry,
viewing-geometry, atmosphere, dataset and ray-tracing modules are the
port's own copies of the JAX package's numpy modules; the engine, the
solver and the constituents of the scalar slice are the port's. The
block-tridiagonal Thomas solve and the tournament-Jacobi eigensolve run as
hand-written CUDA kernels (``csrc/``) on a GPU. This package imports
nothing of jax or of ``sasktran2_tpu``.
"""

from .atmosphere import Atmosphere
from .config import (
    Config,
    EmissionSource,
    FluxType,
    GeometryType,
    InputValidationMode,
    InterpolationMethod,
    MultipleScatterSource,
    OccultationSource,
    SingleScatterSource,
    SpectralGridMode,
    StokesBasis,
)
from .dataset import DataArray, Dataset
from .geometry import Geometry1D
from .viewinggeo import (
    FluxObserverSolar,
    GroundViewingSolar,
    SolarAnglesObserverLocation,
    TangentAltitudeSolar,
    ViewingGeometry,
)

from . import (
    basis,
    climatology,
    constituent,
    database,
    legendre,
    mie,
    optical,
)
from .engine import Engine

__all__ = [
    "Atmosphere",
    "Config",
    "DataArray",
    "Dataset",
    "EmissionSource",
    "Engine",
    "FluxObserverSolar",
    "FluxType",
    "Geometry1D",
    "GeometryType",
    "GroundViewingSolar",
    "InputValidationMode",
    "InterpolationMethod",
    "MultipleScatterSource",
    "OccultationSource",
    "SingleScatterSource",
    "SolarAnglesObserverLocation",
    "SpectralGridMode",
    "StokesBasis",
    "TangentAltitudeSolar",
    "ViewingGeometry",
    "basis",
    "climatology",
    "constituent",
    "database",
    "legendre",
    "mie",
    "optical",
]
