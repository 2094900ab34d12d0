"""Run configuration: ``Config`` and its enums.

Copy of ``sasktran2_tpu/config.py`` for the PyTorch port, which imports
nothing of the JAX package; ``tests/test_torch_host_copies.py`` pins its
defaults and enum values to the original's. The fields mirror the upstream
SASKTRAN2 configuration (``cpp/include/sasktran2/config.h:30-182``). The
engine runs every setting the JAX engine runs, in 1D and in 2D.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class SingleScatterSource(enum.Enum):
    """Single scatter source selection (reference ``config.h:34``)."""

    Exact = "exact"
    Table = "solartable"
    DiscreteOrdinates = "discrete_ordinates"
    NoSource = "none"


class MultipleScatterSource(enum.Enum):
    """Multiple scatter source selection (reference ``config.h:41``)."""

    DiscreteOrdinates = "discrete_ordinates"
    SuccessiveOrders = "hr"
    TwoStream = "twostream"
    NoSource = "none"


class EmissionSource(enum.Enum):
    """Emission source selection (reference ``config.h:49``)."""

    Standard = "standard"
    NoSource = "none"
    DiscreteOrdinates = "discrete_ordinates"
    VolumeEmissionRate = "volume_emission_rate"
    TwoStream = "twostream"


class OccultationSource(enum.Enum):
    """Occultation source selection (reference ``config.h:55``)."""

    Standard = "standard"
    NoSource = "none"


class StokesBasis(enum.Enum):
    Standard = "standard"
    Solar = "solar"
    Observer = "observer"


class ThreadingModel(enum.Enum):
    """Kept for API compatibility; on TPU all parallelism is expressed as
    batched array axes + sharding, so this is advisory only."""

    Wavelength = "wavelength"
    Source = "source"


class ThreadingLib(enum.Enum):
    """Kept for API compatibility (reference ``config.py:575-586``); no
    thread pools exist on the TPU build."""

    Rayon = "rayon"
    OpenMP = "openmp"


class TwoStreamBackend(enum.Enum):
    """Kept for API compatibility (reference ``TwoStreamBackend
    {cpp, rust}``); the TPU build has ONE unified two-stream path (the
    nstr=2 specialization of the batched DO solver), so the choice is
    accepted and ignored."""

    Cpp = "cpp"
    Rust = "rust"


class LogLevel(enum.IntEnum):
    """Engine log verbosity (reference spdlog levels plumbed through
    ``config.py:589-642``), mapped onto Python ``logging`` levels for the
    ``sasktran2_tpu`` logger."""

    Trace = 5
    Debug = 10
    Info = 20
    Warn = 30
    Error = 40
    Critical = 50
    Off = 100


class InputValidationMode(enum.Enum):
    Strict = "strict"
    Standard = "standard"
    Disabled = "disabled"


class SpectralGridMode(enum.Enum):
    Monochromatic = "monochromatic"
    AtmosphereIntegratedLineShape = "atmosphere_integrated_line_shape"
    EngineIntegratedLineShape = "engine_integrated_line_shape"


class GeometryType(enum.Enum):
    PlaneParallel = "planeparallel"
    PseudoSpherical = "pseudospherical"
    Spherical = "spherical"
    Ellipsoidal = "ellipsoidal"


class InterpolationMethod(enum.Enum):
    LinearInterpolation = "linear"
    LowerInterpolation = "lower"
    ShellInterpolation = "shell"


class FluxType(enum.Enum):
    Upwelling = 0
    Downwelling = 1
    Actinic = 2
    Divergence = 3


@dataclass
class Config:
    """All engine settings. Static (compile-time) configuration.

    Defaults follow the reference (``cpp/lib/config/config.cpp`` /
    ``src/sasktran2/config.py``).
    """

    # --- source selection -------------------------------------------------
    single_scatter_source: SingleScatterSource = SingleScatterSource.Exact
    multiple_scatter_source: MultipleScatterSource = MultipleScatterSource.NoSource
    emission_source: EmissionSource = EmissionSource.NoSource
    occultation_source: OccultationSource = OccultationSource.NoSource

    # --- core sizes -------------------------------------------------------
    num_streams: int = 16
    num_stokes: int = 1
    num_sza: int = 1
    num_forced_azimuth: int = -1
    do_backprop: bool = True

    # --- scattering options ----------------------------------------------
    delta_m_scaling: bool = False
    apply_delta_scaling: bool = False  # alias used by some reference tests

    # --- single scatter ---------------------------------------------------
    num_singlescatter_moments: int = 16
    singlescatter_phasefunction_from_tms: bool = False

    # --- successive orders ------------------------------------------------
    num_successive_orders_iterations: int = 50
    # reference default false (cpp/lib/config/config.cpp:22,
    # m_initialize_hr_with_do_solution)
    init_successive_orders_with_discrete_ordinates: bool = False
    num_successive_orders_points: int = 100
    num_successive_orders_incoming: int = 110
    num_successive_orders_outgoing: int = 110
    # diffuse-profile solar-zenith-angle grid for limb/twilight fidelity
    # (reference DiffuseTable SZA x altitude grid,
    # cpp/lib/hr/diffuse_table.cpp:224 + the altitude/SZA interpolator);
    # 1 = single profile at the reference-point SZA
    num_successive_orders_sza: int = 1

    # --- solar table ------------------------------------------------------
    num_solar_altitudes: int = -1  # -1 => use geometry grid
    num_solar_zenith_angles: int = -1

    # --- DO source interpolation grid ------------------------------------
    num_do_sza: int = 1

    # --- stokes / output --------------------------------------------------
    stokes_basis: StokesBasis = StokesBasis.Standard
    output_los_optical_depth: bool = False
    flux_types: tuple = (FluxType.Upwelling, FluxType.Downwelling)

    # --- threading / batching (advisory on TPU) --------------------------
    num_threads: int = 1
    threading_model: ThreadingModel = ThreadingModel.Wavelength
    threading_lib: ThreadingLib = ThreadingLib.Rayon
    two_stream_backend: TwoStreamBackend = TwoStreamBackend.Rust
    wavelength_batch_size: int = 128

    # --- logging ----------------------------------------------------------
    # setting a non-default level configures the `sasktran2_tpu_torch` logger
    # (see Config.__post_init__); reference default is Warn
    log_level: LogLevel = LogLevel.Warn

    # --- validation / refraction -----------------------------------------
    input_validation_mode: InputValidationMode = InputValidationMode.Standard
    los_refraction: bool = False
    solar_refraction: bool = False
    multiple_scatter_refraction: bool = False

    # --- spectral grid ----------------------------------------------------
    spectral_grid_mode: SpectralGridMode = SpectralGridMode.Monochromatic

    # --- TPU-specific -----------------------------------------------------
    dtype: str = "float64"  # "float32" on TPU benches, "float64" for CPU tests
    calculate_derivatives: bool = True
    wf_enabled_names: tuple | None = None  # restrict which wf_* outputs are built

    def __post_init__(self):
        if self.log_level != LogLevel.Warn:
            import logging

            level = (
                logging.CRITICAL + 10
                if self.log_level == LogLevel.Off
                else int(self.log_level)
            )
            logging.getLogger("sasktran2_tpu_torch").setLevel(level)
        # reference-compat aliases (previously accepted and silently
        # ignored): ``apply_delta_scaling`` is the reference tests' name
        # for delta_m_scaling; ``num_sza`` is the reference's SZA-grid
        # count for multiple-scatter sources (the repo's per-source knobs
        # are num_do_sza / num_successive_orders_sza)
        if self.apply_delta_scaling and not self.delta_m_scaling:
            self.delta_m_scaling = True
        if self.num_sza > 1:
            if self.num_do_sza == 1:
                self.num_do_sza = self.num_sza
            if self.num_successive_orders_sza == 1:
                self.num_successive_orders_sza = self.num_sza
        if self.singlescatter_phasefunction_from_tms:
            msg = (
                "singlescatter_phasefunction_from_tms (TMS single-scatter "
                "correction) is not implemented"
            )
            raise NotImplementedError(msg)

    def validate(self) -> None:
        if self.num_streams < 2 or self.num_streams % 2 != 0:
            msg = f"num_streams must be an even integer >= 2, got {self.num_streams}"
            raise ValueError(msg)
        if self.num_stokes not in (1, 3):
            msg = f"num_stokes must be 1 or 3, got {self.num_stokes}"
            raise ValueError(msg)
        if self.num_sza < 1:
            msg = "num_sza must be >= 1"
            raise ValueError(msg)
        if self.emission_source in (
            EmissionSource.DiscreteOrdinates, EmissionSource.TwoStream,
        ):
            # the DO/two-stream emission source is a term of the DO solve:
            # it requires the DO single-scatter mode and a DO-family
            # multiple-scatter source (reference engine validation,
            # tests/input_validation/test_emission_validation.py)
            if self.single_scatter_source != SingleScatterSource.DiscreteOrdinates:
                msg = (
                    "emission_source=DiscreteOrdinates/TwoStream requires "
                    "single_scatter_source=DiscreteOrdinates"
                )
                raise ValueError(msg)
            if self.multiple_scatter_source not in (
                MultipleScatterSource.DiscreteOrdinates,
                MultipleScatterSource.TwoStream,
            ):
                msg = (
                    "emission_source=DiscreteOrdinates/TwoStream requires "
                    "a discrete-ordinates multiple_scatter_source"
                )
                raise ValueError(msg)

    # convenience used throughout the solver stack
    @property
    def nstr(self) -> int:
        return self.num_streams

    @property
    def nstokes(self) -> int:
        return self.num_stokes


# Mutable default protection for flux_types handled by tuple default.
