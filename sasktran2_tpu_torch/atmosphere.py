"""Atmosphere state container and derivative-mapping registry.

Mirrors the reference Python ``sasktran2.Atmosphere``
(``upstream SASKTRAN2 src/sasktran2/atmosphere.py``) and the C++ storage
(``cpp/include/sasktran2/atmosphere/grid_storage.h:22-355``): mutable numpy
storage for extinction / ssa / Legendre coefficients / emission on the
(altitude x wavelength) grid, populated either directly ("raw input mode")
or through constituents, plus per-name derivative mappings that turn the
engine's core-space gradients (d radiance / d extinction, ssa, leg, ...)
into user weighting functions (``wf_*``).

Design note: this container is host-side state. The constituent pipeline
runs in numpy exactly once per calculation, like the reference, in
``internal_object()``. Its handoff to the engine is the storage's own
arrays as they lie (``internal_object(native=True)``: [A, W] and the
Legendre stack [L or 4L, A, W], no copy); the engine uploads them and
makes its wavelength-leading tensors on the device. Called plainly,
``internal_object()`` returns those tensors' layout as a dict of numpy
copies (``wavelength_leading``), the dict the JAX package's
``internal_object()`` returns.

(Copy of ``sasktran2_tpu/atmosphere.py`` for the PyTorch port: every
spectral grid mode, the two integrated line-shape modes included; on a ``Geometry2D`` the storage holds one row per location,
``angle * nalt + alt``.)
"""

from __future__ import annotations

import logging

import numpy as np

from . import spans
from .basis import Grid, mapping_matrix
from .config import Config, EmissionSource, SpectralGridMode


class NativeDerivativeMapping:
    """One derivative mapping in core (extinction/ssa/legendre/emission)
    space (reference ``derivative_mapping.h:18-80``).

    The user weighting function is assembled as
        wf_x[out] = sum_alt interp[out, alt] * (
              d_extinction[alt, w] * dI/dk[alt, w]
            + d_ssa[alt, w]        * dI/dssa[alt, w]
            + scat_factor[alt, w] * sum_l d_leg_coeff[l, alt, w] * dI/dbeta[l, alt, w]
            + d_emission[alt, w]   * dI/demission[alt, w] )
    """

    def __init__(self, nalt, nwavel, nleg=0):
        self.d_extinction = np.zeros((nalt, nwavel))
        self.d_ssa = np.zeros((nalt, nwavel))
        self.d_emission = np.zeros((nalt, nwavel))
        self.d_leg_coeff = np.zeros((nleg, nalt, nwavel)) if nleg else None
        self.scat_factor = np.ones((nalt, nwavel))
        self.interpolator = None  # [nout, nalt] or None (identity)
        self.interp_dim = "altitude"
        self.assign_name = ""
        self.log_radiance_space = False

    def ensure_leg(self, nleg):
        if self.d_leg_coeff is None or self.d_leg_coeff.shape[0] < nleg:
            old = self.d_leg_coeff
            self.d_leg_coeff = np.zeros(
                (nleg, self.d_extinction.shape[0], self.d_extinction.shape[1])
            )
            if old is not None:
                self.d_leg_coeff[: old.shape[0]] = old


class SurfaceDerivativeMapping:
    """Surface (BRDF-argument) derivative mapping."""

    def __init__(self, nwavel, nargs=1):
        self.d_brdf = np.zeros((nwavel, nargs))
        self.interpolator = None
        self.interp_dim = "dummy"


class LegendreStorageView:
    """a1/a2/a3/b1 accessors over the stacked Legendre tensor (reference
    ``src/sasktran2/polarization/__init__.py:6-66``). Scalar mode exposes
    only a1."""

    def __init__(self, leg_coeff: np.ndarray, nstokes: int):
        self._leg = leg_coeff
        self._nstokes = nstokes

    @property
    def a1(self):
        if self._nstokes == 1:
            return self._leg
        return self._leg[0::4]

    @property
    def a2(self):
        if self._nstokes == 1:
            msg = "a2 requires num_stokes = 3"
            raise ValueError(msg)
        return self._leg[1::4]

    @property
    def a3(self):
        if self._nstokes == 1:
            msg = "a3 requires num_stokes = 3"
            raise ValueError(msg)
        return self._leg[2::4]

    @property
    def b1(self):
        if self._nstokes == 1:
            msg = "b1 requires num_stokes = 3"
            raise ValueError(msg)
        return self._leg[3::4]


class AtmosphereStorage:
    """Raw optical-property storage on the (location x wavelength) grid."""

    def __init__(self, nalt, nwavel, nleg, nstokes):
        stack = nleg if nstokes == 1 else 4 * nleg
        self.total_extinction = np.zeros((nalt, nwavel))
        self.ssa = np.zeros((nalt, nwavel))
        self.emission_source = np.zeros((nalt, nwavel))
        self.leg_coeff = np.zeros((stack, nalt, nwavel))
        self.solar_irradiance = np.ones(nwavel)
        self.f = np.zeros((nalt, nwavel))  # delta-m fraction
        self._nstokes = nstokes
        self._derivative_mappings: dict[str, NativeDerivativeMapping] = {}

    @property
    def nalt(self):
        return self.total_extinction.shape[0]

    @property
    def nwavel(self):
        return self.total_extinction.shape[1]

    @property
    def nleg(self):
        if self._nstokes == 1:
            return self.leg_coeff.shape[0]
        return self.leg_coeff.shape[0] // 4

    def set_zero(self):
        self.total_extinction[:] = 0
        self.ssa[:] = 0
        self.emission_source[:] = 0
        self.leg_coeff[:] = 0
        self.f[:] = 0

    def normalize_by_extinctions(self):
        """Constituents accumulate k_total in total_extinction, k_scat in
        ssa, and k_scat-weighted legendre in leg_coeff; convert to intensive
        quantities (reference ``grid_storage.h:293``)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            self.leg_coeff /= np.where(self.ssa == 0.0, 1.0, self.ssa)[None]
            self.ssa /= np.where(
                self.total_extinction == 0.0, 1.0, self.total_extinction
            )
        np.nan_to_num(self.leg_coeff, copy=False)
        np.nan_to_num(self.ssa, copy=False)

    def get_derivative_mapping(self, name) -> NativeDerivativeMapping:
        if name not in self._derivative_mappings:
            self._derivative_mappings[name] = NativeDerivativeMapping(
                self.nalt, self.nwavel
            )
        return self._derivative_mappings[name]

    @property
    def derivative_mappings(self):
        return self._derivative_mappings


class Surface:
    """Lambertian surface (wavelength-dependent albedo). BRDFs are layered
    on top by the brdf constituents."""

    def __init__(self, nwavel):
        self.albedo = np.zeros(nwavel)
        self.emission = np.zeros(nwavel)
        self.brdf = None  # optional BRDF kernel object (rt/brdf.py)
        self.brdf_args = None  # [nwavel, nargs] when brdf is set
        self._derivative_mappings: dict[str, SurfaceDerivativeMapping] = {}
        self._nwavel = nwavel

    def set_zero(self):
        self.albedo[:] = 0
        self.emission[:] = 0
        self.brdf = None
        self.brdf_args = None

    def get_derivative_mapping(self, name) -> SurfaceDerivativeMapping:
        if name not in self._derivative_mappings:
            self._derivative_mappings[name] = SurfaceDerivativeMapping(
                self._nwavel
            )
        return self._derivative_mappings[name]

    @property
    def derivative_mappings(self):
        return self._derivative_mappings


class Atmosphere:
    """User-facing atmosphere (reference ``sasktran2.Atmosphere``)."""

    def __init__(
        self,
        model_geometry,
        config: Config,
        wavelengths_nm=None,
        wavenumbers_cminv=None,
        numwavel=None,
        calculate_derivatives: bool = True,
        calculate_emission_derivatives: bool = False,
        pressure_derivative: bool = True,
        temperature_derivative: bool = True,
        specific_humidity_derivative: bool = True,
        spectral_grid=None,
    ):
        self.model_geometry = model_geometry
        self.config = config
        self._integrated_lineshape = (
            config.spectral_grid_mode
            == SpectralGridMode.AtmosphereIntegratedLineShape
        )
        # EngineIntegratedLineShape: the ENGINE runs on the fine grid and
        # the output radiances/WFs are mapped onto the output basis
        # afterwards (reference rebasis grid mapping,
        # ``rust/rebasis/src/grid.rs:64``, applied at engine output)
        self._engine_lineshape = (
            config.spectral_grid_mode
            == SpectralGridMode.EngineIntegratedLineShape
        )
        self._spectral_grid = spectral_grid
        self._spectral_reduce = None
        if self._integrated_lineshape or self._engine_lineshape:
            if spectral_grid is None:
                msg = (
                    f"SpectralGridMode.{config.spectral_grid_mode.name} "
                    "requires a spectral_grid (output basis) on the "
                    "Atmosphere"
                )
                raise ValueError(msg)
            if wavelengths_nm is None and wavenumbers_cminv is None:
                msg = (
                    "integrated line shape mode requires an explicit fine "
                    "grid (wavelengths_nm or wavenumbers_cminv)"
                )
                raise ValueError(msg)

        if wavelengths_nm is not None:
            self.wavelengths_nm = np.atleast_1d(
                np.asarray(wavelengths_nm, dtype=np.float64)
            )
        elif wavenumbers_cminv is not None:
            wvn = np.atleast_1d(np.asarray(wavenumbers_cminv, dtype=np.float64))
            self.wavelengths_nm = 1e7 / wvn
            self.wavenumbers_cminv = wvn
        elif numwavel is not None:
            self.wavelengths_nm = None
            self._numwavel = numwavel
        else:
            msg = "One of wavelengths_nm, wavenumbers_cminv, numwavel required"
            raise ValueError(msg)

        nw = (
            len(self.wavelengths_nm)
            if self.wavelengths_nm is not None
            else numwavel
        )
        from .geometry import Geometry2D

        if isinstance(model_geometry, Geometry2D):
            nalt = model_geometry.num_horizontal * model_geometry.num_altitudes
        else:
            nalt = model_geometry.num_altitudes
        nleg = max(config.num_streams, config.num_singlescatter_moments)
        if self._integrated_lineshape or self._engine_lineshape:
            # constituents evaluate on the fine grid; the storage is reduced
            # onto the output basis grid after the pipeline (reference
            # ``rust/sasktran2-rs/src/optical/traits.rs:59-76``:
            # UpsampledStorageInputs + reduce_optical via mapping_matrix)
            if wavenumbers_cminv is not None:
                fine = Grid.from_deltas(
                    np.sort(np.atleast_1d(
                        np.asarray(wavenumbers_cminv, dtype=np.float64)
                    ))
                )
                # output wavelengths from the basis centers (wavenumber
                # coordinate)
                self._output_wavelengths_nm = 1e7 / np.asarray(
                    spectral_grid.centers
                )
            else:
                fine = Grid.from_deltas(np.sort(self.wavelengths_nm))
                self._output_wavelengths_nm = np.asarray(
                    spectral_grid.centers
                )
            # fine inputs must be sorted for the interp rows; require it so
            # column order matches the user's wavelength arrays
            fine_coord = (
                np.atleast_1d(np.asarray(wavenumbers_cminv, dtype=np.float64))
                if wavenumbers_cminv is not None
                else self.wavelengths_nm
            )
            if not np.all(np.diff(fine_coord) > 0):
                msg = "integrated line shape mode requires a sorted fine grid"
                raise ValueError(msg)
            self._spectral_reduce = mapping_matrix(fine, spectral_grid)
            self._nfine = nw
            self._nout = len(spectral_grid)
        else:
            self._output_wavelengths_nm = None
        self._nalt_storage = nalt
        self._nleg_storage = nleg
        self.storage = AtmosphereStorage(nalt, nw, nleg, config.num_stokes)
        self.surface = Surface(nw)
        self.calculate_derivatives = calculate_derivatives
        self.calculate_emission_derivatives = calculate_emission_derivatives

        self._constituents: dict = {}
        self._storage_needs_reset = False
        self._unscaled_ssa = None
        self._unscaled_extinction = None
        self.pressure_pa = None
        self.temperature_k = None
        self.specific_humidity = None
        self._leg_view = LegendreStorageView(
            self.storage.leg_coeff, config.num_stokes
        )
        self._applied_delta_m_order = None

    # --- constituent interface -------------------------------------------
    def __setitem__(self, name, constituent):
        self._constituents[name] = constituent

    def __getitem__(self, name):
        return self._constituents.get(name)

    def __contains__(self, name):
        return name in self._constituents

    @property
    def leg_coeff(self) -> LegendreStorageView:
        return self._leg_view

    @property
    def nstokes(self):
        return self.config.num_stokes

    @property
    def num_wavelengths(self):
        return self.storage.nwavel

    @property
    def unscaled_ssa(self):
        return self._unscaled_ssa

    @property
    def unscaled_extinction(self):
        return self._unscaled_extinction

    def altitudes(self):
        return self.model_geometry.altitudes()

    # --- pipeline ---------------------------------------------------------
    @spans.spanned("atmosphere")
    def internal_object(self, *, native: bool = False) -> dict:
        """Run the constituent pipeline (reference ``atmosphere.py:700-835``)
        and return the core arrays: the wavelength-leading numpy copies of
        ``wavelength_leading``, or with ``native`` the storage's own arrays
        without a copy (``_native_core``), which the engine uploads as they
        lie. The ``layout`` span counts ``host_bytes``, the bytes copied."""
        if len(self._constituents) > 0:
            logging.debug("Setting atmosphere from constituents")
            if (
                self._integrated_lineshape
                and self.storage.nwavel != self._nfine
            ):
                # previous run reduced the storage; rebuild at fine size
                self.storage = AtmosphereStorage(
                    self._nalt_storage, self._nfine, self._nleg_storage,
                    self.nstokes,
                )
                self.surface = Surface(self._nfine)
                self._leg_view = LegendreStorageView(
                    self.storage.leg_coeff, self.nstokes
                )
            with spans.span("zero"):
                self.storage.set_zero()
                self.surface.set_zero()
                self.storage._derivative_mappings = {}
                self.surface._derivative_mappings = {}
            try:
                for name, constituent in self._constituents.items():
                    with spans.span("constituent", key=name, phase="add"):
                        constituent.add_to_atmosphere(self)
                with spans.span("normalize"):
                    self.storage.normalize_by_extinctions()
                if self.calculate_derivatives:
                    for name, constituent in self._constituents.items():
                        with spans.span("constituent", key=name,
                                        phase="derivative"):
                            constituent.register_derivative(self, name)
            except Exception:
                self.storage.set_zero()
                self.storage._derivative_mappings = {}
                raise
        elif self.calculate_derivatives and not self.storage._derivative_mappings:
            # raw input mode: unit mappings for extinction/ssa/albedo
            m = self.storage.get_derivative_mapping("wf_extinction")
            m.d_extinction[:] = 1.0
            m = self.storage.get_derivative_mapping("wf_ssa")
            m.d_ssa[:] = 1.0
            sm = self.surface.get_derivative_mapping("wf_albedo")
            sm.d_brdf[:] = 1.0
            if self.config.emission_source != EmissionSource.NoSource:
                m = self.storage.get_derivative_mapping("wf_emission")
                m.d_emission[:] = 1.0

        if (
            self._integrated_lineshape
            and self.storage.nwavel == self._nfine
            and self._nfine != self._nout
        ):
            self._reduce_spectral()

        self._unscaled_ssa = self.storage.ssa.copy()
        self._unscaled_extinction = self.storage.total_extinction.copy()

        if self.config.delta_m_scaling:
            self._apply_delta_m_scaling()

        with spans.span("layout") as span:
            core = self._native_core()
            if not native:
                core = wavelength_leading(core, self.nstokes, _host_transpose)
            if span:
                span.count(host_bytes=0 if native else sum(
                    v.nbytes for v in core.values()))
            return core

    def _reduce_spectral(self):
        """Reduce the fine-grid storage onto the output basis grid
        (integrated line shape mode). Extensive quantities (k, k_scat,
        k_scat-weighted greeks) reduce linearly with the mapping matrix and
        are then renormalized — the same order as the reference's
        ``reduce_optical`` (linear in cross sections, before normalization).
        Derivative mappings get the matching quotient-rule chain."""
        M = self._spectral_reduce  # [Wo, Wf]

        def red(x):
            # reduce the trailing wavelength axis
            return x @ M.T

        s = self.storage
        k_f = s.total_extinction          # [A, Wf]
        w_f = s.ssa
        ks_f = k_f * w_f
        k_o = red(k_f)
        ks_o = red(ks_f)
        w_o = np.divide(ks_o, k_o, out=np.zeros_like(ks_o), where=k_o > 0)
        beta_f = s.leg_coeff              # [L*, A, Wf] (intensive)
        kb_o = red(ks_f[None] * beta_f)
        beta_o = np.divide(
            kb_o, ks_o[None],
            out=np.zeros_like(kb_o),
            where=ks_o[None] > 0,
        )

        for m in s._derivative_mappings.values():
            dk_f = m.d_extinction.copy()
            dw_f = m.d_ssa.copy()
            dks_f = w_f * dk_f + k_f * dw_f
            dk_o = red(dk_f)
            dks_o = red(dks_f)
            m.d_extinction = dk_o
            m.d_ssa = np.divide(
                dks_o - w_o * dk_o, k_o,
                out=np.zeros_like(dk_o), where=k_o > 0,
            )
            m.d_emission = red(m.d_emission)
            if m.d_leg_coeff is not None and np.any(m.d_leg_coeff):
                db_f = m.d_leg_coeff * m.scat_factor[None]
                if db_f.shape[0] < beta_f.shape[0]:
                    pad = np.zeros(
                        (beta_f.shape[0] - db_f.shape[0],) + db_f.shape[1:]
                    )
                    db_f = np.concatenate([db_f, pad], axis=0)
                dkb_o = red(dks_f[None] * beta_f + ks_f[None] * db_f)
                m.d_leg_coeff = np.divide(
                    dkb_o - beta_o * dks_o[None], ks_o[None],
                    out=np.zeros_like(dkb_o), where=ks_o[None] > 0,
                )
            elif m.d_leg_coeff is not None:
                m.d_leg_coeff = np.zeros(
                    m.d_leg_coeff.shape[:-1] + (self._nout,)
                )
            m.scat_factor = np.ones_like(k_o)

        s.total_extinction = k_o
        s.ssa = w_o
        s.leg_coeff = beta_o
        s.emission_source = red(s.emission_source)
        s.solar_irradiance = M @ s.solar_irradiance
        s.f = np.zeros_like(k_o)
        self._leg_view = LegendreStorageView(s.leg_coeff, self.nstokes)

        surf = self.surface
        surf.albedo = M @ surf.albedo
        surf.emission = M @ surf.emission
        if surf.brdf_args is not None:
            surf.brdf_args = M @ surf.brdf_args
        surf._nwavel = self._nout
        for sm in surf._derivative_mappings.values():
            sm.d_brdf = M @ sm.d_brdf

    def _apply_delta_m_scaling(self):
        """Delta-m scaling: f = beta_M / (2M+1); k* = (1 - w f) k;
        w* = (1-f) w / (1 - w f); beta*_l = (beta_l - f (2l+1)) / (1-f)
        (reference ``cpp/lib/atmosphere/atmosphere.cpp:69-160``)."""
        M = self.config.num_streams
        a1 = self.leg_coeff.a1
        if M >= a1.shape[0]:
            logging.info(
                "Delta-m scaling NOT applied: num_streams >= number of "
                "Legendre coefficients"
            )
            return
        f = a1[M] / (2 * M + 1)
        k = self.storage.total_extinction
        w = self.storage.ssa
        self.storage.f[:] = f
        self.storage.total_extinction = k * (1 - w * f)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.storage.ssa = (1 - f) * w / (1 - w * f)
            ls = np.arange(a1.shape[0])
            scaled = (a1 - f[None] * (2 * ls + 1)[:, None, None]) / (1 - f)[None]
        np.nan_to_num(self.storage.ssa, copy=False)
        np.nan_to_num(scaled, copy=False)
        if self.nstokes == 1:
            self.storage.leg_coeff = scaled
        else:
            self.storage.leg_coeff[0::4] = scaled
            # a2/a3 scale like a1 with their own (2l+1) f subtraction on the
            # diagonal elements; b1 has no delta-function part
            for view in (self.leg_coeff.a2, self.leg_coeff.a3):
                with np.errstate(invalid="ignore", divide="ignore"):
                    view[:] = (view - f[None] * 0.0) / (1 - f)[None]
            with np.errstate(invalid="ignore", divide="ignore"):
                self.leg_coeff.b1[:] = self.leg_coeff.b1 / (1 - f)[None]
            np.nan_to_num(self.storage.leg_coeff, copy=False)
        self._leg_view = LegendreStorageView(self.storage.leg_coeff, self.nstokes)
        self._applied_delta_m_order = M

    def _native_core(self) -> dict:
        """The engine's handoff: the storage's and the surface's arrays as
        they lie, no copy. extinction, ssa and emission [A, W]; leg_coeff
        the whole Legendre stack [L, A, W] (scalar) or [4L, A, W] (a1, a2,
        a3, b1 interleaved, ``split_greeks``); albedo, surface_emission and
        solar_irradiance [W]; brdf_args [W, nargs] under a BRDF."""
        s = self.storage
        core = {
            "extinction": s.total_extinction,
            "ssa": s.ssa,
            "leg_coeff": self._leg_view._leg,
            "albedo": self.surface.albedo,
            "emission": s.emission_source,
            "surface_emission": self.surface.emission,
            "solar_irradiance": s.solar_irradiance,
        }
        if self.surface.brdf is not None:
            core["brdf_args"] = self.surface.brdf_args
        return core


def split_greeks(stack, nstokes: int) -> dict:
    """The core's Legendre keys as views of the stack [L*, A, W] (numpy or
    torch), read through ``LegendreStorageView``: a1 (``leg_coeff``) alone
    for scalar, a1, a2, a3 and b1 polarized."""
    view = LegendreStorageView(stack, nstokes)
    greeks = ("a1",) if nstokes == 1 else ("a1", "a2", "a3", "b1")
    keys = ("leg_coeff", "leg_a2", "leg_a3", "leg_b1")
    return {k: getattr(view, g) for k, g in zip(keys, greeks)}


def wavelength_leading(native: dict, nstokes: int, transpose) -> dict:
    """The engine's core arrays from the native handoff
    (``Atmosphere._native_core``): extinction, ssa and emission [W, A],
    each greek [W, A, L], the 1-D arrays [W] and brdf_args [W, nargs].
    ``transpose(x, axes)`` returns a contiguous copy of ``x`` (numpy or
    torch) with its axes permuted."""
    greeks = {k: transpose(v, (2, 1, 0))
              for k, v in split_greeks(native["leg_coeff"], nstokes).items()}
    core = {
        "extinction": transpose(native["extinction"], (1, 0)),
        "ssa": transpose(native["ssa"], (1, 0)),
        "leg_coeff": greeks.pop("leg_coeff"),
        "albedo": transpose(native["albedo"], (0,)),
        "emission": transpose(native["emission"], (1, 0)),
        "surface_emission": transpose(native["surface_emission"], (0,)),
        "solar_irradiance": transpose(native["solar_irradiance"], (0,)),
        **greeks,
    }
    if "brdf_args" in native:
        core["brdf_args"] = transpose(native["brdf_args"], (0, 1))
    return core


def _host_transpose(x, axes):
    return np.array(np.transpose(x, axes), order="C")
