"""The radiative transfer Engine of the PyTorch port (counterpart of
``sasktran2_tpu/engine.py``), for the scalar wavelength-minor fast path.

Same contract as the JAX engine: construct with (config, model geometry,
viewing geometry), then ``calculate_radiance(atmosphere)`` returns a
``Dataset`` with ``radiance`` and the ``wf_*`` weighting functions. The
host side (ray tracing, angular and chapman tables, the atmosphere's
constituent pipeline, weighting-function assembly) is numpy, in the port's
own copies of the JAX package's host modules; the solve runs in torch on
the GPU (or on the CPU when the caller asks for it), with the Thomas and
Jacobi work in the CUDA kernels of ``ops/`` on the GPU.

Covered: 1D geometry (plane-parallel, pseudo-spherical, spherical) with
ground-viewing rays (``GroundViewingSolar``, ``SolarAnglesObserverLocation``),
DO multiple scatter at ``num_streams >= 4``, DO or no single scatter,
a Lambertian surface, scalar radiance. Everything else raises
``NotImplementedError`` naming the ROADMAP slice that will bring it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .atmosphere import Atmosphere
from .config import (
    Config,
    EmissionSource,
    GeometryType,
    MultipleScatterSource,
    OccultationSource,
    SingleScatterSource,
    SpectralGridMode,
)
from .dataset import DataArray, Dataset
from .device import resolve_device, resolve_dtype
from .geometry import Geometry1D
from .params import core_from_reference
from .rt import disco
from .rt.disco_nstream import solve_nstream
from .rt.raytrace import trace_spherical
from .util.torchmath import safe_div
from .util.validation import validate_atmosphere_core
from .viewinggeo import (
    GroundViewingSolar,
    SolarAnglesObserverLocation,
    TangentAltitudeSolar,
    ViewingGeometry,
)


def _not_ported(what: str, slice_: str):
    msg = f"{what} is not ported to the PyTorch engine yet ({slice_})"
    return NotImplementedError(msg)


class Engine:
    """``Engine(config, geometry, viewing_geometry, device=None)``.

    ``device`` is where the solve runs: ``None`` means ``"cuda"``, and
    raises ``RuntimeError`` where no GPU is available rather than running
    on the CPU; pass ``device="cpu"`` for the CPU. On the CPU the port
    computes in float64; on CUDA in ``config.dtype``.
    """

    def __init__(
        self, config: Config, geometry: Geometry1D, viewing_geometry,
        device=None,
    ):
        self._device = resolve_device(device)
        config.validate()
        self._config = config
        self._geometry = geometry
        self._viewing = viewing_geometry
        self._rays = list(viewing_geometry.observer_rays)
        if len(self._rays) == 0:
            msg = "viewing_geometry contains no rays"
            raise ValueError(msg)
        self._check_slice(
            list(getattr(viewing_geometry, "flux_observers", []))
        )
        self._dtype = resolve_dtype(config.dtype, self._device)

        self._traced = trace_spherical(
            geometry.altitudes(),
            geometry.earth_radius_m,
            geometry.cos_sza,
            self._rays,
            refractive_index=geometry.refractive_index,
            los_refraction=config.los_refraction,
            solar_refraction=config.solar_refraction,
            interp_method=geometry.interpolation_method.value,
        )
        self._do_nstr = config.num_streams
        self._do_include_ss = (
            config.single_scatter_source == SingleScatterSource.DiscreteOrdinates
        )
        self._build_do_tables()
        self._num_azi_eff = None

    @property
    def ray_tracer(self) -> str:
        """Which host ray tracer this engine used: the port's native C++
        tracer (built with g++ at first use) or its numpy fallback."""
        from .native import get_native_lib

        return "native C++" if get_native_lib() is not None else "numpy"

    def _check_slice(self, flux_observers):
        """Raise for every configuration outside the scalar ground-viewing
        DO slice; the message names the ROADMAP Queue 1 slice for it."""
        cfg = self._config
        ms = cfg.multiple_scatter_source
        ss = cfg.single_scatter_source
        if not isinstance(self._geometry, Geometry1D):
            msg = (
                "geometry must be a sasktran2_tpu_torch.Geometry1D, got "
                f"{type(self._geometry).__module__}."
                f"{type(self._geometry).__name__} (Geometry2D is ROADMAP "
                "Queue 1 slice 11, 2D)"
            )
            raise TypeError(msg)
        if not isinstance(self._viewing, ViewingGeometry):
            raise _not_ported(
                f"viewing geometry {type(self._viewing).__name__} (the port "
                "takes sasktran2_tpu_torch.ViewingGeometry)",
                "ROADMAP, Next: ViewingGeometryContainer",
            )
        if cfg.num_stokes != 1:
            raise _not_ported(
                "polarized radiance", "ROADMAP Queue 1 slice 8, polarized"
            )
        if ms == MultipleScatterSource.SuccessiveOrders:
            raise _not_ported(
                "successive orders", "ROADMAP Queue 1 slice 10, SO"
            )
        if ms == MultipleScatterSource.TwoStream or cfg.num_streams == 2:
            raise _not_ported(
                "the two-stream solver (nstr = 2)",
                "ROADMAP Queue 1 slice 3, two-stream",
            )
        if ss in (SingleScatterSource.Exact, SingleScatterSource.Table):
            raise _not_ported(
                "exact single scatter",
                "ROADMAP Queue 1 slice 5, non-DO sources",
            )
        if ms == MultipleScatterSource.NoSource and (
            ss != SingleScatterSource.DiscreteOrdinates
        ):
            raise _not_ported(
                "an engine with no DO source",
                "ROADMAP Queue 1 slice 5, non-DO sources",
            )
        if cfg.emission_source != EmissionSource.NoSource:
            raise _not_ported(
                "emission sources", "ROADMAP Queue 1 slice 5, non-DO sources"
            )
        if cfg.occultation_source != OccultationSource.NoSource:
            raise _not_ported(
                "occultation", "ROADMAP Queue 1 slice 5, non-DO sources"
            )
        if cfg.output_los_optical_depth:
            raise _not_ported(
                "output_los_optical_depth",
                "ROADMAP Queue 1 slice 5, non-DO sources",
            )
        if cfg.spectral_grid_mode == SpectralGridMode.EngineIntegratedLineShape:
            raise _not_ported(
                "EngineIntegratedLineShape output mapping",
                "ROADMAP Queue 1 slice 12, optical compute",
            )
        if flux_observers:
            raise _not_ported("flux observers", "ROADMAP Queue 1 slice 7, flux")
        for ray in self._rays:
            if isinstance(ray, TangentAltitudeSolar):
                raise _not_ported(
                    "limb rays (TangentAltitudeSolar)",
                    "ROADMAP Queue 1 slice 6, limb",
                )
            if not isinstance(
                ray, (GroundViewingSolar, SolarAnglesObserverLocation)
            ):
                raise _not_ported(
                    f"ray type {type(ray).__name__}",
                    "ROADMAP Queue 1 slice 6, limb",
                )

    # ------------------------------------------------------------------
    def _build_do_tables(self):
        """Group rays by cos_sza and build the DO angular tables of each
        group (``sasktran2_tpu/engine.py:446``, scalar ground groups)."""
        groups = {}
        for i, ray in enumerate(self._rays):
            up = (
                True
                if isinstance(ray, GroundViewingSolar)
                else ray.cos_viewing_zenith < 0.0
            )
            groups.setdefault(float(ray.cos_sza), []).append((
                i, abs(float(ray.cos_viewing_zenith)), up,
                float(ray.relative_azimuth),
            ))
        num_azi = (
            self._config.num_forced_azimuth
            if self._config.num_forced_azimuth > 0
            else self._do_nstr
        )
        self._do_groups = []
        for mu0, entries in groups.items():
            idx = np.array([e[0] for e in entries])
            user_mu = np.array([e[1] for e in entries])
            user_up = np.array([e[2] for e in entries])
            user_azi = np.array([e[3] for e in entries])
            tables = disco.build_mode_tables(
                self._do_nstr, self._do_nstr, mu0, user_mu,
                num_azimuth=num_azi,
            )
            self._do_groups.append((idx, tables, user_up, user_azi))

    @functools.cached_property
    def _chapman(self):
        """Chapman factors [P, P] per DO solar-zenith group: None (the
        solver's 1/mu0) for plane-parallel geometry, else the spherical
        shell slant paths (``sasktran2_tpu/engine.py:1184-1249``)."""
        out = {}
        geom_type = self._geometry.geometry_type
        alts = self._geometry.altitudes()
        P = len(alts) - 1
        re = self._geometry.earth_radius_m
        for _, tables, _, _ in self._do_groups:
            mu0 = tables.mu0
            if mu0 in out:
                continue
            if geom_type == GeometryType.PlaneParallel:
                out[mu0] = None
                continue
            radii = re + alts  # bottom-up levels
            c = np.zeros((P, P))
            if self._config.solar_refraction:
                from .rt.refraction import RefractiveShellIntegrator

                integ = RefractiveShellIntegrator(
                    radii, self._geometry.refractive_index
                )
                for p in range(P):
                    row = integ.chapman_row(radii[P - 1 - p], mu0)
                    c[p, : p + 1] = row[::-1][: p + 1]
                out[mu0] = c
                continue
            for p in range(P):
                r_b = radii[P - 1 - p]  # bottom of layer p (TOA-first)
                rt = r_b * np.sqrt(max(1.0 - mu0 * mu0, 0.0))
                for q in range(p + 1):
                    r_hi = radii[P - q]
                    r_lo = radii[P - 1 - q]
                    l_hi = np.sqrt(max(r_hi**2 - rt**2, 0.0))
                    l_lo = np.sqrt(max(r_lo**2 - rt**2, 0.0))
                    c[p, q] = (l_hi - l_lo) / (r_hi - r_lo)
            out[mu0] = c
        return out

    # ------------------------------------------------------------------
    def _layer_optical(self, extinction, ssa, leg_coeff):
        """Level quantities -> TOA-first layer dtau/omega [W, P] and beta
        [W, P, L] by trapezoidal averaging (``engine.py:632``)."""
        alts = torch.as_tensor(
            self._geometry.altitudes(), dtype=extinction.dtype,
            device=extinction.device,
        )
        dz = alts[1:] - alts[:-1]
        k_lo = extinction[..., :-1]
        k_hi = extinction[..., 1:]
        ks_lo = k_lo * ssa[..., :-1]
        ks_hi = k_hi * ssa[..., 1:]
        k_avg = 0.5 * (k_lo + k_hi)
        ks_avg = 0.5 * (ks_lo + ks_hi)
        dtau = k_avg * dz
        omega = safe_div(ks_avg, k_avg)
        bl = leg_coeff[..., :-1, :] * ks_lo[..., None]
        bh = leg_coeff[..., 1:, :] * ks_hi[..., None]
        beta = safe_div(0.5 * (bl + bh), ks_avg[..., None])
        return (
            torch.flip(dtau, (-1,)),
            torch.flip(omega, (-1,)),
            torch.flip(beta, (-2,)),
        )

    def _effective_num_azimuth(self, core_np):
        """Azimuth modes past the phase expansion's support contribute
        exactly zero, so the mode loop stops there (``engine.py:1295``;
        a Rayleigh atmosphere at nstr=16 solves 3 modes)."""
        if self._config.num_forced_azimuth > 0:
            return None
        arr = np.asarray(core_np["leg_coeff"])
        nz = np.any(arr != 0.0, axis=tuple(range(arr.ndim - 1)))
        return (int(np.max(np.nonzero(nz)[0])) if nz.any() else 0) + 1

    def _do_groups_batched(self, core):
        """DO-group radiance [W, nlos] of the whole wavelength batch
        (``engine.py:1416``)."""
        ext = core["extinction"]
        dtau, omega, beta = self._layer_optical(
            ext, core["ssa"], core["leg_coeff"]
        )
        dtau_t = dtau.movedim(0, -1)                # [P, W]
        omega_t = omega.movedim(0, -1)
        beta_t = beta.permute(2, 1, 0)              # [L, P, W]
        W = ext.shape[0]
        rad = torch.zeros((W, len(self._rays)), dtype=ext.dtype,
                          device=ext.device)
        for idx, tables, user_up, user_azi in self._do_groups:
            r = solve_nstream(
                dtau_t, omega_t, beta_t, core["albedo"], tables,
                user_up, user_azi,
                include_ss=self._do_include_ss,
                chapman=self._chapman.get(tables.mu0),
                f0=core["solar_irradiance"],
                num_azimuth=self._num_azi_eff,
            )                                       # [U, W]
            rad = rad.index_add(
                1, torch.as_tensor(idx, device=ext.device), r.movedim(0, -1)
            )
        return rad

    # ------------------------------------------------------------------
    def calculate_radiance(self, atmosphere: Atmosphere, mesh=None) -> Dataset:
        """Run the forward model and, when the atmosphere asks for them,
        the weighting functions.

        The outputs are wavelength-diagonal in the inputs, so for each
        line of sight one backward pass of the summed radiance yields that
        output's Jacobian rows at every wavelength at once. Radiance and
        every gradient block come back to the host in one copy."""
        if mesh is not None:
            raise _not_ported("mesh=", "ROADMAP Queue 1 slice 13, multi-GPU")
        if not isinstance(atmosphere, Atmosphere):
            msg = (
                "atmosphere must be a sasktran2_tpu_torch.Atmosphere; "
                "params.atmosphere_from_reference carries one over"
            )
            raise TypeError(msg)
        core_np = atmosphere.internal_object()
        validate_atmosphere_core(
            core_np, self._geometry.num_altitudes,
            self._config.input_validation_mode,
        )
        if atmosphere.surface.brdf is not None:
            raise _not_ported(
                "BRDF surfaces", "ROADMAP Queue 1 slice 4, BRDF surface_ops"
            )
        self._num_azi_eff = self._effective_num_azimuth(core_np)
        mappings = atmosphere.storage.derivative_mappings
        needs_jac = atmosphere.calculate_derivatives and (
            len(mappings) > 0 or len(atmosphere.surface.derivative_mappings) > 0
        )
        needs_leg_jac = any(
            m.d_leg_coeff is not None and np.any(m.d_leg_coeff)
            for m in mappings.values()
        )
        wrt = []
        if needs_jac:
            wrt = ["extinction", "ssa", "albedo"]
            if needs_leg_jac:
                wrt.append("leg_coeff")

        core = core_from_reference(core_np, self._device, self._dtype)
        for k in wrt:
            core[k].requires_grad_(True)
        nlos = len(self._rays)
        with torch.set_grad_enabled(bool(wrt)):
            rad = self._do_groups_batched(core)     # [W, nlos]
        blocks = [rad.detach()]
        if wrt:
            inputs = [core[k] for k in wrt]
            rows = [
                torch.autograd.grad(
                    rad[:, i].sum(), inputs, retain_graph=i < nlos - 1
                )
                for i in range(nlos)
            ]
            # [W, nlos, ...] per input, as the JAX engine lays them out
            blocks += [
                torch.stack([row[j] for row in rows], dim=1)
                for j in range(len(wrt))
            ]
        flat = torch.cat([b.reshape(-1) for b in blocks]).cpu().numpy()
        pieces = np.split(flat, np.cumsum([b.numel() for b in blocks])[:-1])
        host = [p.reshape(b.shape) for p, b in zip(pieces, blocks)]
        grads = dict(zip(wrt, host[1:]))

        out = Dataset()
        out["radiance"] = DataArray(
            host[0].reshape(-1, nlos, 1), ("wavelength", "los", "stokes")
        )
        if atmosphere.wavelengths_nm is not None:
            out.coords["wavelength"] = atmosphere.wavelengths_nm
        out.coords["stokes"] = ["I"]
        if needs_jac:
            self._assemble_wfs(out, atmosphere, grads, nlos)
        return out

    # ------------------------------------------------------------------
    def _assemble_wfs(self, out: Dataset, atmosphere: Atmosphere, grads, nlos):
        """Map core-space gradients [W, nlos, A(, L)] through the
        atmosphere's derivative mappings (``engine.py:1869``, scalar
        radiance, no flux outputs)."""

        def emit(wf, log_space=False):
            rad_part = wf.reshape((wf.shape[0], nlos, 1) + wf.shape[2:])
            if log_space:
                # log-radiance space: divide by the radiance
                intensity = out["radiance"].to_numpy()
                intensity = intensity.reshape(
                    intensity.shape + (1,) * (rad_part.ndim - 3)
                )
                with np.errstate(invalid="ignore", divide="ignore"):
                    rad_part = np.where(
                        intensity != 0.0, rad_part / intensity, 0.0
                    )
            return rad_part

        dims = ("wavelength", "los", "stokes")
        jext = grads.get("extinction")
        jssa = grads.get("ssa")
        jleg = grads.get("leg_coeff")
        jalb = grads.get("albedo")
        for name, m in atmosphere.storage.derivative_mappings.items():
            wf = 0.0
            if jext is not None:
                wf = wf + jext * m.d_extinction.T[:, None, :]
            if jssa is not None:
                wf = wf + jssa * m.d_ssa.T[:, None, :]
            if (
                jleg is not None
                and m.d_leg_coeff is not None
                and np.any(m.d_leg_coeff)
            ):
                dl = np.transpose(m.d_leg_coeff, (2, 1, 0))  # [W, A, L]
                wf = wf + np.einsum(
                    "wuag,wag->wua",
                    jleg[..., : dl.shape[-1]],
                    dl * m.scat_factor.T[..., None],
                )
            if m.interpolator is not None:
                wf = np.einsum("oa,wua->wuo", m.interpolator, wf)
            assign = m.assign_name if m.assign_name else name
            arr = emit(wf, m.log_radiance_space)
            da = DataArray(np.moveaxis(arr, -1, 0), (m.interp_dim, *dims))
            out[assign] = out[assign] + da if assign in out else da

        for name, m in atmosphere.surface.derivative_mappings.items():
            if jalb is None:
                continue
            out[name] = DataArray(emit(jalb * m.d_brdf[:, 0][:, None]), dims)
