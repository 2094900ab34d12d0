"""The radiative transfer Engine of the PyTorch port (counterpart of
``sasktran2_tpu/engine.py``), for the scalar wavelength-minor fast path.

Same contract as the JAX engine: construct with (config, model geometry,
viewing geometry), then ``calculate_radiance(atmosphere)`` returns a
``Dataset`` with ``radiance`` and the ``wf_*`` weighting functions. The
host side (ray tracing, angular, chapman and ray-source tables, the
atmosphere's constituent pipeline, weighting-function assembly) is numpy,
in the port's own copies of the JAX package's host modules; the solve runs
in torch on the GPU (or on the CPU when the caller asks for it), with the
Thomas and Jacobi work in the CUDA kernels of ``ops/`` on the GPU.

Covered: 1D geometry (plane-parallel, pseudo-spherical, spherical) with
ground-viewing (``GroundViewingSolar``, ``SolarAnglesObserverLocation``)
and limb (``TangentAltitudeSolar``) rays; DO multiple scatter (the
two-stream solver at nstr = 2 for ground-viewing rays, the N-stream solver
otherwise, and for limb rays the DO source evaluated along the traced rays
on a grid of ``num_do_sza`` solar zenith angles); DO, exact or table single
scatter; Standard and volume-emission-rate emission; occultation; the
line-of-sight optical depth; a Lambertian surface; scalar radiance.
Everything else raises ``NotImplementedError`` naming the ROADMAP slice
that will bring it.
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
from .rt import disco, do_source, singlescatter
from .rt.disco_nstream import solve_nstream
from .rt.raytrace import apply_solar_table, trace_spherical
from .rt.twostream import solve_twostream
from .util.interpolation import linear_interpolating_matrix
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
        ss = config.single_scatter_source
        ms = config.multiple_scatter_source
        if (
            ss == SingleScatterSource.Table
            and geometry.geometry_type != GeometryType.PlaneParallel
        ):
            # the (altitude x SZA) solar-transmission table recomposes the
            # static sun weights; the compute is the exact mode's
            table_kw = {}
            if config.num_solar_zenith_angles > 0:
                table_kw["n_sza"] = config.num_solar_zenith_angles
            self._traced = apply_solar_table(
                self._traced, geometry.altitudes(), geometry.earth_radius_m,
                **table_kw,
            )
        self._needs_ss_exact = ss in (
            SingleScatterSource.Exact, SingleScatterSource.Table,
        )
        if self._needs_ss_exact:
            self._phase_tab = singlescatter.phase_tables(
                self._traced,
                max(config.num_streams, config.num_singlescatter_moments),
            )
        self._needs_do = ms in (
            MultipleScatterSource.DiscreteOrdinates,
            MultipleScatterSource.TwoStream,
        ) or ss == SingleScatterSource.DiscreteOrdinates
        self._do_nstr = (
            2 if ms == MultipleScatterSource.TwoStream else config.num_streams
        )
        self._do_include_ss = ss == SingleScatterSource.DiscreteOrdinates
        self._do_groups = []
        self._limb_groups = []
        if self._needs_do:
            self._build_do_tables()
        self._num_azi_eff = None

    @property
    def ray_tracer(self) -> str:
        """Which host ray tracer this engine used: the port's native C++
        tracer (built with g++ at first use) or its numpy fallback."""
        from .native import get_native_lib

        return "native C++" if get_native_lib() is not None else "numpy"

    def _check_slice(self, flux_observers):
        """Raise for every configuration outside the ported scalar slice;
        the message names the ROADMAP Queue 1 slice for it."""
        cfg = self._config
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
        if cfg.multiple_scatter_source == MultipleScatterSource.SuccessiveOrders:
            raise _not_ported(
                "successive orders", "ROADMAP Queue 1 slice 10, SO"
            )
        if cfg.emission_source in (
            EmissionSource.DiscreteOrdinates, EmissionSource.TwoStream,
        ):
            raise _not_ported(
                "DO and two-stream thermal emission",
                "ROADMAP Queue 1 slice 4, thermal DO sources",
            )
        if cfg.spectral_grid_mode == SpectralGridMode.EngineIntegratedLineShape:
            raise _not_ported(
                "EngineIntegratedLineShape output mapping",
                "ROADMAP Queue 1 slice 12, optical compute",
            )
        if flux_observers:
            raise _not_ported("flux observers", "ROADMAP Queue 1 slice 7, flux")
        for ray in self._rays:
            if not isinstance(ray, (
                GroundViewingSolar, SolarAnglesObserverLocation,
                TangentAltitudeSolar,
            )):
                raise _not_ported(
                    f"ray type {type(ray).__name__}",
                    "ROADMAP, Next: ViewingGeometryContainer",
                )

    # ------------------------------------------------------------------
    def _build_do_tables(self):
        """Group the rays by cos_sza and build each group's DO angular
        tables (``sasktran2_tpu/engine.py:446``): ground-viewing groups are
        evaluated at the rays' zenith cosines; limb groups get one solve per
        point of the SZA grid and the ray-source tables of
        ``rt.do_source``."""
        groups = {}
        limb_groups = {}
        for i, ray in enumerate(self._rays):
            if isinstance(ray, TangentAltitudeSolar):
                limb_groups.setdefault(float(ray.cos_sza), []).append(i)
                continue
            up = (
                True
                if isinstance(ray, GroundViewingSolar)
                else ray.cos_viewing_zenith < 0.0
            )
            groups.setdefault(float(ray.cos_sza), []).append((
                i, abs(float(ray.cos_viewing_zenith)), up,
                float(ray.relative_azimuth),
            ))
        nstr = self._do_nstr
        num_azi = (
            self._config.num_forced_azimuth
            if self._config.num_forced_azimuth > 0
            else nstr
        )
        self._do_groups = []
        for mu0, entries in groups.items():
            idx = np.array([e[0] for e in entries])
            user_mu = np.array([e[1] for e in entries])
            user_up = np.array([e[2] for e in entries])
            user_azi = np.array([e[3] for e in entries])
            tables = disco.build_mode_tables(
                nstr, nstr, mu0, user_mu, num_azimuth=num_azi,
            )
            self._do_groups.append((idx, tables, user_up, user_azi))

        # limb rays: the DO field of each SZA-grid point, evaluated along
        # the traced rays; with num_do_sza > 1 the grid spans the local
        # solar zenith range of the rays' boundaries and the source is
        # interpolated per boundary (engine.py:550-630)
        self._limb_groups = []
        self._limb_sza_weights = None
        if not limb_groups:
            return
        self._limb_rows = do_source.build_layer_rows(
            self._traced,
            do_source.build_ray_angular_tables(self._traced, nstr, num_azi),
        )

        def limb_tables(mu0):
            return disco.build_mode_tables(
                nstr, nstr, mu0, np.array([0.5]), num_azimuth=num_azi,
            )

        n_sza = max(1, self._config.num_do_sza)
        if n_sza == 1:
            for mu0, idx in limb_groups.items():
                self._limb_groups.append((np.array(idx), [limb_tables(mu0)]))
            return
        all_idx = np.concatenate([np.array(v) for v in limb_groups.values()])
        cs = self._traced.cos_sza[all_idx]
        seg_mask = self._traced.mask[all_idx]
        # boundary b is real when segment b or segment b - 1 exists
        bmask = np.zeros(cs.shape)
        bmask[:, :-1] += seg_mask
        bmask[:, 1:] += seg_mask
        cs_valid = cs[bmask > 0]
        lo, hi = float(cs_valid.min()), float(cs_valid.max())
        if hi - lo < 1e-6:
            hi = lo + 1e-6
        sza_grid = np.linspace(lo, hi, n_sza)
        self._limb_sza_weights = linear_interpolating_matrix(
            sza_grid, self._traced.cos_sza.ravel(), "extend"
        ).reshape(self._traced.cos_sza.shape + (n_sza,))
        self._limb_groups.append(
            (all_idx, [limb_tables(float(m0)) for m0 in sza_grid])
        )

    @functools.cached_property
    def _chapman(self):
        """Chapman factors [P, P] per DO solar zenith (ground groups and
        the limb SZA grid): None (the solver's 1/mu0) for plane-parallel
        geometry, else the spherical shell slant paths
        (``sasktran2_tpu/engine.py:1184-1249``)."""
        out = {}
        geom_type = self._geometry.geometry_type
        alts = self._geometry.altitudes()
        P = len(alts) - 1
        re = self._geometry.earth_radius_m
        all_tables = [tables for _, tables, _, _ in self._do_groups]
        all_tables += [t for _, tl in self._limb_groups for t in tl]
        for tables in all_tables:
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
        [W, P, L] by trapezoidal averaging (``engine.py:632``).

        omega and beta are the extinction- and scattering-weighted means of
        the two levels' values, written as the upper level's value plus the
        lower level's weight times the difference. The reference's
        quotient of weighted sums has the same value to rounding, but its
        gradient with respect to a level's extinction is a difference of
        two terms in 1/extinction, which float32 cannot resolve at the top
        of the atmosphere (~1e-11 /m): the f32 pressure weighting functions
        of a Rayleigh atmosphere lost their top levels to it.
        """
        alts = torch.as_tensor(
            self._geometry.altitudes(), dtype=extinction.dtype,
            device=extinction.device,
        )
        dz = alts[1:] - alts[:-1]
        k_lo = extinction[..., :-1]
        k_hi = extinction[..., 1:]
        ssa_lo = ssa[..., :-1]
        ssa_hi = ssa[..., 1:]
        ks_lo = k_lo * ssa_lo
        ks_hi = k_hi * ssa_hi
        k_sum = k_lo + k_hi
        ks_sum = ks_lo + ks_hi
        dtau = 0.5 * k_sum * dz
        omega = torch.where(
            k_sum != 0.0,
            ssa_hi + safe_div(k_lo, k_sum) * (ssa_lo - ssa_hi),
            torch.zeros_like(k_sum),
        )
        leg_lo = leg_coeff[..., :-1, :]
        leg_hi = leg_coeff[..., 1:, :]
        beta = torch.where(
            ks_sum[..., None] != 0.0,
            leg_hi + safe_div(ks_lo, ks_sum)[..., None] * (leg_lo - leg_hi),
            torch.zeros_like(leg_hi),
        )
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
        """DO radiance [W, nlos] of the whole wavelength batch: the
        ground-viewing groups (``engine.py:1416``) and the limb groups
        (``engine.py:1479-1524``)."""
        ext = core["extinction"]
        alb = core["albedo"]
        f0 = core["solar_irradiance"]
        dtau, omega, beta = self._layer_optical(
            ext, core["ssa"], core["leg_coeff"]
        )
        dtau_t = dtau.movedim(0, -1)                # [P, W]
        omega_t = omega.movedim(0, -1)
        beta_t = beta.permute(2, 1, 0)              # [L, P, W]
        W = ext.shape[0]
        rad = torch.zeros((W, len(self._rays)), dtype=ext.dtype,
                          device=ext.device)
        solver = solve_twostream if self._do_nstr == 2 else solve_nstream
        for idx, tables, user_up, user_azi in self._do_groups:
            r = solver(
                dtau_t, omega_t, beta_t, alb, tables, user_up, user_azi,
                include_ss=self._do_include_ss,
                chapman=self._chapman.get(tables.mu0),
                f0=f0,
                num_azimuth=self._num_azi_eff,
            )                                       # [U, W]
            rad = rad.index_add(
                1, torch.as_tensor(idx, device=ext.device), r.movedim(0, -1)
            )
        for idx, tables_list in self._limb_groups:
            j_in, j_out = [], []
            for tables in tables_list:
                _, internal = solve_nstream(
                    dtau_t, omega_t, beta_t, alb, tables,
                    np.array([True]), np.array([0.0]),
                    include_ss=self._do_include_ss,
                    chapman=self._chapman.get(tables.mu0),
                    f0=f0,
                    num_azimuth=self._num_azi_eff,
                    return_internal=True,
                )
                ji, jo = do_source.ms_source_along_rays_minor(
                    internal, self._limb_rows, self._do_include_ss
                )                                   # [R, S, W]
                j_in.append(ji.movedim(-1, 0))
                j_out.append(jo.movedim(-1, 0))
            if len(tables_list) == 1:
                j_in, j_out = j_in[0], j_out[0]
            else:
                wts = torch.as_tensor(
                    self._limb_sza_weights, dtype=ext.dtype, device=ext.device
                )                                   # [R, S+1, n_sza]
                S = j_in[0].shape[-1]
                j_in = torch.einsum(
                    "wrsn,rsn->wrs", torch.stack(j_in, -1), wts[:, :S]
                )
                j_out = torch.einsum(
                    "wrsn,rsn->wrs", torch.stack(j_out, -1), wts[:, 1:S + 1]
                )
            ms_rad = singlescatter.integrate_od_source(
                ext, j_in, j_out, self._traced
            )                                       # [W, nlos]
            idx_t = torch.as_tensor(idx, device=ext.device)
            rad = rad.index_add(1, idx_t, ms_rad.index_select(1, idx_t))
        return rad

    def _radiance(self, core):
        """Radiance [W, nlos] of the whole wavelength batch: the
        line-of-sight sources (``engine.py:721-745``) plus the DO part."""
        cfg = self._config
        ext = core["extinction"]
        rad = torch.zeros((ext.shape[0], len(self._rays)), dtype=ext.dtype,
                          device=ext.device)
        if self._needs_ss_exact:
            # exact single scatter is solar-driven: it scales with F0
            rad = rad + core["solar_irradiance"][:, None] * (
                singlescatter.integrate_single_scatter(
                    ext, core["ssa"], core["leg_coeff"], core["albedo"],
                    self._traced, self._phase_tab,
                )
            )
        if cfg.emission_source == EmissionSource.Standard:
            rad = rad + singlescatter.emission_radiance(
                ext, core["ssa"], core["emission"], core["albedo"],
                core["surface_emission"], self._traced,
            )
        if cfg.emission_source == EmissionSource.VolumeEmissionRate:
            rad = rad + singlescatter.ver_emission_radiance(
                ext, core["emission"], self._traced
            )
        if cfg.occultation_source == OccultationSource.Standard:
            rad = rad + singlescatter.occultation_radiance(ext, self._traced)
        if self._needs_do:
            rad = rad + self._do_groups_batched(core)
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
        wrt = []
        if needs_jac:
            wrt = ["extinction", "ssa", "albedo"]
            if any(
                m.d_leg_coeff is not None and np.any(m.d_leg_coeff)
                for m in mappings.values()
            ):
                wrt.append("leg_coeff")
            if self._config.emission_source != EmissionSource.NoSource and any(
                np.any(m.d_emission) for m in mappings.values()
            ):
                wrt.append("emission")

        core = core_from_reference(core_np, self._device, self._dtype)
        for k in wrt:
            core[k].requires_grad_(True)
        nlos = len(self._rays)
        with torch.set_grad_enabled(bool(wrt)):
            rad = self._radiance(core)              # [W, nlos]
        blocks = [rad.detach()]
        if wrt:
            inputs = [core[k] for k in wrt]
            rows = [self._jacobian_row(rad[:, i], inputs, i < nlos - 1)
                    for i in range(nlos)]
            # [W, nlos, ...] per input, as the JAX engine lays them out
            blocks += [
                torch.stack([row[j] for row in rows], dim=1)
                for j in range(len(wrt))
            ]
        if self._config.output_los_optical_depth:
            blocks.append(singlescatter.optical_depth(
                core["extinction"].detach(), self._traced
            ))
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
        if self._config.output_los_optical_depth:
            out["los_optical_depth"] = DataArray(
                host[-1], ("wavelength", "los")
            )
        return out

    @staticmethod
    def _jacobian_row(rad_i, inputs, retain_graph):
        """Gradients of one line of sight's radiance, summed over the
        wavelengths, with respect to ``inputs``: each output depends only
        on its own wavelength's inputs, so this is that output's Jacobian
        row at every wavelength. An input the radiance does not depend on
        (the albedo of an occultation-only engine) gets zeros."""
        if not rad_i.requires_grad:
            return [torch.zeros_like(t) for t in inputs]
        grads = torch.autograd.grad(
            rad_i.sum(), inputs, retain_graph=retain_graph, allow_unused=True
        )
        return [torch.zeros_like(t) if g is None else g
                for g, t in zip(grads, inputs)]

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
        jem = grads.get("emission")
        jalb = grads.get("albedo")
        for name, m in atmosphere.storage.derivative_mappings.items():
            wf = 0.0
            if jext is not None:
                wf = wf + jext * m.d_extinction.T[:, None, :]
            if jssa is not None:
                wf = wf + jssa * m.d_ssa.T[:, None, :]
            if jem is not None and np.any(m.d_emission):
                wf = wf + jem * m.d_emission.T[:, None, :]
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
