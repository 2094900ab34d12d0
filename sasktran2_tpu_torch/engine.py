"""The radiative transfer Engine of the PyTorch port (counterpart of
``sasktran2_tpu/engine.py``).

Same contract as the JAX engine: construct with (config, model geometry,
viewing geometry), then ``calculate_radiance(atmosphere)`` returns a
``Dataset`` with ``radiance`` and the ``wf_*`` weighting functions. The
host side (ray tracing, angular, chapman and ray-source tables, the
atmosphere's constituent pipeline, weighting-function assembly) is numpy,
in the port's own copies of the JAX package's host modules; the solve runs
in torch on the GPU (or on the CPU when the caller asks for it), with the
Thomas and Jacobi work in the CUDA kernels of ``ops/`` on the GPU.

Two routes, chosen at each call as the JAX engine chooses them
(``_twostream_fast_ok``, ``_polarized_fast_ok``): the wavelength-minor
fast paths (scalar: ``rt/disco_nstream.py``, ``rt/twostream.py``;
polarized: ``rt/disco_vec_minor.py``) and the generic per-wavelength route
(``rt/disco.solve_plane_parallel``, ``rt/disco_vec.
solve_plane_parallel_vector``, batched over the wavelengths in the leading
axis), which takes polarized radiance with flux observers, over a BRDF or
with DO / two-stream thermal emission, and scalar BRDF surfaces on limb
rays or with flux observers.

Covered: 1D geometry (plane-parallel, pseudo-spherical, spherical) with
ground-viewing (``GroundViewingSolar``, ``SolarAnglesObserverLocation``)
and limb (``TangentAltitudeSolar``) rays, and the 2D (altitude x
horizontal angle) geometry of ``Geometry2D`` with its single scatter,
Standard and VER emission, occultation and line-of-sight optical depth
(``rt/raytrace2d.py``, the ``*_2d`` functions of
``rt/singlescatter.py``); DO multiple scatter (and for
limb rays the DO source evaluated along the traced rays on a grid of
``num_do_sza`` solar zenith angles); DO, exact or table single scatter;
Standard and volume-emission-rate emission; occultation; the
line-of-sight optical depth; Lambertian and BRDF surfaces; DO and
two-stream thermal emission; upwelling, downwelling, actinic and
divergence fluxes at flux observers; scalar and polarized (I, Q, U)
radiance with the Stokes-basis rotations; successive orders of
scattering (``rt/successive.py``: scalar, DO-initialised, on a grid of
solar zenith angles, with refracted internal rays, and polarized), which
takes the generic route as in the JAX engine; every spectral grid mode,
EngineIntegratedLineShape (the outputs mapped onto the output basis)
included; viewing-geometry containers (``LimbVertical``), whose per-ray
metadata joins the output. ``calculate_radiance(atmosphere, mesh=)``
splits the wavelengths into one block per device of a
``parallel.make_mesh`` mesh, each block on its own host thread.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .atmosphere import Atmosphere, split_greeks
from .config import (
    Config,
    EmissionSource,
    FluxType,
    GeometryType,
    InterpolationMethod,
    MultipleScatterSource,
    OccultationSource,
    SingleScatterSource,
    StokesBasis,
)
from . import spans
from .dataset import DataArray, Dataset
from .device import resolve_device, resolve_dtype
from .geometry import Geometry1D, Geometry2D
from .memo import LazyTables
from .ops.wigner import legendre_p
from .params import upload_core
from .parallel import Mesh, sharded_radiance_fn
from .rt import disco, disco_vec, do_source, singlescatter, successive
from .rt.disco_nstream import solve_nstream, solve_nstream_m0_levels
from .rt.disco_vec import NS
from .rt.disco_vec_minor import build_vector_minor_tables, solve_nstream_vector
from .rt.raytrace import apply_solar_table, trace_spherical
from .rt.twostream import solve_twostream
from .util.interpolation import linear_interpolating_matrix
from .util.torchmath import safe_div
from .util.validation import validate_atmosphere_core
from .viewinggeo import (
    GroundViewingSolar,
    SolarAnglesObserverLocation,
    TangentAltitude,
    TangentAltitudeSolar,
    ViewingGeometry,
    ViewingGeometryContainer,
)


# a box AMF combines a level's extinction and single-scatter-albedo
# gradients, the latter scaled by 1 / extinction; in float32 the JAX
# package's own AMF on ``scenarios.amf16_case`` is 4.6 of the column's
# largest magnitude off its float64 one, 0.11 below 60 km
_F32_AMF_WARNING = (
    "box air-mass factors (constituent.AirMassFactor) are ill-conditioned "
    "in float32; use Config(dtype='float64') for them (ROADMAP Queue 3)"
)


class Engine:
    """``Engine(config, geometry, viewing_geometry, device=None)``.

    ``device`` is where the solve runs: ``None`` means ``"cuda"``, and
    raises ``RuntimeError`` where no GPU is available rather than running
    on the CPU; pass ``device="cpu"`` for the CPU. On the CPU the port
    computes in float64; on CUDA in ``config.dtype``. A float32 call that
    asks for box air-mass factors warns: in float32 they are
    ill-conditioned, in this port as in the JAX package (ROADMAP Queue 3).
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
        self._flux_observers = list(
            getattr(viewing_geometry, "flux_observers", [])
        )
        self._thermal_do = config.emission_source in (
            EmissionSource.DiscreteOrdinates, EmissionSource.TwoStream,
        )
        self._is_2d = isinstance(geometry, Geometry2D)
        self._check_slice()
        self._dtype = resolve_dtype(config.dtype, self._device)
        self._polarized = config.num_stokes == 3
        self._lazy = LazyTables()
        self._num_azi_eff = None
        self._brdf = None
        self._stokes_cs = None
        if self._is_2d:
            self._init_2d()
            return

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
            nleg = max(config.num_streams, config.num_singlescatter_moments)
            self._phase_tab = singlescatter.phase_tables(self._traced, nleg)
            if self._polarized:
                self._d02_tab = singlescatter.phase_tables_d02(
                    self._traced, nleg
                )
        self._needs_so = ms == MultipleScatterSource.SuccessiveOrders
        self._needs_do = ms in (
            MultipleScatterSource.DiscreteOrdinates,
            MultipleScatterSource.TwoStream,
        ) or (ss == SingleScatterSource.DiscreteOrdinates
              and not self._needs_so)
        self._do_nstr = (
            2 if ms == MultipleScatterSource.TwoStream else config.num_streams
        )
        self._do_include_ss = ss == SingleScatterSource.DiscreteOrdinates
        self._do_groups = []
        self._limb_groups = []
        self._flux_groups = []
        if self._needs_do:
            self._build_do_tables()
        if self._needs_so:
            self._build_so_tables()
        if self._polarized:
            self._stokes_cs = self._stokes_basis_rotations()

    @property
    def ray_tracer(self) -> str:
        """Which host ray tracer this engine used: the port's native C++
        tracer (built with g++ at first use), its numpy fallback, or on a
        ``Geometry2D`` the numpy 2D tracer."""
        if self._is_2d:
            return "numpy 2D"
        from .native import get_native_lib

        return "native C++" if get_native_lib() is not None else "numpy"

    def _init_2d(self):
        """The 2D route (``sasktran2_tpu/engine.py:70-160``, ``:227-232``),
        with the JAX engine's refusals in its order: multiple scatter, an
        emission source other than Standard or VER, non-linear
        interpolation, a ray type the 2D tracer does not take, solar
        refraction; and, in the port only, polarized radiance (the JAX
        package has no polarized 2D path: its engine fails there with an
        ``AttributeError``). ``TangentAltitudeSolar`` rays become
        ``TangentAltitude`` rays at the horizontal angle whose in-plane
        solar zenith angle is the ray's; ground-viewing and downward
        ``SolarAnglesObserverLocation`` rays are placed in the plane by
        the tracer. No DO, SO or exact-1D table is built."""
        config, geometry = self._config, self._geometry
        if config.multiple_scatter_source != MultipleScatterSource.NoSource:
            msg = (
                "Geometry2D supports single scatter, occultation and "
                "emission (standard + volume emission rate) only "
                "(reference restriction, src/sasktran2/engine.py:80-104)"
            )
            raise NotImplementedError(msg)
        if config.emission_source not in (
            EmissionSource.NoSource,
            EmissionSource.Standard,
            EmissionSource.VolumeEmissionRate,
        ):
            msg = (
                "Geometry2D emission supports Standard and "
                "VolumeEmissionRate modes only; got "
                f"{config.emission_source}"
            )
            raise NotImplementedError(msg)
        linear = InterpolationMethod.LinearInterpolation
        if geometry.interpolation_method != linear:
            msg = (
                "Geometry2D supports LinearInterpolation only; got "
                f"{geometry.interpolation_method}"
            )
            raise NotImplementedError(msg)
        rays_2d = []
        theta0_ref = float(np.arccos(np.clip(geometry.cos_sza, -1, 1)))
        for r in self._rays:
            if isinstance(r, GroundViewingSolar) or (
                isinstance(r, SolarAnglesObserverLocation)
                and r.cos_viewing_zenith < 0
            ):
                rays_2d.append(r)
            elif isinstance(r, TangentAltitudeSolar):
                # the tangent point at the horizontal angle where the
                # in-plane local SZA (theta0 - theta) matches the ray's
                th_t = theta0_ref - float(
                    np.arccos(np.clip(r.cos_sza, -1, 1)))
                rays_2d.append(TangentAltitude(
                    tangent_altitude_m=r.tangent_altitude_m,
                    observer_altitude_m=r.observer_altitude_m,
                    horizontal_angle_radians=th_t,
                    viewing_azimuth_radians=r.relative_azimuth,
                ))
            elif isinstance(r, TangentAltitude):
                rays_2d.append(r)
            else:
                msg = (
                    "Geometry2D requires TangentAltitude, "
                    "TangentAltitudeSolar or ground-viewing rays"
                )
                raise NotImplementedError(msg)
        if config.solar_refraction:
            msg = (
                "Geometry2D supports LOS refraction only; "
                "solar_refraction is a 1D-path feature"
            )
            raise NotImplementedError(msg)
        if self._polarized:
            msg = (
                "Geometry2D supports scalar radiance only: the JAX package "
                "has no polarized 2D path (num_stokes=3)"
            )
            raise NotImplementedError(msg)
        self._traced2d = singlescatter.traced_2d(
            geometry.altitudes(), geometry.horizontal_angles(),
            geometry.earth_radius_m, geometry.cos_sza, rays_2d,
            refractive_index=geometry.refractive_index,
            los_refraction=config.los_refraction,
        )
        self._rays2d = singlescatter.Rays2D(self._traced2d)
        nleg = max(config.num_streams, config.num_singlescatter_moments)
        self._phase_tab2d = np.moveaxis(
            legendre_p(self._traced2d.cos_scatter, nleg), 0, -1
        )
        self._traced = None
        self._needs_ss_exact = (
            config.single_scatter_source == SingleScatterSource.Exact
        )
        self._needs_do = False
        self._needs_so = False
        self._flux_groups = []

    def _check_slice(self):
        """Raise ``TypeError`` for a geometry or viewing geometry that is
        not the port's, and ``NotImplementedError`` for a ray that a 1D
        geometry cannot trace (the 2D rays are checked by ``_init_2d``)."""
        if not isinstance(self._geometry, Geometry1D):
            msg = (
                "geometry must be a sasktran2_tpu_torch.Geometry1D or "
                f"Geometry2D, got {type(self._geometry).__module__}."
                f"{type(self._geometry).__name__}"
            )
            raise TypeError(msg)
        if not isinstance(self._viewing, ViewingGeometry):
            msg = (
                "viewing geometry must be a sasktran2_tpu_torch."
                "ViewingGeometry (a container such as LimbVertical is one), "
                f"got {type(self._viewing).__module__}."
                f"{type(self._viewing).__name__}"
            )
            raise TypeError(msg)
        if self._is_2d:
            return
        for ray in self._rays:
            if not isinstance(ray, (
                GroundViewingSolar, SolarAnglesObserverLocation,
                TangentAltitudeSolar,
            )):
                msg = (
                    f"ray type {type(ray).__name__} is not traced on a "
                    "Geometry1D (TangentAltitude rays need a Geometry2D)"
                )
                raise NotImplementedError(msg)

    def _twostream_fast_ok(self):
        """Whether the scalar wavelength-minor fast path takes this call
        (``sasktran2_tpu/engine.py:1250-1269``): scalar radiance whose
        multiple scatter is all DO-group solves (ground-viewing or limb),
        with a BRDF only where there are no limb rays and no flux
        observers. Everything else takes the generic route."""
        brdf_ok = self._brdf is None or (
            not self._limb_groups and not self._flux_observers
        )
        return (
            not self._is_2d
            and self._config.num_stokes == 1
            and self._needs_do
            and bool(self._do_groups or self._limb_groups)
            and brdf_ok
        )

    def _polarized_fast_ok(self):
        """Whether the polarized wavelength-minor fast path takes this
        call (``sasktran2_tpu/engine.py:1271-1293``): DO-group solves,
        ground-viewing or limb, over a Lambertian surface, with no flux
        observers and no DO or two-stream thermal source."""
        return (
            not self._is_2d
            and self._config.num_stokes == 3
            and self._needs_do
            and bool(self._do_groups or self._limb_groups)
            and not self._flux_observers
            and self._brdf is None
            and not self._thermal_do
        )

    # ------------------------------------------------------------------
    def _stokes_basis_rotations(self):
        """Per-LOS (C, S) = (cos 2a, +-sin 2a) rotating output Stokes
        (Q, U) from the standard basis (the meridian plane through the
        propagation direction and local up, the solver's native frame) into
        ``config.stokes_basis`` (``sasktran2_tpu/engine.py:327-415``).

        solar: reference plane spanned by the look vector and the sun
        (S = -sin 2a); observer: plane spanned by the look vector and the
        observer position (S = +sin 2a). The angle is the dihedral angle
        between the perpendicular projections onto the look vector.
        """
        basis = self._config.stokes_basis
        nlos = len(self._rays)
        cs = np.ones((nlos, 2))
        cs[:, 1] = 0.0
        if basis == StokesBasis.Standard:
            return cs

        re = self._geometry.earth_radius_m
        for i, ray in enumerate(self._rays):
            z = np.array([0.0, 0.0, 1.0])
            if isinstance(ray, TangentAltitudeSolar):
                theta0 = np.arccos(np.clip(ray.cos_sza, -1, 1))
                phi = ray.relative_azimuth
                look = np.array([1.0, 0.0, 0.0])
                # sun azimuth measured from the look azimuth
                s = np.array([
                    np.sin(theta0) * np.cos(phi),
                    np.sin(theta0) * np.sin(phi),
                    np.cos(theta0),
                ])
                rt = re + ray.tangent_altitude_m
                d = np.sqrt(
                    max((re + ray.observer_altitude_m) ** 2 - rt**2, 0.0)
                )
                pos = np.array([d, 0.0, rt])
            elif isinstance(
                ray, (GroundViewingSolar, SolarAnglesObserverLocation)
            ):
                muv = ray.cos_viewing_zenith
                theta0 = np.arccos(np.clip(ray.cos_sza, -1, 1))
                phi = ray.relative_azimuth
                sv = np.sqrt(max(1.0 - muv * muv, 0.0))
                look = np.array([sv, 0.0, abs(muv)])
                s = np.array([
                    np.sin(theta0) * np.cos(phi),
                    np.sin(theta0) * np.sin(phi),
                    np.cos(theta0),
                ])
                ground = np.array([0.0, 0.0, re])
                # observer up the (propagation) look direction from the
                # ground point at the requested altitude
                b = 2.0 * ground @ look
                c = re**2 - (re + ray.observer_altitude_m) ** 2
                d = 0.5 * (-b + np.sqrt(max(b * b - 4 * c, 0.0)))
                pos = ground + d * look
            else:
                continue

            if basis == StokesBasis.Solar:
                target = s
                sign = -1.0
            else:  # Observer
                target = pos / np.linalg.norm(pos)
                sign = 1.0
            perp_z = z - (z @ look) * look
            perp_t = target - (target @ look) * look
            nz = np.linalg.norm(perp_z)
            nt = np.linalg.norm(perp_t)
            if nz < 1e-10 or nt < 1e-10:
                continue  # degenerate: identity
            cos_a = float(np.clip(perp_z @ perp_t / (nz * nt), -1.0, 1.0))
            sin_a = np.sqrt(max(1.0 - cos_a * cos_a, 0.0))
            cs[i, 0] = 2.0 * cos_a * cos_a - 1.0
            cs[i, 1] = sign * 2.0 * sin_a * cos_a
        return cs

    def _rotate_stokes(self, arr, stokes_axis):
        """Rotate (Q, U) of a numpy output array, whose LOS axis sits just
        before ``stokes_axis``, into the configured basis:
        Q' = C Q - S U, U' = S Q + C U (``engine.py:417-445``)."""
        cs = self._stokes_cs
        if cs is None or (not np.any(cs[:, 1]) and np.all(cs[:, 0] == 1.0)):
            return arr
        arr = np.array(arr, copy=True)
        slq = [slice(None)] * arr.ndim
        slu = list(slq)
        slq[stokes_axis] = 1
        slu[stokes_axis] = 2
        q = arr[tuple(slq)].copy()
        u = arr[tuple(slu)].copy()
        los_axis = (stokes_axis % arr.ndim) - 1
        bshape = [1] * q.ndim
        bshape[los_axis] = cs.shape[0]
        cvec = cs[:, 0].reshape(bshape)
        svec = cs[:, 1].reshape(bshape)
        arr[tuple(slq)] = cvec * q - svec * u
        arr[tuple(slu)] = svec * q + cvec * u
        return arr

    # ------------------------------------------------------------------
    def _build_do_tables(self):
        """Group the rays by cos_sza and build each group's DO angular
        tables (``sasktran2_tpu/engine.py:446-630``): ground-viewing groups
        are evaluated at the rays' zenith cosines; flux observers get one
        m = 0 solve per cos_sza and an interpolation onto their altitudes;
        limb groups get one solve per point of the SZA grid and the
        ray-source tables of ``rt.do_source``. Polarized engines take the
        vector tables of ``rt.disco_vec_minor``."""
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
        build_tables = (
            build_vector_minor_tables if self._polarized
            else disco.build_mode_tables
        )
        self._do_groups = []
        for mu0, entries in groups.items():
            idx = np.array([e[0] for e in entries])
            user_mu = np.array([e[1] for e in entries])
            user_up = np.array([e[2] for e in entries])
            user_azi = np.array([e[3] for e in entries])
            tables = build_tables(
                nstr, nstr, mu0, user_mu, num_azimuth=num_azi,
            )
            self._do_groups.append((idx, tables, user_up, user_azi))

        # flux observers: the m = 0 level fields of a solve per cos_sza,
        # interpolated from the TOA-first boundaries onto the observers.
        # Polarized fluxes come from the generic vector solve's I slices,
        # so their tables are the generic route's vector tables
        flux_tables = (
            disco_vec.build_vector_mode_tables if self._polarized
            else disco.build_mode_tables
        )
        alts = self._geometry.altitudes()
        self._flux_groups = []
        for mu0 in sorted({float(o.cos_sza) for o in self._flux_observers}):
            obs = [
                (i, o.observer_altitude_m)
                for i, o in enumerate(self._flux_observers)
                if float(o.cos_sza) == mu0
            ]
            interp = linear_interpolating_matrix(
                alts, np.array([e[1] for e in obs]), "extend",
            )[:, ::-1]  # [nobs, P+1] in TOA-first boundary order
            tables = flux_tables(
                nstr, nstr, mu0, np.array([0.5]), num_azimuth=1,
            )
            self._flux_groups.append(
                (np.array([e[0] for e in obs]), tables, interp)
            )

        # limb rays: the DO field of each SZA-grid point, evaluated along
        # the traced rays; with num_do_sza > 1 the grid spans the local
        # solar zenith range of the rays' boundaries and the source is
        # interpolated per boundary (engine.py:550-630)
        self._limb_groups = []
        self._limb_sza_weights = None
        if not limb_groups:
            return
        ray_tables = (
            do_source.build_ray_vector_tables if self._polarized
            else do_source.build_ray_angular_tables
        )
        self._limb_rows = do_source.build_layer_rows(
            self._traced, ray_tables(self._traced, nstr, num_azi),
        )

        def limb_tables(mu0):
            return build_tables(
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

    def _build_so_tables(self):
        """The successive-orders tables (``sasktran2_tpu/engine.py:236-316``):
        the SO geometry of each point of the solar zenith grid (one point,
        the geometry's, unless ``num_successive_orders_sza > 1`` on a
        scalar engine; then the grid spans the rays' local solar zenith
        range and the line-of-sight source is interpolated per boundary),
        the observer rays' direction-interpolation tables, the polarized
        kernel tables, and for a DO-initialised scalar single profile the
        DO solve's mode tables (one user direction, every azimuth mode)
        and its level-direction tables. The geometries come from the
        process's memo (``successive.so_geometry``); the engine builds its
        own ``TransportPlan`` of each, its sparse operators on the
        engine's device in its dtype."""
        cfg, geometry = self._config, self._geometry
        nleg = max(cfg.num_streams, cfg.num_singlescatter_moments)
        n_inc = max(4, int(round(cfg.num_successive_orders_incoming ** 0.5)))
        n_so_sza = 1 if self._polarized else max(
            1, cfg.num_successive_orders_sza)
        self._so_sza_weights = None
        self._so_ground_sza_weights = None
        if n_so_sza > 1:
            cs = self._traced.cos_sza
            seg_mask = self._traced.mask
            bmask = np.zeros(cs.shape)
            bmask[:, :-1] += seg_mask
            bmask[:, 1:] += seg_mask
            cs_valid = cs[bmask > 0]
            lo, hi = float(cs_valid.min()), float(cs_valid.max())
            if hi - lo < 1e-6:
                hi = lo + 1e-6
            so_sza_grid = np.linspace(lo, hi, n_so_sza)
            self._so_sza_weights = linear_interpolating_matrix(
                so_sza_grid, cs.ravel(), "extend"
            ).reshape(cs.shape + (n_so_sza,))
            self._so_ground_sza_weights = linear_interpolating_matrix(
                so_sza_grid, self._traced.ground_cos_sza, "extend"
            )
        else:
            so_sza_grid = np.array([geometry.cos_sza])
        geoms = [
            successive.so_geometry(
                geometry.altitudes(), geometry.earth_radius_m, float(m0),
                nleg, n_mu=n_inc, n_phi=n_inc,
                refractive_index=geometry.refractive_index,
                ms_refraction=cfg.multiple_scatter_refraction,
            )
            for m0 in so_sza_grid
        ]
        self._so_obs_tables = [
            successive.observer_source_tables(self._traced, g)
            for g in geoms
        ]
        pol_tabs = (
            successive.build_so_polarized_tables(geoms[0], nleg)
            if self._polarized else None
        )
        self._so_geoms, self._so_pol_tabs = geoms, pol_tabs
        self._so_plans = self._so_plans_on(self._device)
        self._so_do_init = (
            cfg.init_successive_orders_with_discrete_ordinates
            and not self._polarized
            and len(geoms) == 1
        )
        if self._so_do_init:
            nstr = cfg.num_streams
            num_azi = (
                cfg.num_forced_azimuth if cfg.num_forced_azimuth > 0 else nstr
            )
            self._so_do_tables = disco.build_mode_tables(
                nstr, nstr, geometry.cos_sza, np.array([0.5]),
                num_azimuth=num_azi,
            )
            self._so_dir_tables = do_source.build_level_direction_tables(
                geoms[0].mu_d, geoms[0].phi_d, nstr, num_azi,
            )

    def _so_plans_on(self, device):
        """The SO ``TransportPlan`` of each solar zenith grid point with its
        sparse operators on ``device``, built once per device (the
        ``mesh=`` blocks each run on their own)."""
        key = _device_key(device)
        return self._lazy.get(("so_plans", key), lambda: [
            successive.TransportPlan(g, key, self._dtype, self._so_pol_tabs)
            for g in self._so_geoms
        ])

    @property
    def _generic_tables(self):
        """The generic route's tables of each ground-viewing group and
        of each limb group's SZA-grid points: the scalar groups' own
        ``ModeTables``; for a polarized engine the ``VectorModeTables`` of
        the same geometry (``engine.py:487-543``), built at the first
        generic call."""
        return self._lazy.get("generic_tables", self._build_generic_tables)

    def _build_generic_tables(self):
        if not self._polarized:
            return ([t for _, t, _, _ in self._do_groups],
                    [tl for _, tl in self._limb_groups])

        def vector(t):
            return disco_vec.build_vector_mode_tables(
                self._do_nstr, self._do_nstr, t.mu0, t.user_mu,
                num_azimuth=t.kernel_a.shape[0],
            )

        return ([vector(t) for _, t, _, _ in self._do_groups],
                [[vector(t) for t in tl] for _, tl in self._limb_groups])

    @property
    def _chapman(self):
        """Chapman factors [P, P] per DO solar zenith (ground groups, flux
        groups and the limb SZA grid): None (the solver's 1/mu0) for
        plane-parallel geometry, else the spherical shell slant paths
        (``sasktran2_tpu/engine.py:1184-1249``), built at the first DO
        call."""
        return self._lazy.get("chapman", self._build_chapman)

    def _build_chapman(self):
        out = {}
        geom_type = self._geometry.geometry_type
        alts = self._geometry.altitudes()
        P = len(alts) - 1
        re = self._geometry.earth_radius_m
        all_tables = [tables for _, tables, _, _ in self._do_groups]
        all_tables += [t for _, tl in self._limb_groups for t in tl]
        all_tables += [tables for _, tables, _ in self._flux_groups]
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
        [W, P, L] by trapezoidal averaging (``engine.py:632``). A stack of
        greek coefficients [G, W, A, L] (the polarized engine's a1, a2, a3,
        b1) gives a beta of [G, W, P, L].

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

    def _effective_num_azimuth(self, greeks):
        """Azimuth modes past the phase expansion's support contribute
        exactly zero, so the mode loop stops there (``engine.py:1295``;
        a Rayleigh atmosphere at nstr=16 solves 3 modes). Polarized
        engines count the support of every greek (``greeks``: each
        [L, A, W], ``atmosphere.split_greeks``). None (every mode) under
        forced azimuth and under a BRDF, whose azimuth moments couple the
        direct beam into every mode whatever the phase expansion
        (``engine.py:1312``)."""
        if self._config.num_forced_azimuth > 0 or self._brdf is not None:
            return None
        lmax = 0
        for arr in greeks.values():
            arr = np.asarray(arr)
            nz = np.any(arr != 0.0, axis=tuple(range(1, arr.ndim)))
            if nz.any():
                lmax = max(lmax, int(np.max(np.nonzero(nz)[0])))
        return lmax + 1

    def _layers(self, core):
        """The solvers' wavelength-minor layer inputs: dtau/omega [P, W]
        and beta [L, P, W] (scalar) or the greeks [4, L, P, W]
        (polarized)."""
        dtau, omega, beta = self._layers_leading(core)
        beta_t = (beta.permute(0, 3, 2, 1) if self._polarized
                  else beta.permute(2, 1, 0))
        return dtau.movedim(0, -1), omega.movedim(0, -1), beta_t

    def _thermal_kw(self, core):
        """The solvers' thermal arguments under DO or two-stream emission
        (``engine.py:1440-1450``): the level emission at each TOA-first
        layer's top and bottom, [P, W], and the surface emission [W]."""
        kw = self._thermal_kw_leading(core)
        for k in ("thermal_b0", "thermal_b1_bottom"):
            if k in kw:
                kw[k] = kw[k].movedim(0, -1)
        return kw

    def _do_solve(self, layers, core, tables, user_up, user_azi, **kw):
        """One DO group's solve on the fast path: the vector solver for a
        polarized engine, the two-stream solver for a scalar ground-viewing
        group at nstr = 2 over a Lambertian ground, the N-stream solver
        otherwise (the limb groups' solves, ``return_internal=True``, need
        its level fields at every nstr, and a BRDF its azimuth moments;
        ``engine.py:1460-1466``). Radiance [U, W] (scalar) or [U, 3, W]
        (polarized)."""
        dtau_t, omega_t, beta_t = layers
        kw = dict(
            include_ss=self._do_include_ss,
            chapman=self._chapman.get(tables.mu0),
            f0=core["solar_irradiance"],
            num_azimuth=self._num_azi_eff,
            **kw,
        )
        if self._polarized:
            return solve_nstream_vector(
                dtau_t, omega_t, *beta_t, core["albedo"], tables, user_up,
                user_azi, **kw,
            )
        two_stream = (self._do_nstr == 2 and not kw.get("return_internal")
                      and kw.get("brdf") is None)
        solver = solve_twostream if two_stream else solve_nstream
        return solver(
            dtau_t, omega_t, beta_t, core["albedo"], tables, user_up,
            user_azi, **kw,
        )

    def _layers_leading(self, core):
        """The generic route's batch-leading layer inputs: dtau/omega
        [W, P] and beta [W, P, L] (scalar) or the greeks (a1, a2, a3, b1)
        stacked, [4, W, P, L] (polarized)."""
        legs = core["leg_coeff"]
        if self._polarized:
            legs = torch.stack([
                core[k] for k in ("leg_coeff", "leg_a2", "leg_a3", "leg_b1")
            ])
        return self._layer_optical(core["extinction"], core["ssa"], legs)

    def _thermal_kw_leading(self, core):
        """The generic route's thermal arguments under DO or two-stream
        emission (``engine.py:1440-1450``): the level emission at each
        TOA-first layer's top and bottom, [W, P], and the surface emission
        [W]."""
        if not self._thermal_do:
            return {}
        emis = core["emission"]                     # [W, A]
        return {
            "thermal_b0": torch.flip(emis[..., 1:], (-1,)),
            "thermal_b1_bottom": torch.flip(emis[..., :-1], (-1,)),
            "surface_emission": core["surface_emission"],
        }

    def _generic_solve(self, layers, core, tables, user_up, user_azi, **kw):
        """One solve of the generic route (``engine.py:822-895``,
        ``:975-1057``): ``disco.solve_plane_parallel`` or, polarized,
        ``disco_vec.solve_plane_parallel_vector``, batched over the
        wavelengths in the leading axis. Radiance [W, U] or [W, U, 3]."""
        dtau, omega, beta = layers
        kw = dict(
            include_ss=self._do_include_ss,
            chapman=self._chapman.get(tables.mu0),
            f0=core["solar_irradiance"],
            **{"num_azimuth": self._num_azi_eff, **kw},
        )
        if self._polarized:
            return disco_vec.solve_plane_parallel_vector(
                dtau, omega, *beta, core["albedo"], tables, user_up,
                user_azi, **kw,
            )
        return disco.solve_plane_parallel(
            dtau, omega, beta, core["albedo"], tables, user_up, user_azi,
            **kw,
        )

    def _do_groups_batched(self, core):
        """DO radiance [W, nlos] (scalar) or [W, nlos, 3] (polarized) of
        the whole wavelength batch: the ground-viewing groups
        (``engine.py:1325-1365``, ``:1416``) and the limb groups
        (``engine.py:1367-1413``, ``:1479-1524``), on the wavelength-minor
        fast path where ``_twostream_fast_ok`` or ``_polarized_fast_ok``
        holds, else on the generic route (``engine.py:822-895``,
        ``:975-1057``). As in the reference, the generic route gives a BRDF
        to the ground-viewing groups only: its limb solves see the core
        albedo (0 under a MODIS or Kokhanovsky surface)."""
        ext = core["extinction"]
        W = ext.shape[0]
        tail = (NS,) if self._polarized else ()
        rad = torch.zeros((W, len(self._rays)) + tail, dtype=ext.dtype,
                          device=ext.device)
        brdf_kw = {} if self._brdf is None else {
            "brdf": self._brdf, "brdf_args": core["brdf_args"],
        }
        if self._fast_route:
            layers = self._layers(core)
            thermal_kw = self._thermal_kw(core)

            def solve(tables, user_up, user_azi, **kw):
                return self._do_solve(layers, core, tables, user_up,
                                      user_azi, **kw).movedim(-1, 0)

            source = (
                do_source.ms_source_along_rays_vec_minor if self._polarized
                else do_source.ms_source_along_rays_minor
            )

            def limb_source(tables):
                _, internal = self._do_solve(
                    layers, core, tables, np.array([True]),
                    np.array([0.0]), return_internal=True, **thermal_kw,
                )
                ji, jo = source(internal, self._limb_rows,
                                self._do_include_ss)   # [R, S(, 3), W]
                return ji.movedim(-1, 0), jo.movedim(-1, 0)

            do_tables = [t for _, t, _, _ in self._do_groups]
            limb_tables = [tl for _, tl in self._limb_groups]
        else:
            layers = self._layers_leading(core)
            thermal_kw = self._thermal_kw_leading(core)

            def solve(tables, user_up, user_azi, **kw):
                return self._generic_solve(layers, core, tables, user_up,
                                           user_azi, **kw)

            source = (
                do_source.ms_source_along_rays_vec if self._polarized
                else do_source.ms_source_along_rays
            )

            def limb_source(tables):
                _, internal = self._generic_solve(
                    layers, core, tables, np.array([True]),
                    np.array([0.0]), return_internal=True, **thermal_kw,
                )
                return source(internal, self._limb_rows, self._do_include_ss)

            do_tables, limb_tables = self._generic_tables

        for (idx, _, user_up, user_azi), tables in zip(self._do_groups,
                                                       do_tables):
            r = solve(tables, user_up, user_azi, **thermal_kw, **brdf_kw)
            rad = rad.index_add(
                1, torch.as_tensor(idx, device=ext.device), r
            )
        for (idx, _), tables_list in zip(self._limb_groups, limb_tables):
            with spans.span("limb_source"):
                sources = [limb_source(tables) for tables in tables_list]
                ms_rad = self._limb_radiance(
                    ext, [s[0] for s in sources], [s[1] for s in sources]
                )
            idx_t = torch.as_tensor(idx, device=ext.device)
            rad = rad.index_add(1, idx_t, ms_rad.index_select(1, idx_t))
        return rad

    def _limb_radiance(self, ext, j_in, j_out):
        """Line-of-sight integral [W, nlos(, 3)] of the DO source at the
        segment ends, one [W, R, S(, 3)] pair per SZA-grid point,
        interpolated per boundary onto the rays' local solar zenith angles
        where the grid has more than one point."""
        if len(j_in) == 1:
            j_in, j_out = j_in[0], j_out[0]
        else:
            wts = torch.as_tensor(
                self._limb_sza_weights, dtype=ext.dtype, device=ext.device
            )                                   # [R, S+1, n_sza]
            S = j_in[0].shape[2]
            eq = "wrscn,rsn->wrsc" if self._polarized else "wrsn,rsn->wrs"
            j_in = torch.einsum(eq, torch.stack(j_in, -1), wts[:, :S])
            j_out = torch.einsum(eq, torch.stack(j_out, -1), wts[:, 1:S + 1])
        if self._polarized:
            # one line-of-sight integral per Stokes component
            return singlescatter.integrate_od_source(
                ext, j_in.permute(3, 0, 1, 2), j_out.permute(3, 0, 1, 2),
                self._traced,
            ).permute(1, 2, 0)                  # [W, nlos, 3]
        return singlescatter.integrate_od_source(
            ext, j_in, j_out, self._traced
        )                                       # [W, nlos]

    def _flux_groups_batched(self, core):
        """Fluxes [W, ntypes, nobs] of the whole wavelength batch from the
        m = 0 level fields (``engine.py:1527-1615``): upwelling and
        downwelling (2 pi sum w mu I, plus the direct beam mu0 F0 T down),
        actinic (2 pi sum w (I+ + I-) plus F0 T) and divergence (k_abs
        times actinic, less 4 pi k_abs B under thermal emission), each
        interpolated onto the observers.

        Under DO or two-stream thermal emission this solve runs in float64
        whatever the working dtype, and its fluxes come back in that
        dtype. Near the top of the atmosphere in a window channel the
        thermal downwelling field is about 1e-7 of the upwelling one at the
        same level, and the DO representation forms it as a difference of
        homogeneous parts of the upwelling field's size: in float32 (the
        port's and the JAX package's alike) the 80 km downwelling flux of
        ``scenarios.thermal16_case`` was 3e-3 to 6e-3 off per element and
        the fluxes' pressure weighting functions 0.12 to 0.63 of their
        largest magnitude; the float64 solve holds them to 1e-6."""
        out_dtype = core["extinction"].dtype
        if self._thermal_do:
            core = {k: v.double() for k, v in core.items()}
        cfg = self._config
        ext = core["extinction"]
        ssa = core["ssa"]
        f0 = core["solar_irradiance"]
        W = ext.shape[0]
        nobs = len(self._flux_observers)
        flux = torch.zeros((W, len(cfg.flux_types), nobs), dtype=ext.dtype,
                           device=ext.device)
        two_pi = 2.0 * math.pi
        if self._fast_route:
            dtau_t, omega_t, beta_t = self._layers(core)
            thermal_kw = self._thermal_kw(core)

            def m0_levels(tables):
                return solve_nstream_m0_levels(
                    dtau_t, omega_t, beta_t, core["albedo"], tables,
                    include_ss=self._do_include_ss,
                    chapman=self._chapman.get(tables.mu0),
                    f0=f0, **thermal_kw,
                )
        else:
            layers = self._layers_leading(core)
            thermal_kw = self._thermal_kw_leading(core)

            def m0_levels(tables):
                # the generic route's m = 0 solve (``engine.py:1105-1133``);
                # polarized fluxes are the scalar formulas on the I slices
                # of the vector solve's stream fields
                _, internal = self._generic_solve(
                    layers, core, tables, np.array([True]), np.array([0.0]),
                    return_internal=True, num_azimuth=1, **thermal_kw,
                )
                step = NS if self._polarized else 1
                lv = {k: v[0][..., ::step].permute(1, 2, 0)
                      for k, v in internal["levels"].items()}  # [P, N, W]
                return (lv, internal["t_top"].movedim(-1, 0),
                        internal["t_ground"])

        for idx, tables, interp in self._flux_groups:
            lv, t_top, t_ground = m0_levels(tables)
            wq = torch.as_tensor(tables.w, dtype=ext.dtype, device=ext.device)
            wmu = wq * torch.as_tensor(tables.mu, dtype=ext.dtype,
                                       device=ext.device)
            # boundary fields TOA-first: layer tops and the ground
            ip = torch.cat([lv["i_plus_top"], lv["i_plus_bot"][-1:]])
            im = torch.cat([lv["i_minus_top"], lv["i_minus_bot"][-1:]])
            t_b = torch.cat([t_top, t_ground[None]])        # [P+1, W]
            beam = f0[None] * t_b if self._do_include_ss else 0.0 * t_b
            f_up = two_pi * torch.einsum("bnw,n->bw", ip, wmu)
            f_dn = two_pi * torch.einsum("bnw,n->bw", im, wmu) + (
                tables.mu0 * beam
            )
            f_act = two_pi * torch.einsum("bnw,n->bw", ip + im, wq) + beam
            kabs_b = torch.flip(ext * (1.0 - ssa), (-1,)).movedim(0, -1)
            f_div = kabs_b * f_act
            if self._thermal_do:
                f_div = f_div - 4.0 * math.pi * kabs_b * torch.flip(
                    core["emission"], (-1,)).movedim(0, -1)
            per_type = {
                FluxType.Upwelling: f_up,
                FluxType.Downwelling: f_dn,
                FluxType.Actinic: f_act,
                FluxType.Divergence: f_div,
            }
            interp_t = torch.as_tensor(
                np.ascontiguousarray(interp), dtype=ext.dtype,
                device=ext.device,
            )
            vals = torch.stack([
                torch.einsum("ob,bw->wo", interp_t, per_type[ftype])
                for ftype in cfg.flux_types
            ], dim=1)                                       # [W, T, o]
            flux = flux.index_copy(
                2, torch.as_tensor(idx, device=ext.device), vals
            )
        return flux.to(out_dtype)

    def _radiance(self, core):
        """Radiance [W, nlos] (scalar) or [W, nlos, 3] (polarized) of the
        whole wavelength batch: the line-of-sight sources
        (``engine.py:721-745``, ``:898-940``) plus the DO part. Emission
        and occultation are unpolarized and add to I."""
        if self._is_2d:
            return self._radiance_2d(core)
        cfg = self._config
        ext = core["extinction"]
        W = ext.shape[0]
        rad = torch.zeros((W, len(self._rays)), dtype=ext.dtype,
                          device=ext.device)
        los = (self._needs_ss_exact
               or cfg.emission_source != EmissionSource.NoSource
               or cfg.occultation_source == OccultationSource.Standard)
        with spans.span("los_sources") if los else spans.NULL:
            rad = self._los_sources(core, rad)
        if self._needs_so:
            with spans.span("so"):
                rad = rad + self._so_radiance(core)
        if self._needs_do:
            rad = rad + self._do_groups_batched(core)
        return rad

    def _los_sources(self, core, rad):
        """``rad`` plus the line-of-sight sources: exact single scatter,
        emission and occultation; [W, nlos, 3] where polarized."""
        cfg = self._config
        ext = core["extinction"]
        if self._needs_ss_exact and not self._polarized:
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
        if self._polarized:
            zero = torch.zeros_like(rad)
            rad = torch.stack([rad, zero, zero], dim=-1)   # [W, nlos, 3]
            if self._needs_ss_exact:
                rad = rad + core["solar_irradiance"][:, None, None] * (
                    singlescatter.integrate_single_scatter_polarized(
                        ext, core["ssa"], core["leg_coeff"], core["leg_b1"],
                        core["albedo"], self._traced, self._phase_tab,
                        self._d02_tab,
                    )
                )
        return rad

    def _radiance_2d(self, core):
        """Radiance [W, nlos] of a 2D atmosphere (``engine.py:690-719``):
        single scatter times the solar irradiance; Standard emission plus
        the attenuated surface emission of ground-hitting rays; VER
        emission; occultation of the rays that do not hit the ground."""
        cfg = self._config
        ext = core["extinction"]
        rad = torch.zeros((ext.shape[0], len(self._rays)), dtype=ext.dtype,
                          device=ext.device)
        rays = self._rays2d
        if self._needs_ss_exact:
            rad = rad + core["solar_irradiance"][:, None] * (
                singlescatter.integrate_single_scatter_2d(
                    ext, core["ssa"], core["leg_coeff"], rays,
                    self._phase_tab2d,
                )
            )
        ground = rays.on(ext.device, ext.dtype)["ground_hit"]
        od = None
        if (cfg.emission_source == EmissionSource.Standard
                or cfg.occultation_source == OccultationSource.Standard):
            # the call's one line-of-sight optical depth, which ``_compute``
            # reuses as the los_optical_depth output
            od = core["los_optical_depth"] = singlescatter.optical_depth_2d(
                ext, rays)
        if cfg.emission_source == EmissionSource.Standard:
            rad = rad + singlescatter.emission_radiance_2d(
                ext, core["ssa"], core["emission"], rays)
            rad = rad + ground * (
                (1.0 - core["albedo"]) * core["surface_emission"]
            )[:, None] * torch.exp(-od)
        if cfg.emission_source == EmissionSource.VolumeEmissionRate:
            rad = rad + singlescatter.ver_emission_radiance_2d(
                ext, core["emission"], rays)
        if cfg.occultation_source == OccultationSource.Standard:
            rad = rad + torch.exp(-od) * (1.0 - ground)
        return rad

    def _so_radiance(self, core):
        """The successive-orders radiance [W, nlos] (scalar) or
        [W, nlos, 3] (polarized): the field's source integrated along the
        lines of sight, plus the diffuse ground-leaving radiance at the
        far end of ground-hitting rays (the direct beam's reflection is in
        the exact single scatter), both scaled by the solar irradiance
        (``engine.py:747-820``, ``:942-972``). A DO-initialised engine
        seeds the field with the DO source of a plane-parallel solve
        (``engine.py:752-766``); with an SZA grid the field is solved per
        grid point and the source interpolated at each boundary's local
        solar zenith angle."""
        ext, ssa, alb = core["extinction"], core["ssa"], core["albedo"]
        f0 = core["solar_irradiance"]
        iterations = self._config.num_successive_orders_iterations

        def const(x):
            return torch.as_tensor(np.asarray(x), dtype=ext.dtype,
                                   device=ext.device)

        ground_t = const(self._traced.ground_hit) * torch.exp(
            -singlescatter.optical_depth(ext, self._traced))  # [W, nlos]
        if self._polarized:
            legs = tuple(core[k] for k in (
                "leg_coeff", "leg_a2", "leg_a3", "leg_b1"))
            _, j_field, i_ground = (
                successive.successive_orders_field_polarized(
                    ext, ssa, legs, alb, self._so_plans_on(ext.device)[0],
                    iterations,
                )
            )
            j_in, j_out = successive.so_source_along_rays_polarized(
                j_field, self._traced, self._so_obs_tables[0]
            )
            ms = singlescatter.integrate_od_source(
                ext, j_in.permute(3, 0, 1, 2), j_out.permute(3, 0, 1, 2),
                self._traced,
            ).permute(1, 2, 0)                      # [W, nlos, 3]
            g = i_ground[:, None] * ground_t
            zero = torch.zeros_like(g)
            return f0[:, None, None] * (
                ms + torch.stack([g, zero, zero], dim=-1))

        j_init = None
        if self._so_do_init:
            dtau, omega, beta = self._layer_optical(
                ext, ssa, core["leg_coeff"])
            _, internal = disco.solve_plane_parallel(
                dtau, omega, beta, alb, self._so_do_tables,
                np.array([True]), np.array([0.0]), include_ss=False,
                return_internal=True,
            )
            j_init = do_source.ms_source_on_levels(
                internal, self._so_dir_tables
            )
        j_in, j_out, i_ground = [], [], []
        for plan, tables in zip(self._so_plans_on(ext.device),
                                self._so_obs_tables):
            _, j_field, ig = successive.successive_orders_field(
                ext, ssa, core["leg_coeff"], alb, plan, iterations,
                j_init=j_init,
            )
            ji, jo = successive.so_source_along_rays(
                j_field, self._traced, tables
            )
            j_in.append(ji)
            j_out.append(jo)
            i_ground.append(ig)
        if len(j_in) == 1:
            j_in, j_out = j_in[0], j_out[0]
            i_ground_ray = i_ground[0][:, None]
        else:
            wts = const(self._so_sza_weights)
            S = j_in[0].shape[-1]
            j_in = torch.einsum("wrsn,rsn->wrs", torch.stack(j_in, -1),
                                wts[:, :S])
            j_out = torch.einsum("wrsn,rsn->wrs", torch.stack(j_out, -1),
                                 wts[:, 1:S + 1])
            i_ground_ray = torch.einsum(
                "wn,rn->wr", torch.stack(i_ground, -1),
                const(self._so_ground_sza_weights),
            )
        ms = singlescatter.integrate_od_source(ext, j_in, j_out, self._traced)
        return f0[:, None] * (ms + i_ground_ray * ground_t)

    @spans.spanned("forward")
    def _outputs(self, core):
        """The outputs of one call as blocks of [W, n] columns: the
        radiance of each line of sight (and Stokes component, I, Q, U
        fastest), then the fluxes, type-major, as the JAX engine orders
        them. The blocks stay apart so that a flux output's Jacobian row
        does not run backward through the radiance's solves (the gradient
        of a concatenation sends zeros into every part)."""
        W = core["extinction"].shape[0]
        blocks = [self._radiance(core).reshape(W, -1)]
        if self._flux_groups:
            with spans.span("flux"):
                blocks.append(self._flux_groups_batched(core).reshape(W, -1))
        return blocks

    # ------------------------------------------------------------------
    @spans.root_call
    def calculate_radiance(self, atmosphere: Atmosphere, mesh=None) -> Dataset:
        """Run the forward model and, when the atmosphere asks for them,
        the weighting functions.

        The outputs are wavelength-diagonal in the inputs, so for each
        output (line of sight, Stokes component or flux) one backward pass
        of its sum over the wavelengths yields that output's Jacobian rows
        at every wavelength at once. Outputs and every gradient block come
        back to the host in one copy.

        ``mesh``: a ``parallel.Mesh`` (``parallel.make_mesh``). The
        wavelengths are cut into one block per entry of its wavelength
        axis, and each block runs the whole forward model and its
        Jacobian rows on its device, on a host thread of its own, with
        the engine's device-resident tables kept once per device
        (``sasktran2_tpu/engine.py:1772-1781``; the reference threads
        over wavelengths the same way, ``engine.cpp:560-572``). The
        results come back in wavelength order before the one host copy.
        The "los" axis is accepted and ignored."""
        if mesh is not None and not isinstance(mesh, Mesh):
            msg = (
                "mesh must be a sasktran2_tpu_torch.parallel.Mesh "
                f"(parallel.make_mesh), got {type(mesh).__name__}"
            )
            raise TypeError(msg)
        if not isinstance(atmosphere, Atmosphere):
            msg = (
                "atmosphere must be a sasktran2_tpu_torch.Atmosphere; "
                "params.atmosphere_from_reference carries one over"
            )
            raise TypeError(msg)
        # the storage's arrays as they lie: [A, W], the Legendre stack
        # [L or 4L, A, W]; the wavelength-leading core is made on the device
        native = atmosphere.internal_object(native=True)
        greeks = split_greeks(native["leg_coeff"], atmosphere.nstokes)
        nloc = self._geometry.num_altitudes * (
            self._geometry.num_horizontal if self._is_2d else 1)
        with spans.span("validate"):
            validate_atmosphere_core(
                {**native, "leg_coeff": greeks["leg_coeff"]}, nloc,
                self._config.input_validation_mode,
            )
        self._brdf = atmosphere.surface.brdf
        # the route, as the JAX engine chooses it at trace time
        self._fast_route = (
            self._twostream_fast_ok() or self._polarized_fast_ok()
        )
        self._num_azi_eff = self._effective_num_azimuth(greeks)
        mappings = atmosphere.storage.derivative_mappings
        needs_jac = atmosphere.calculate_derivatives and (
            len(mappings) > 0 or len(atmosphere.surface.derivative_mappings) > 0
        )
        wrt = []
        if needs_jac:
            # as in the JAX engine, only the a1 greek (leg_coeff) is mapped
            # to weighting functions; a2, a3 and b1 are inputs only
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
            if self._brdf is not None:
                wrt.append("brdf_args")

        if needs_jac and self._dtype == torch.float32 and any(
            m.log_radiance_space for m in mappings.values()
        ):
            warnings.warn(_F32_AMF_WARNING, stacklevel=2)
        with spans.span("upload") as span:
            core = upload_core(native, atmosphere.nstokes, self._device,
                               self._dtype)
            if span:
                span.count(bytes=spans.nbytes(core.values()))
        # with a mesh, each block builds what it lacks of the lazily built
        # tables (its device's SO plans and 2D operators, the Chapman
        # factors, the generic route's tables) through ``self._lazy``
        blocks = (self._compute(core, wrt) if mesh is None
                  else sharded_radiance_fn(
                      lambda block: self._compute(block, wrt), mesh)(core))
        with spans.span("copy") as span:
            flat = torch.cat([b.reshape(-1) for b in blocks]).cpu().numpy()
            if span:
                span.count(bytes=flat.nbytes)
        return self._dataset(atmosphere, blocks, flat, wrt, needs_jac)

    @spans.spanned("dataset")
    def _dataset(self, atmosphere, blocks, flat, wrt, needs_jac):
        """The output ``Dataset`` of one call from the host copy ``flat``
        of the device ``blocks``, with the weighting functions of ``wrt``
        where ``needs_jac``."""
        pieces = np.split(flat, np.cumsum([b.numel() for b in blocks])[:-1])
        host = [p.reshape(b.shape) for p, b in zip(pieces, blocks)]
        grads = dict(zip(wrt, host[1:]))

        nlos = len(self._rays)
        ns = self._config.num_stokes
        nrad = nlos * ns
        out = Dataset()
        rad = host[0][:, :nrad].reshape(-1, nlos, ns)
        out["radiance"] = DataArray(
            self._rotate_stokes(rad, 2), ("wavelength", "los", "stokes")
        )
        ftypes = self._flux_types_out()
        if ftypes:
            flux = host[0][:, nrad:].reshape(
                host[0].shape[0], len(ftypes), len(self._flux_observers)
            )
            for ti, ftype in enumerate(ftypes):
                out[f"{_FLUX_NAMES[ftype]}_flux"] = DataArray(
                    flux[:, ti], ("wavelength", "flux_location")
                )
        out_wavel = getattr(atmosphere, "_output_wavelengths_nm", None)
        if out_wavel is not None:
            out.coords["wavelength"] = out_wavel
        elif atmosphere.wavelengths_nm is not None:
            out.coords["wavelength"] = atmosphere.wavelengths_nm
        out.coords["stokes"] = ["I", "Q", "U"][:ns]
        if needs_jac:
            self._assemble_wfs(out, atmosphere, grads, nlos)
        if self._config.output_los_optical_depth:
            out["los_optical_depth"] = DataArray(
                host[-1], ("wavelength", "los")
            )
        if getattr(atmosphere, "_engine_lineshape", False):
            self._map_to_output_basis(out, atmosphere._spectral_reduce)
        if isinstance(self._viewing, ViewingGeometryContainer):
            # per-ray geometry metadata (sasktran2_tpu/engine.py:1861-1865)
            out = self._viewing.add_geometry_to_radiance(out)
        return out

    def _compute(self, core, wrt):
        """The device-side blocks of one call on ``core`` (one device's
        wavelengths): the outputs [W, nout], the Jacobian rows [W, nout,
        ...] of each input in ``wrt``, and the line-of-sight optical
        depth [W, nlos] where the configuration asks for it."""
        for k in wrt:
            core[k].requires_grad_(True)
        with torch.set_grad_enabled(bool(wrt)):
            outputs = self._outputs(core)           # [W, n] blocks
        columns = [o[:, i] for o in outputs for i in range(o.shape[1])]
        blocks = [torch.cat([o.detach() for o in outputs], dim=1)]
        if wrt:
            inputs = [core[k] for k in wrt]
            rows = []
            for i, col in enumerate(columns):
                with spans.span("rows", row=i):
                    rows.append(self._jacobian_row(col, inputs,
                                                   i < len(columns) - 1))
            # [W, nout, ...] per input, as the JAX engine lays them out
            blocks += [
                torch.stack([row[j] for row in rows], dim=1)
                for j in range(len(wrt))
            ]
        if self._config.output_los_optical_depth:
            ext = core["extinction"].detach()
            if "los_optical_depth" in core:     # the 2D radiance's own
                blocks.append(core["los_optical_depth"].detach())
            elif self._is_2d:
                blocks.append(singlescatter.optical_depth_2d(ext,
                                                             self._rays2d))
            else:
                blocks.append(singlescatter.optical_depth(ext, self._traced))
        return blocks

    @staticmethod
    def _map_to_output_basis(out: Dataset, M):
        """EngineIntegratedLineShape (``sasktran2_tpu/engine.py:1844-1858``):
        the engine ran on the fine grid; every wavelength-dimensioned
        output (radiance, ``wf_*``, fluxes, LOS optical depth) is mapped
        onto the output basis with the [Wo, Wf] matrix ``M``."""
        for vname in list(out.keys()):
            da = out[vname]
            if "wavelength" not in da.dims:
                continue
            ax = da.dims.index("wavelength")
            vals = np.moveaxis(
                np.tensordot(M, np.moveaxis(da.to_numpy(), ax, 0), axes=1),
                0, ax,
            )
            out[vname] = DataArray(vals, da.dims)

    def _flux_types_out(self):
        """The flux types in the outputs: the configured ones where the
        engine has flux groups (flux observers and a DO source), else
        none."""
        return self._config.flux_types if self._flux_groups else ()

    @staticmethod
    def _jacobian_row(out_i, inputs, retain_graph):
        """Gradients of one output, summed over the wavelengths, with
        respect to ``inputs``: each output depends only on its own
        wavelength's inputs, so this is that output's Jacobian row at every
        wavelength. An input the output does not depend on (the albedo of
        an occultation-only engine) gets zeros."""
        if not out_i.requires_grad:
            return [torch.zeros_like(t) for t in inputs]
        grads = torch.autograd.grad(
            out_i.sum(), inputs, retain_graph=retain_graph, allow_unused=True
        )
        return [torch.zeros_like(t) if g is None else g
                for g, t in zip(grads, inputs)]

    # ------------------------------------------------------------------
    @spans.spanned("assembly")
    def _assemble_wfs(self, out: Dataset, atmosphere: Atmosphere, grads, nlos):
        """Map core-space gradients [W, nout, A(, L)] through the
        atmosphere's derivative mappings (``engine.py:1869``): radiance
        rows become ``wf_*`` on (wavelength, los, stokes), rotated into the
        Stokes basis and, in log-radiance space, divided by I; flux rows
        become ``wf_*_<type>_flux`` on (wavelength, flux_location)."""
        ns = self._config.num_stokes
        nrad = nlos * ns
        ftypes = self._flux_types_out()
        nobs = len(self._flux_observers)

        def emit(name, wf, log_space=False):
            rad_part = wf[:, :nrad].reshape(
                (wf.shape[0], nlos, ns) + wf.shape[2:]
            )
            rad_part = self._rotate_stokes(rad_part, 2)
            if log_space:
                # log-radiance space: every Stokes component's WF is
                # divided by the I component of the radiance
                intensity = out["radiance"].to_numpy()[:, :, 0:1]
                intensity = intensity.reshape(
                    intensity.shape + (1,) * (rad_part.ndim - 3)
                )
                with np.errstate(invalid="ignore", divide="ignore"):
                    rad_part = np.where(
                        intensity != 0.0, rad_part / intensity, 0.0
                    )
            arrs = [(name, rad_part, ("wavelength", "los", "stokes"))]
            wf_flux = wf[:, nrad:].reshape(
                (wf.shape[0], len(ftypes), nobs) + wf.shape[2:]
            )
            for ti, ftype in enumerate(ftypes):
                fname = f"{_FLUX_NAMES[ftype]}_flux"
                fv = wf_flux[:, ti]
                if log_space:
                    fvals = out[fname].to_numpy()
                    fvals = fvals.reshape(fvals.shape + (1,) * (fv.ndim - 2))
                    with np.errstate(invalid="ignore", divide="ignore"):
                        fv = np.where(fvals != 0.0, fv / fvals, 0.0)
                arrs.append((
                    f"{name}_{fname}", fv, ("wavelength", "flux_location")
                ))
            return arrs

        jext = grads.get("extinction")
        jssa = grads.get("ssa")
        jleg = grads.get("leg_coeff")
        jem = grads.get("emission")
        jalb = grads.get("albedo")
        jbrdf = grads.get("brdf_args")
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
            for vname, arr, dims in emit(assign, wf, m.log_radiance_space):
                # the trailing axis is the mapping's altitude/output axis
                da = DataArray(np.moveaxis(arr, -1, 0), (m.interp_dim, *dims))
                out[vname] = out[vname] + da if vname in out else da

        for name, m in atmosphere.surface.derivative_mappings.items():
            # a BRDF's arguments map through their gradient rows
            # (``engine.py:1964-1972``), a Lambertian albedo through its own
            if jbrdf is not None and m.d_brdf.shape[1] == jbrdf.shape[-1]:
                wf = np.einsum("wuk,wk->wu", jbrdf, m.d_brdf)
            elif jalb is not None:
                wf = jalb * m.d_brdf[:, 0][:, None]
            else:
                continue
            for vname, arr, dims in emit(name, wf):
                out[vname] = DataArray(arr, dims)


def _device_key(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device (a
    block's tensors report "cuda:0")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


_FLUX_NAMES = {
    FluxType.Upwelling: "upwelling",
    FluxType.Downwelling: "downwelling",
    FluxType.Actinic: "actinic",
    FluxType.Divergence: "divergence",
}
