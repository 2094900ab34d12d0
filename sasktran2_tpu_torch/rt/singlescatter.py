"""Exact single scatter and the other line-of-sight sources (counterpart of
``sasktran2_tpu/rt/singlescatter.py``: the 1D functions, scalar and
polarized, and the 2D ones of the altitude x horizontal-angle geometry).

Every input is wavelength-leading ([W, A] level profiles, [W] surface
values), so each function is one batched torch computation over the whole
wavelength batch. The ray tables (``TracedRays``, numpy) are static and
become constants of the caller's dtype and device:

* segment and solar optical depths are contractions of the traced weight
  tables with the extinction profile;
* the phase function at each segment boundary is a Legendre-coefficient
  contraction with the static ``P_l(cos Theta)`` tables of
  ``phase_tables``;
* each segment contributes the endpoint-blended constant source
  ``(1 - e^-od)/od * (J_in + J_out)/2 * ds``, attenuated by the optical
  depth between it and the observer (a suffix sum over the segments,
  which run from the far end toward the observer).

Padded segments carry zero weights; ``traced.mask`` removes them from
every sum, and the divisions are made safe for value and gradient alike.

The 2D functions take the sparse tables of ``rt/raytrace2d.trace_2d``
(4-entry bilinear gathers per segment, boundary and solar step) as CSR
matrices over the [nloc] location axis (``Rays2D``): a solar optical
depth is one sparse product where the JAX package's gather materialises
[W, R, S+1, 4 x 64] extinction values.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from ..memo import LazyTables, bounded_memo
from ..ops.sparse import SparseOp, apply_sparse
from ..ops.wigner import legendre_p, wigner_d
from ..util.torchmath import safe_div
from .raytrace import TracedRays
from .raytrace2d import TracedRays2D, trace_2d


def phase_tables(traced: TracedRays, nlegendre: int) -> np.ndarray:
    """P_l(cos Theta) at every segment boundary: [R, S+1, L] (static)."""
    return np.moveaxis(
        legendre_p(traced.cos_scatter, nlegendre), 0, -1
    )


def phase_tables_d02(traced: TracedRays, nlegendre: int) -> np.ndarray:
    """d^l_{02}(Theta) at every segment boundary: [R, S+1, L] (static).
    Contracted with the b1 greek coefficients it gives the I -> Q element
    of the scattering matrix."""
    theta = np.arccos(np.clip(traced.cos_scatter, -1.0, 1.0))
    return np.moveaxis(wigner_d(theta, 0, 2, nlegendre), 0, -1)


def _const(x, like):
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def _closer_od(od_m):
    """Optical depth between each segment and the observer: the suffix sum
    of the masked segment ODs, excluding the segment itself."""
    return torch.flip(torch.cumsum(torch.flip(od_m, (-1,)), -1), (-1,)) - od_m


def _source_factor(seg_od):
    """(1 - e^-od) / od, with its series below od = 1e-12."""
    od = torch.clamp(seg_od, min=0.0)
    return torch.where(
        od < 1e-12, 1.0 - 0.5 * od,
        -torch.expm1(-od) / torch.clamp(od, min=1e-12),
    )


def integrate_single_scatter(
    extinction, ssa, leg_coeff, albedo, traced: TracedRays, phase_tab,
):
    """Sun-normalized (F0 = 1) single-scatter radiance of every ray, [W, R].

    extinction/ssa [W, A] at the levels, leg_coeff [W, A, L], albedo [W];
    ``phase_tab`` [R, S+1, L] from ``phase_tables``. Ground-hitting rays
    add the Lambertian reflection of the direct beam at their far end.
    """
    odw = _const(traced.od_weights, extinction)
    sunw = _const(traced.sun_weights, extinction)
    intw = _const(traced.interp_weights, extinction)
    lengths = _const(traced.lengths, extinction)
    mask = _const(traced.mask, extinction)
    pt = _const(phase_tab, extinction)

    seg_od = torch.einsum("rsa,wa->wrs", odw, extinction)
    sun_od = torch.einsum("rba,wa->wrb", sunw, extinction)
    t_sun = torch.exp(-torch.clamp(sun_od, max=300.0))

    # scattering extinction and the scattering-weighted mean of beta at
    # the boundaries; padded boundaries have all-zero weights (0 / 0)
    kscat = extinction * ssa
    kscat_b = torch.einsum("rba,wa->wrb", intw, kscat)
    beta_num = torch.einsum(
        "rba,wal->wrbl", intw, leg_coeff * kscat[..., None]
    )
    beta_b = safe_div(beta_num, kscat_b[..., None])
    phase_b = torch.einsum("wrbl,rbl->wrb", beta_b, pt)

    # source per unit length toward the observer at each boundary;
    # segment s has entrance boundary s (far) and exit boundary s + 1
    j_b = kscat_b * phase_b / (4.0 * math.pi) * t_sun
    seg_src = (
        _source_factor(seg_od) * 0.5 * (j_b[..., :-1] + j_b[..., 1:])
        * lengths * mask
    )
    od_m = seg_od * mask
    radiance = torch.sum(seg_src * torch.exp(-_closer_od(od_m)), dim=-1)

    ground = _const(traced.ground_hit, extinction)
    mu0_g = _const(np.maximum(traced.ground_cos_sza, 0.0), extinction)
    total_od = torch.sum(od_m, dim=-1)
    ground_term = (
        ground * albedo[..., None] * mu0_g * t_sun[..., 0] / math.pi
    ) * torch.exp(-total_od)
    return radiance + ground_term


def integrate_single_scatter_polarized(
    extinction, ssa, leg_a1, leg_b1, albedo, traced: TracedRays, phase_tab,
    d02_tab,
):
    """Sun-normalized polarized (I, Q, U) single-scatter radiance of every
    ray, [W, R, 3] (``sasktran2_tpu/rt/singlescatter.py:142``).

    The sun is unpolarized, so only the first column of the scattering
    matrix enters: in the scattering plane the scattered Stokes vector is
    (a1(Theta), -sum_l b1_l d^l_{02}(Theta), 0), rotated into the ray
    meridian basis by the traced (cos 2s, sin 2s) tables. Attenuation is
    scalar and the Lambertian ground term is unpolarized. leg_a1/leg_b1
    [W, A, L]; ``d02_tab`` from ``phase_tables_d02``.
    """
    odw = _const(traced.od_weights, extinction)
    sunw = _const(traced.sun_weights, extinction)
    intw = _const(traced.interp_weights, extinction)
    lengths = _const(traced.lengths, extinction)
    mask = _const(traced.mask, extinction)
    pt = _const(phase_tab, extinction)
    d02 = _const(d02_tab, extinction)
    c2 = _const(traced.cos2rot, extinction)
    s2 = _const(traced.sin2rot, extinction)

    seg_od = torch.einsum("rsa,wa->wrs", odw, extinction)
    sun_od = torch.einsum("rba,wa->wrb", sunw, extinction)
    t_sun = torch.exp(-torch.clamp(sun_od, max=300.0))

    kscat = extinction * ssa
    kscat_b = torch.einsum("rba,wa->wrb", intw, kscat)

    def beta_boundary(lc):
        num = torch.einsum("rba,wal->wrbl", intw, lc * kscat[..., None])
        return safe_div(num, kscat_b[..., None])

    phase_i = torch.einsum("wrbl,rbl->wrb", beta_boundary(leg_a1), pt)
    # I -> Q scattering-plane element: F21(Theta) = -sum_l b1_l d^l_{02}
    f21 = -torch.einsum("wrbl,rbl->wrb", beta_boundary(leg_b1), d02)

    base = kscat_b / (4.0 * math.pi) * t_sun
    j_b = torch.stack(
        [base * phase_i, base * f21 * c2, base * f21 * s2], dim=-1
    )                                               # [W, R, S+1, 3]
    blend = (_source_factor(seg_od) * lengths * mask)[..., None]
    seg_src = blend * 0.5 * (j_b[..., :-1, :] + j_b[..., 1:, :])
    od_m = seg_od * mask
    radiance = torch.sum(
        seg_src * torch.exp(-_closer_od(od_m))[..., None], dim=-2
    )

    ground = _const(traced.ground_hit, extinction)
    mu0_g = _const(np.maximum(traced.ground_cos_sza, 0.0), extinction)
    total_od = torch.sum(od_m, dim=-1)
    ground_term = (
        ground * albedo[..., None] * mu0_g * t_sun[..., 0] / math.pi
    ) * torch.exp(-total_od)
    zero = torch.zeros_like(ground_term)
    return radiance + torch.stack([ground_term, zero, zero], dim=-1)


def emission_radiance(
    extinction, ssa, emission, albedo, surface_emission, traced: TracedRays,
):
    """Thermal emission along the rays, [W, R]: the source per unit length
    is k_absorption * B at the boundaries, plus (1 - albedo) * B_surf at
    the far end of ground-hitting rays. emission [W, A], surface_emission
    [W]."""
    odw = _const(traced.od_weights, extinction)
    intw = _const(traced.interp_weights, extinction)
    lengths = _const(traced.lengths, extinction)
    mask = _const(traced.mask, extinction)

    seg_od = torch.einsum("rsa,wa->wrs", odw, extinction)
    k_b = torch.einsum("rba,wa->wrb", intw, extinction)
    kscat_b = torch.einsum("rba,wa->wrb", intw, extinction * ssa)
    b_b = torch.einsum("rba,wa->wrb", intw, emission)
    j_b = (k_b - kscat_b) * b_b
    seg_src = (
        _source_factor(seg_od) * 0.5 * (j_b[..., :-1] + j_b[..., 1:])
        * lengths * mask
    )
    od_m = seg_od * mask
    radiance = torch.sum(seg_src * torch.exp(-_closer_od(od_m)), dim=-1)

    ground = _const(traced.ground_hit, extinction)
    total_od = torch.sum(od_m, dim=-1)
    ground_term = (
        ground * (1.0 - albedo[..., None]) * surface_emission[..., None]
    ) * torch.exp(-total_od)
    return radiance + ground_term


def ver_emission_radiance(extinction, emission, traced: TracedRays):
    """Volume-emission-rate emission, [W, R]: ``emission`` [W, A] is a
    radiance rate per metre, and each segment adds length * the mean of
    its endpoint values, attenuated by the closer segments (no absorption
    weighting and no (1 - e^-od) factor)."""
    odw = _const(traced.od_weights, extinction)
    intw = _const(traced.interp_weights, extinction)
    lengths = _const(traced.lengths, extinction)
    mask = _const(traced.mask, extinction)

    seg_od = torch.einsum("rsa,wa->wrs", odw, extinction)
    e_b = torch.einsum("rba,wa->wrb", intw, emission)
    seg_src = 0.5 * (e_b[..., :-1] + e_b[..., 1:]) * lengths * mask
    od_m = seg_od * mask
    return torch.sum(seg_src * torch.exp(-_closer_od(od_m)), dim=-1)


def integrate_od_source(extinction, j_in, j_out, traced: TracedRays):
    """Integrate a per-unit-optical-depth source along the rays:
    I = sum_s T_closer(s) (1 - e^-dtau_s) (J_in + J_out) / 2.

    j_in/j_out [W, R, S] at the segment entrances/exits; returns [W, R].
    """
    odw = _const(traced.od_weights, extinction)
    mask = _const(traced.mask, extinction)
    seg_od = torch.einsum("rsa,wa->wrs", odw, extinction)
    od_m = seg_od * mask
    seg_src = -torch.expm1(-od_m) * 0.5 * (j_in + j_out) * mask
    return torch.sum(seg_src * torch.exp(-_closer_od(od_m)), dim=-1)


def optical_depth(extinction, traced: TracedRays):
    """Total line-of-sight optical depth of every ray, [W, R]."""
    odw = _const(traced.od_weights, extinction)
    mask = _const(traced.mask, extinction)
    seg_od = torch.einsum("rsa,wa->wrs", odw, extinction)
    return torch.sum(seg_od * mask, dim=-1)


def occultation_radiance(extinction, traced: TracedRays):
    """Transmission of a unit source at the far end of every ray that does
    not hit the ground, [W, R]."""
    od = optical_depth(extinction, traced)
    not_ground = 1.0 - _const(traced.ground_hit, extinction)
    return torch.exp(-od) * not_ground


# ---------------------------------------------------------------------------
# 2D geometry (``sasktran2_tpu/rt/singlescatter.py:326-450``)
# ---------------------------------------------------------------------------

# the 2D traces of this process, most recently used last: the host tracer
# walks every boundary's solar path in Python (about 0.45 s per ray at
# 101 altitudes x 41 angles), and engines of one geometry in float32 and
# float64 share one trace
_TRACE_2D_CACHE: OrderedDict = OrderedDict()
TRACE_2D_CACHE_SIZE = 4


def _ray_key(ray):
    return (type(ray).__name__, tuple(sorted(vars(ray).items())))


def traced_2d(altitude_grid_m, horizontal_angles, earth_radius_m,
              cos_sza_ref, rays, refractive_index=None,
              los_refraction=False) -> TracedRays2D:
    """``raytrace2d.trace_2d``, memoised within the process on its
    arguments (the grids' and the refractive index's bytes, the earth
    radius, the reference cos_sza, each ray's class and fields, the
    refraction flag). The memo keeps the ``TRACE_2D_CACHE_SIZE`` most
    recently used traces."""
    def as_bytes(a):
        return (None if a is None
                else np.ascontiguousarray(a, dtype=np.float64).tobytes())

    key = (as_bytes(altitude_grid_m), as_bytes(horizontal_angles),
           float(earth_radius_m), float(cos_sza_ref),
           tuple(_ray_key(r) for r in rays),
           as_bytes(refractive_index), bool(los_refraction))
    return bounded_memo(
        _TRACE_2D_CACHE, key,
        lambda: trace_2d(
            altitude_grid_m, horizontal_angles, earth_radius_m, cos_sza_ref,
            rays, refractive_index=refractive_index,
            los_refraction=los_refraction,
        ),
        TRACE_2D_CACHE_SIZE,
    )


class Rays2D:
    """The tables of a ``TracedRays2D`` as sparse operators on the
    location axis, built on the host once and kept per (device, dtype):

    * ``od`` [R S, nloc]: segment optical depth weights (od_idx, od_w)
    * ``sun`` [R (S+1), nloc]: the optical depth to the sun at each
      boundary (sun_idx, sun_w; a boundary shadowed by the ground holds
      one weight of 1e10)
    * ``interp`` [R (S+1), nloc]: the bilinear interpolation of a level
      quantity onto each boundary (interp_idx, interp_w)

    and the dense per-ray tables (lengths, mask, ground_hit)."""

    def __init__(self, traced2d: TracedRays2D):
        self.traced = traced2d
        R, S, _ = traced2d.od_idx.shape
        self.shape = (R, S)
        nloc = traced2d.nloc

        def entries(idx, w):
            rows = np.repeat(np.arange(idx.shape[0] * idx.shape[1]),
                             idx.shape[2])
            return (rows, idx.ravel(), w.ravel(),
                    (idx.shape[0] * idx.shape[1], nloc))

        self._entries = {
            "od": entries(traced2d.od_idx, traced2d.od_w),
            "sun": entries(traced2d.sun_idx, traced2d.sun_w),
            "interp": entries(traced2d.interp_idx, traced2d.interp_w),
        }
        self._on = LazyTables()

    def on(self, device, dtype) -> dict:
        """The operators and dense tables on ``device`` in ``dtype``,
        built at the first request."""
        device = torch.device(device)

        def build():
            ops = {k: SparseOp(*v, device, dtype)
                   for k, v in self._entries.items()}
            for k in ("lengths", "mask", "ground_hit"):
                ops[k] = torch.as_tensor(
                    np.asarray(getattr(self.traced, k), dtype=np.float64),
                    dtype=dtype, device=device)
            return ops

        return self._on.get((device, dtype), build)


def _gather2d(op, x, rows):
    """``op`` [R rows, nloc] applied to the location axis of x [W, nloc]
    (or [W, nloc, L]): [W, R, rows] (or [W, R, rows, L])."""
    W, nloc = x.shape[:2]
    tail = x.shape[2:]
    flat = x.reshape(W, nloc, -1).permute(1, 0, 2).reshape(nloc, -1)
    y = apply_sparse(flat, op)                      # [R rows, W (L)]
    y = y.reshape(-1, rows, W, *tail)
    return y.movedim(2, 0)


def _segment_od_2d(ext, rays, ops):
    """Masked segment optical depths max(od, 0) * mask, [W, R, S]."""
    R, S = rays.shape
    seg_od = _gather2d(ops["od"], ext, S)
    return torch.clamp(seg_od, min=0.0) * ops["mask"]


def _blend_2d(od, j_b, ops):
    """The endpoint-blended constant-source model along the 2D rays:
    sum_s (1 - e^-od)/od (J_in + J_out)/2 ds exp(-closer od), [W, R]."""
    seg_src = (_source_factor(od) * 0.5 * (j_b[..., :-1] + j_b[..., 1:])
               * ops["lengths"] * ops["mask"])
    return torch.sum(seg_src * torch.exp(-_closer_od(od)), dim=-1)


def integrate_single_scatter_2d(extinction, ssa, leg_coeff, rays,
                                phase_tab):
    """Sun-normalized single scatter along the rays of a 2D atmosphere,
    [W, R] (``sasktran2_tpu/rt/singlescatter.py:326``).

    extinction/ssa [W, nloc] on the flattened (angle, altitude) grid,
    leg_coeff [W, nloc, L]; ``rays`` the trace's ``Rays2D``; ``phase_tab`` [R, S+1, L], P_l(cos Theta) at the
    boundaries."""
    ops = rays.on(extinction.device, extinction.dtype)
    R, S = rays.shape
    pt = _const(phase_tab, extinction)

    od = _segment_od_2d(extinction, rays, ops)
    sun_od = _gather2d(ops["sun"], extinction, S + 1)
    t_sun = torch.exp(-torch.clamp(sun_od, max=300.0))

    kscat = extinction * ssa
    kscat_b = _gather2d(ops["interp"], kscat, S + 1)
    beta_num = _gather2d(ops["interp"], leg_coeff * kscat[..., None], S + 1)
    denom = kscat_b[..., None]
    ok = denom > 0.0
    beta_b = torch.where(
        ok, beta_num / torch.where(ok, denom, torch.ones_like(denom)),
        torch.zeros_like(beta_num),
    )
    phase_b = torch.einsum("wrbl,rbl->wrb", beta_b, pt)
    j_b = kscat_b * phase_b / (4.0 * math.pi) * t_sun
    return _blend_2d(od, j_b, ops)


def emission_radiance_2d(extinction, ssa, emission, rays):
    """Standard (thermal) emission along the rays of a 2D atmosphere,
    [W, R] (``singlescatter.py:380``): J = k_abs B at the boundaries, the
    endpoint-blended model, attenuated by the closer segments.
    extinction/ssa/emission [W, nloc]."""
    ops = rays.on(extinction.device, extinction.dtype)
    S = rays.shape[1]
    od = _segment_od_2d(extinction, rays, ops)
    k_b = _gather2d(ops["interp"], extinction, S + 1)
    kscat_b = _gather2d(ops["interp"], extinction * ssa, S + 1)
    b_b = _gather2d(ops["interp"], emission, S + 1)
    return _blend_2d(od, (k_b - kscat_b) * b_b, ops)


def ver_emission_radiance_2d(extinction, emission, rays):
    """Volume-emission-rate emission along the rays of a 2D atmosphere,
    [W, R] (``singlescatter.py:425``): each segment adds its length times
    the mean of its boundary rates, attenuated by the closer segments."""
    ops = rays.on(extinction.device, extinction.dtype)
    S = rays.shape[1]
    od = _segment_od_2d(extinction, rays, ops)
    e_b = _gather2d(ops["interp"], emission, S + 1)
    seg_src = (0.5 * (e_b[..., :-1] + e_b[..., 1:]) * ops["lengths"]
               * ops["mask"])
    return torch.sum(seg_src * torch.exp(-_closer_od(od)), dim=-1)


def optical_depth_2d(extinction, rays):
    """Total line-of-sight optical depth of every 2D ray, [W, R]
    (``singlescatter.py:443``)."""
    ops = rays.on(extinction.device, extinction.dtype)
    seg_od = _gather2d(ops["od"], extinction, rays.shape[1])
    return torch.sum(seg_od * ops["mask"], dim=-1)
