"""Exact single scatter and the other line-of-sight sources (counterpart of
``sasktran2_tpu/rt/singlescatter.py``, the 1D functions, scalar and
polarized).

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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.wigner import legendre_p, wigner_d
from ..util.torchmath import safe_div
from .raytrace import TracedRays


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
