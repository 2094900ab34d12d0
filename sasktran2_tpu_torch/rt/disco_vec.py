"""The polarized (I, Q, U) discrete-ordinates solver of the generic route
(counterpart of ``sasktran2_tpu/rt/disco_vec.py``), and its host-side
helpers (copies of ``disco_vec.py:52-118``; a test pins them array-equal).

With the generalized-spherical-function matrices

    Pi_l^m(mu) = [[ d^l_{m0},      0,        0    ],
                  [ 0,          P+_{lm},  -P-_{lm} ],
                  [ 0,         -P-_{lm},   P+_{lm} ]],
    P+- = (d^l_{m2} +- d^l_{m,-2}) / 2,

and the Greek matrix B_l = [[a1, -b1, 0], [-b1, a2, 0], [0, 0, a3]]_l,
flipping the sign of U in the downwelling field (D = diag(1, 1, -1))
gives the vector system the scalar solver's symmetric structure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import spans
from ..ops.linalg import ediff
from ..ops.quadrature import streams
from ..ops.wigner import wigner_d
from .disco import (
    _as,
    _bvp_blocks,
    _eigensolve,
    _greens_coefficients,
    _level_fields,
    _Modes,
    _particular_boundary,
    _solver_f0,
    _source_multipliers,
    beam_attenuation_leading,
    brdf_azimuth_moments,
    clamp_ssa,
    thermal_layer_fit,
)

NS = 3
DSIGN = np.array([1.0, 1.0, -1.0])


def _pi_matrices(mu_vals: np.ndarray, m: int, lmax: int) -> np.ndarray:
    """Pi_l^m matrices at the given cosines: [L, n, 3, 3]."""
    mu_vals = np.asarray(mu_vals, dtype=np.float64)
    theta = np.arccos(np.clip(mu_vals, -1.0, 1.0))
    d0 = wigner_d(theta, m, 0, lmax)
    d2p = wigner_d(theta, m, 2, lmax)
    d2m = wigner_d(theta, m, -2, lmax)
    pp = 0.5 * (d2p + d2m)
    pm = 0.5 * (d2p - d2m)
    out = np.zeros((lmax,) + mu_vals.shape + (3, 3))
    out[..., 0, 0] = d0
    out[..., 1, 1] = pp
    out[..., 2, 2] = pp
    out[..., 1, 2] = -pm
    out[..., 2, 1] = -pm
    return out


@dataclass(frozen=True)
class VectorModeTables:
    pi_stream: np.ndarray  # [M, L, N, 3, 3]
    pi_sun_d0: np.ndarray  # [M, L] (only d_{m0}(mu0) enters for a solar beam)
    pi_user: np.ndarray    # [M, L, U, 3, 3]
    parity: np.ndarray     # [M, L]
    mu: np.ndarray
    w: np.ndarray
    mu0: float
    user_mu: np.ndarray


def build_vector_mode_tables(
    nstr: int,
    nlegendre: int,
    mu0: float,
    user_mu: np.ndarray,
    num_azimuth: int | None = None,
) -> VectorModeTables:
    if num_azimuth is None:
        num_azimuth = nstr
    mu, w = streams(nstr)
    L = max(nlegendre, 1)
    user_mu = np.asarray(user_mu, dtype=np.float64)
    pi_stream = np.zeros((num_azimuth, L, len(mu), 3, 3))
    pi_sun_d0 = np.zeros((num_azimuth, L))
    pi_user = np.zeros((num_azimuth, L, len(user_mu), 3, 3))
    parity = np.zeros((num_azimuth, L))
    ls = np.arange(L)
    theta0 = np.arccos(np.clip(mu0, -1.0, 1.0))
    for m in range(num_azimuth):
        pi_stream[m] = _pi_matrices(mu, m, L)
        pi_user[m] = _pi_matrices(user_mu, m, L)
        pi_sun_d0[m] = wigner_d(np.array(theta0), m, 0, L)
        parity[m] = (-1.0) ** (ls + m)
    return VectorModeTables(
        pi_stream=pi_stream,
        pi_sun_d0=pi_sun_d0,
        pi_user=pi_user,
        parity=parity,
        mu=mu,
        w=w,
        mu0=float(mu0),
        user_mu=user_mu,
    )


# ---------------------------------------------------------------------------
# The generic vector solver: batch-leading, the azimuth modes as a leading
# batch axis, as ``rt.disco.solve_plane_parallel`` (whose BVP, eigensolve and
# Green's-function helpers it shares on flattened (stream x stokes) vectors).
# ---------------------------------------------------------------------------

_E0 = np.array([1.0, 0.0, 0.0])


def _greek_matrices(a1, a2, a3, b1):
    """B_l matrices [..., P, L, 3, 3] from the greek arrays [..., P, L]."""
    z = torch.zeros_like(a1)
    row0 = torch.stack([a1, -b1, z], dim=-1)
    row1 = torch.stack([-b1, a2, z], dim=-1)
    row2 = torch.stack([z, z, a3], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _assemble_symmetric_vec(omega, bgreek, pi, parity, mu, w, nb):
    """Flattened symmetrized matrices A_hat, B_hat [M, ..., P, K, K],
    K = 3N, and the flattened stream cosines and weights (numpy [K]):
    C^A/B = 1/2 sum_l Pi_i B_l G Pi_j^T with G = diag(1 -+ nu, 1 -+ nu,
    1 +- nu)."""
    N = pi.shape[2]
    gplus = np.stack([1.0 + parity, 1.0 + parity, 1.0 - parity], axis=-1)
    gminus = np.stack([1.0 - parity, 1.0 - parity, 1.0 + parity], axis=-1)
    pi_t = _as(pi, bgreek, nb)                       # [M, 1.., L, N, 3, 3]

    def kernel(g):
        bg = bgreek * _as(g, bgreek, nb)[..., None, :, None, :]
        pib = torch.einsum("...lisa,...plab->...plisb", pi_t, bg)
        return 0.5 * torch.einsum("...plisb,...ljtb->...pisjt", pib, pi_t)

    K = N * NS
    ca = kernel(gminus)
    cb = kernel(gplus)
    ca = ca.reshape(ca.shape[:-4] + (K, K))
    cb = cb.reshape(cb.shape[:-4] + (K, K))
    mu_f = np.repeat(mu, NS)
    w_f = np.repeat(w, NS)
    s = np.sqrt(w_f / mu_f)
    scale = torch.as_tensor(s[:, None] * s[None, :], dtype=omega.dtype,
                            device=omega.device)
    diag = torch.as_tensor(np.diag(1.0 / mu_f), dtype=omega.dtype,
                           device=omega.device)
    a_hat = diag - omega[..., None, None] * ca * scale
    b_hat = diag - omega[..., None, None] * cb * scale
    return a_hat, b_hat, mu_f, w_f


def _beam_sources_vec(omega, bgreek, pi, d0_sun, parity, modes):
    """Q~+/- flattened beam sources [M, ..., P, K]: c sum_l (nu_l) d0_l
    (Pi_i B_l) e1, c = (2 - delta_m0) omega / 4 pi."""
    nb = modes.nb
    c = modes.two_minus_delta(1) * omega / (4.0 * math.pi)
    be1 = bgreek[..., :, 0]                           # [..., P, L, 3]
    pi_t = _as(pi, omega, nb)
    base_p = torch.einsum("...lisa,...pla,...l->...pis", pi_t, be1,
                          _as(parity * d0_sun, omega, nb))
    base_m = torch.einsum("...lisa,...pla,...l->...pis", pi_t, be1,
                          _as(d0_sun, omega, nb))
    shape = base_p.shape[:-2] + (base_p.shape[-2] * NS,)
    return (c[..., None] * base_p.reshape(shape),
            c[..., None] * base_m.reshape(shape))


def _postprocess_mode_vec(
    k, x, y, coeff_l, coeff_m, sources,
    omega, bgreek, dtau,
    pi, pi_user, d0_sun, parity, w, modes,
    user_mu, user_up, refl_user_I, gd_user_sun, ground_thermal,
    include_ss, phi_mb,
):
    """Vector user-angle post-processing: radiance [M, ..., U, 3].
    ``sources`` lists (c_minus amp, c_plus amp, amp, decay, kind), kind
    "beam" (direct term gated by ``include_ss``) or "thermal" (isotropic,
    I only, m = 0, always included)."""
    nb = modes.nb
    dt, dev = k.dtype, k.device
    P = k.shape[-2]
    N = pi.shape[2]
    A = k.shape[-1]
    xs = x.reshape(x.shape[:-2] + (N, NS, A))
    ys = y.reshape(y.shape[:-2] + (N, NS, A))
    dsign = torch.as_tensor(DSIGN, dtype=dt, device=dev)
    wt = torch.as_tensor(w, dtype=dt, device=dev)
    pi_t = _as(pi, k, nb)
    t1 = torch.einsum("...ljsc,...pjsa,j->...plca", pi_t, xs, wt)
    t2 = torch.einsum("...ljsc,...pjsa,j->...plca", pi_t, ys, wt)
    pd = _as(parity, k, nb)[..., None, :, None, None] * dsign[:, None]
    g_v = t1 + pd * t2
    g_u = t2 + pd * t1

    half_om = 0.5 * omega[..., None, None, None]
    bv = torch.einsum("...plab,...plbc->...plac", bgreek, g_v)
    bu = torch.einsum("...plab,...plbc->...plac", bgreek, g_u)
    pu_t = _as(pi_user, k, nb)                        # [M, 1.., L, U, 3, 3]
    par_t = _as(parity, k, nb)
    pv_up = half_om * torch.einsum("...lusa,...plac->...pusc", pu_t, bv)
    pu_up = half_om * torch.einsum("...lusa,...plac->...pusc", pu_t, bu)
    pv_dn = half_om * torch.einsum("...lusa,a,...plac,...l->...pusc",
                                   pu_t, dsign, bv, par_t)
    pu_dn = half_om * torch.einsum("...lusa,a,...plac,...l->...pusc",
                                   pu_t, dsign, bu, par_t)

    cbeam = modes.two_minus_delta(1) * omega / (4.0 * math.pi)
    be1 = bgreek[..., :, 0]
    beam_up = cbeam[..., None, None] * torch.einsum(
        "...lusa,...pla,...l->...pus", pu_t, be1,
        _as(parity * d0_sun, k, nb))
    beam_dn = cbeam[..., None, None] * torch.einsum(
        "...lusa,a,...pla,...l->...pus", pu_t, dsign, be1,
        _as(d0_sun, k, nb))

    um = user_mu[:, None]
    cb = 1.0 / um
    du = dtau[..., None, None]
    ku = k[..., None, :]
    efwd_k = ediff(torch.zeros_like(ku), ku + cb, du) / um
    erev_k = ediff(ku, cb + torch.zeros_like(ku), du) / um
    lu = coeff_l[..., None, :]
    mu_c = coeff_m[..., None, :]
    s_up = torch.sum(pv_up * (lu * efwd_k)[..., None, :]
                     + pu_up * (mu_c * erev_k)[..., None, :], dim=-1)
    s_dn = torch.sum(pv_dn * (lu * erev_k)[..., None, :]
                     + pu_dn * (mu_c * efwd_k)[..., None, :], dim=-1)

    e0 = torch.as_tensor(_E0, dtype=dt, device=dev)
    is_m0 = modes.is_m0(2)
    for c_minus_amp, c_plus_amp, amp, decay, kind in sources:
        (efwd_s, erev_s, gm_up, gp_up, gm_dn, gp_dn) = _source_multipliers(
            k, dtau, decay, user_mu)
        cmu = c_minus_amp[..., None, :]
        cpu = c_plus_amp[..., None, :]
        s_up = s_up + torch.sum(pv_up * (cmu * gm_up)[..., None, :]
                                - pu_up * (cpu * gp_up)[..., None, :], dim=-1)
        s_dn = s_dn + torch.sum(pv_dn * (cmu * gm_dn)[..., None, :]
                                - pu_dn * (cpu * gp_dn)[..., None, :], dim=-1)
        if kind == "beam":
            if include_ss:
                amp_u = amp[..., None, None]
                s_up = s_up + beam_up * (amp_u * efwd_s[..., 0:1])
                s_dn = s_dn + beam_dn * (amp_u * erev_s[..., 0:1])
        else:
            one_minus_om = (1.0 - omega)[..., None]
            amp_d = amp[..., None]
            th_up = is_m0 * one_minus_om * amp_d * efwd_s[..., 0]
            th_dn = is_m0 * one_minus_om * amp_d * erev_s[..., 0]
            s_up = s_up + th_up[..., None] * e0
            s_dn = s_dn + th_dn[..., None] * e0

    od_user = dtau[..., :, None] / user_mu
    cum_above = torch.cumsum(od_user, dim=-2) - od_user
    cum_below = torch.flip(
        torch.cumsum(torch.flip(od_user, (-2,)), dim=-2), (-2,)) - od_user
    rad_up = torch.sum(torch.exp(-cum_above)[..., None] * s_up, dim=-3)

    # ground: reflects I only
    e = torch.exp(-k * dtau[..., None])
    i_minus_ground_f = (
        torch.einsum("...ia,...a->...i", (y * e[..., None, :])[..., P - 1, :, :],
                     coeff_l[..., P - 1, :])
        + torch.einsum("...ia,...a->...i", x[..., P - 1, :, :],
                       coeff_m[..., P - 1, :])
        + torch.einsum("...ia,...a->...i", y[..., P - 1, :, :],
                       phi_mb[..., P - 1, :])
    )
    i_minus_I = i_minus_ground_f[..., 0::NS]
    ground_up_I = torch.einsum("...uj,...j->...u", refl_user_I, i_minus_I)
    if include_ss:
        ground_up_I = ground_up_I + gd_user_sun
    if ground_thermal is not None:
        ground_up_I = ground_up_I + ground_thermal[..., None]
    total_od_user = torch.sum(od_user, dim=-2)
    rad_up = rad_up + (torch.exp(-total_od_user) * ground_up_I)[..., None] * e0

    rad_dn = torch.sum(torch.exp(-cum_below)[..., None] * s_dn, dim=-3)
    rad_dn = rad_dn * dsign          # physical = D J~
    return torch.where(user_up[:, None], rad_up, rad_dn)


def _solve_one_mode_vec(
    modes, pi, d0_sun, pi_user, parity,
    dtau, omega, bgreek, t_top, sbar, t_ground,
    albedo, mu, w, mu0, user_mu, user_up, include_ss, f0,
    thermal=None, surface_ops=None,
):
    """Every azimuth mode of the vector solve at once: (radiance
    [M, ..., U, 3], level fields [M, ..., P, K] in the transformed
    frame)."""
    dt, dev = dtau.dtype, dtau.device
    N = len(mu)
    K = N * NS
    U = len(user_mu)
    a_hat, b_hat, mu_f, w_f = _assemble_symmetric_vec(
        omega, bgreek, pi, parity, mu, w, modes.nb)
    k, x, y = _eigensolve(a_hat, b_hat, mu_f, w_f)

    amp_beam = t_top * f0[..., None]
    qp, qm = _beam_sources_vec(omega, bgreek, pi, d0_sun, parity, modes)
    c_minus, c_plus = _greens_coefficients(k, x, y, qp, qm, w_f)
    sources = [(c_minus * amp_beam[..., None], c_plus * amp_beam[..., None],
                amp_beam, sbar, "beam")]
    e1 = torch.as_tensor(np.tile(_E0, N), dtype=dt, device=dev)   # [K]
    if thermal is not None:
        b0, tb1, _ = thermal
        q_th = modes.is_m0(2) * (1.0 - omega)[..., None] * e1
        c_minus_th, c_plus_th = _greens_coefficients(k, x, y, q_th, q_th, w_f)
        sources.append((c_minus_th * b0[..., None], c_plus_th * b0[..., None],
                        b0, tb1, "thermal"))

    phi_mb = 0.0
    phi_pt = 0.0
    for c_m_amp, c_p_amp, _amp, decay, _kind in sources:
        mb, pt = _particular_boundary(
            k, c_m_amp, c_p_amp, torch.ones_like(t_top), decay, dtau)
        phi_mb = phi_mb + mb
        phi_pt = phi_pt + pt

    # the ground couples the I components only (the scalar BRDF kernel is
    # the (1,1) block of the polarized surface)
    wmu = torch.as_tensor(w * mu, dtype=dt, device=dev)
    is_m0 = modes.is_m0(0)
    if surface_ops is None:
        base = 2.0 * modes.is_m0(2) * albedo[..., None, None] * wmu
        refl_I = base.expand(base.shape[:-2] + (N, N))
        refl_user_I = base.expand(base.shape[:-2] + (U, N))
        ground_sun = is_m0 * albedo * mu0 * t_ground * f0 / math.pi
        gs_stream = ground_sun[..., None] * torch.ones(N, dtype=dt,
                                                       device=dev)
        gd_user_sun = ground_sun[..., None] * torch.ones(U, dtype=dt,
                                                         device=dev)
    else:
        tmd = modes.two_minus_delta(1)
        sun_in = (mu0 * t_ground * f0)[..., None]
        refl_I = 2.0 * math.pi * surface_ops["rho_stream"] * wmu
        refl_user_I = 2.0 * math.pi * surface_ops["rho_user"] * wmu
        gs_stream = tmd * surface_ops["rho_sun_stream"] * sun_in
        gd_user_sun = tmd * surface_ops["rho_sun_user"] * sun_in
    ground_thermal = (
        is_m0 * (1.0 - albedo) * thermal[2] if thermal is not None else None
    )
    e00 = torch.zeros((NS, NS), dtype=dt, device=dev)
    e00[0, 0] = 1.0
    refl = (refl_I[..., :, None, :, None] * e00[:, None, :]).reshape(
        refl_I.shape[:-2] + (K, K))
    gd = gs_stream if ground_thermal is None else (
        gs_stream + ground_thermal[..., None])
    e0 = torch.as_tensor(_E0, dtype=dt, device=dev)
    ground_direct = (gd[..., None] * e0).reshape(gd.shape[:-1] + (K,))

    coeff_l, coeff_m = _bvp_blocks(
        k, x, y, dtau, phi_mb, phi_pt, refl, ground_direct)
    rad = _postprocess_mode_vec(
        k, x, y, coeff_l, coeff_m, sources,
        omega, bgreek, dtau,
        pi, pi_user, d0_sun, parity, w, modes,
        user_mu, user_up, refl_user_I, gd_user_sun, ground_thermal,
        include_ss, phi_mb,
    )
    levels = _level_fields(k, x, y, dtau, coeff_l, coeff_m, phi_mb, phi_pt)
    return rad, levels


def solve_plane_parallel_vector(
    dtau,
    omega,
    a1, a2, a3, b1,
    albedo,
    tables: VectorModeTables,
    user_up,
    user_azimuth,
    include_ss: bool = True,
    chapman=None,
    num_azimuth: int | None = None,
    f0=None,
    return_internal: bool = False,
    thermal_b0=None,
    thermal_b1_bottom=None,
    surface_emission=None,
    brdf=None,
    brdf_args=None,
):
    """The polarized DO solve of the generic route, batch-leading
    (``sasktran2_tpu/rt/disco_vec.py:201-338``). Greek arrays a1, a2, a3,
    b1 [..., P, L]; the other inputs as ``rt.disco.solve_plane_parallel``.
    The thermal source is unpolarized (I only, m = 0); a BRDF reflects I
    only.

    Returns radiance [..., U, 3] (I, Q, U); with ``return_internal`` also
    the dict ``rt.do_source.ms_source_along_rays_vec`` reads: ``levels``
    (each [M, ..., P, K], transformed frame), the clamped ``omega``,
    ``bgreek`` [..., P, L, 3, 3], ``greeks`` (a1, a2, a3, b1 truncated),
    ``dtau``, ``t_top``, ``sbar``, ``t_ground``, the mode tables
    ``d0_sun``, ``parity`` and ``pi_stream`` (numpy), ``w_quad``, ``mu0``,
    ``f0`` and ``thermal``.
    """
    dt, dev = dtau.dtype, dtau.device
    mu0 = tables.mu0
    t_top, t_ground, sbar = beam_attenuation_leading(dtau, mu0, chapman)

    M = tables.pi_stream.shape[0]
    if num_azimuth is not None:
        M = min(M, num_azimuth)
    mu = np.asarray(tables.mu)
    w = np.asarray(tables.w)
    nstr = 2 * len(mu)
    luse = min(a1.shape[-1], max(nstr, 1))
    a1, a2, a3, b1 = (v[..., :luse] for v in (a1, a2, a3, b1))
    pi = np.asarray(tables.pi_stream[:M, :luse])
    d0_sun = np.asarray(tables.pi_sun_d0[:M, :luse])
    pi_user = np.asarray(tables.pi_user[:M, :luse])
    parity = np.asarray(tables.parity[:M, :luse])
    user_mu = torch.as_tensor(np.asarray(tables.user_mu), dtype=dt,
                              device=dev)
    user_up_t = torch.as_tensor(np.asarray(user_up, dtype=bool), device=dev)
    user_azimuth = torch.as_tensor(np.asarray(user_azimuth), dtype=dt,
                                   device=dev)
    modes = _Modes(np.arange(M), albedo.ndim, dt, dev)
    f0 = _solver_f0(f0, albedo)
    bgreek = _greek_matrices(a1, a2, a3, b1)
    omega_c = clamp_ssa(omega)

    thermal = None
    if thermal_b0 is not None or thermal_b1_bottom is not None:
        thermal = thermal_layer_fit(thermal_b0, thermal_b1_bottom, dtau,
                                    surface_emission, albedo)
    surface_ops = None
    if brdf is not None:
        surface_ops = brdf_azimuth_moments(
            brdf, brdf_args, torch.as_tensor(mu, dtype=dt, device=dev),
            user_mu, mu0, np.arange(M))

    # every azimuth mode in one batch: one span for all of them
    with spans.span("do_mode", mode=0, modes=M, recompute=0):
        rad_modes, levels = _solve_one_mode_vec(
            modes, pi, d0_sun, pi_user, parity,
            dtau, omega_c, bgreek, t_top, sbar, t_ground,
            albedo, mu, w, mu0, user_mu, user_up_t, include_ss, f0,
            thermal, surface_ops,
        )
    m_t = torch.arange(M, dtype=dt, device=dev)
    dphi = math.pi - user_azimuth
    cosm = torch.cos(m_t[:, None] * dphi[None, :])
    sinm = torch.sin(m_t[:, None] * dphi[None, :])
    weights = torch.stack([cosm, cosm, sinm], dim=-1)      # [M, U, 3]
    radiance = torch.einsum("m...us,mus->...us", rad_modes, weights)
    if return_internal:
        internal = {
            "levels": levels,
            "omega": omega_c,
            "bgreek": bgreek,
            "greeks": (a1, a2, a3, b1),
            "dtau": dtau,
            "t_top": t_top,
            "sbar": sbar,
            "t_ground": t_ground,
            "d0_sun": d0_sun,
            "parity": parity,
            "pi_stream": pi,
            "w_quad": w,
            "mu0": mu0,
            "f0": f0,
            "thermal": thermal,
        }
        return radiance, internal
    return radiance
