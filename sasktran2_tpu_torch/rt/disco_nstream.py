"""Wavelength-minor N-stream discrete-ordinates solver (counterpart of
``sasktran2_tpu/rt/disco_nstream.py``).

Same physics and the same layout as the reference: exact symmetrization
-> Cholesky + tournament-Jacobi eigensolve, Green's-function particular
solution with the analytic -1/k J-norms, block-tridiagonal BVP (the
Thomas kernel) and the divided-difference post-processing multipliers,
with every array carrying the wavelength axis last.

Scope: scalar radiance; the solar beam and the thermal source (the
Planck function exponential in optical depth across each layer, and the
ground's emission); a Lambertian ground or a BRDF through its azimuth
moments.

Shapes: dtau/omega [P, W], beta [L, P, W], albedo/f0 [W]; radiance [U, W].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.lanes import (
    lane_block_thomas_solve,
    lane_cholesky,
    lane_jacobi_eigh_scan,
    lane_mm,
    lane_solve_upper,
    lane_t,
)
from ..ops.linalg import ddiff2, ediff
from .disco import (
    KMIN,
    ModeTables,
    beam_attenuation,
    brdf_azimuth_moments,
    build_mode_tables,
    clamp_ssa,
    thermal_layer_fit,
)

__all__ = ["build_mode_tables", "solve_nstream", "solve_nstream_m0_levels"]


def _contract_legendre(weights, beta):
    """sum_l weights[l, ...] beta[l, p, w] -> [p, ..., w] for weights of
    shape [L], [L, I] or [L, I, J]."""
    w = torch.as_tensor(weights, dtype=beta.dtype, device=beta.device)
    if w.ndim == 1:
        return torch.einsum("l,lpw->pw", w, beta)
    if w.ndim == 2:
        return torch.einsum("li,lpw->piw", w, beta)
    return torch.einsum("lij,lpw->pijw", w, beta)


def _mode_radiance(
    m_idx, lam, lam_sun, lam_user, parity,
    dtau, omega, beta, t_top, sbar, t_ground,
    albedo, mu, w, mu0, user_mu, user_up, include_ss, f0, thermal,
    with_levels=False, surface_ops=None,
):
    """One azimuth mode, wavelength-minor. ``m_idx`` is the mode number;
    lam [L, N], lam_sun [L], lam_user [L, U] and parity [L] are its
    tables. ``thermal`` is None or (b0, b1, surface emission) from
    ``disco.thermal_layer_fit``; ``surface_ops`` is None (Lambertian) or
    the mode's BRDF azimuth moments in lane layout (rho_stream [N, N, W],
    rho_user [U, N, W], rho_sun_stream [N, W], rho_sun_user [U, W]).
    Returns radiance [U, W], and with ``with_levels`` also the stream
    fields at the layer tops and bottoms, a dict of [P, N, W]."""
    dt = dtau.dtype
    dev = dtau.device

    def const(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    N = len(mu)
    P = dtau.shape[0]
    omega = clamp_ssa(omega)
    even = (parity > 0).to(dt)

    # --- symmetrized layer matrices ---------------------------------------
    ll = lam[:, :, None] * lam[:, None, :]                  # [L, N, N]
    cb = _contract_legendre(ll * even[:, None, None], beta)  # [P, N, N, W]
    ca = _contract_legendre(ll * (1.0 - even)[:, None, None], beta)
    s = np.sqrt(w / mu)
    scale = const(s[:, None] * s[None, :])[None, :, :, None]
    diag = const(np.diag(1.0 / mu))[None, :, :, None]
    om = omega[:, None, None, :]
    a_hat = diag - om * ca * scale
    b_hat = diag - om * cb * scale

    # --- eigensolve --------------------------------------------------------
    chol = lane_cholesky(b_hat)
    m_sym = lane_mm(lane_mm(lane_t(chol), a_hat), chol)
    m_sym = 0.5 * (m_sym + lane_t(m_sym))
    k2, v = lane_jacobi_eigh_scan(m_sym)
    k = torch.sqrt(torch.clamp(k2, min=KMIN * KMIN))       # [P, A, W]
    f_hat = lane_solve_upper(lane_t(chol), v)
    g_hat = lane_mm(chol, v) / k[..., None, :, :]
    dinv = const(1.0 / np.sqrt(w * mu))[None, :, None, None]
    x = 0.5 * dinv * (f_hat - g_hat)                        # [P, N, A, W]
    y = 0.5 * dinv * (f_hat + g_hat)

    is_m0 = 1.0 if m_idx == 0 else 0.0
    two_minus_delta = 1.0 if m_idx == 0 else 2.0

    # --- particular-solution sources --------------------------------------
    wq = const(w)[None, :, None]

    def greens(qp, qm):
        # c_minus = +k <Q, [X; Y]>, c_plus = -k <Q, [Y; X]> (analytic -1/k
        # J-norms)
        proj_v = torch.sum(
            (qp * wq)[..., None, :] * x + (qm * wq)[..., None, :] * y, dim=-3
        )                                                   # [P, A, W]
        proj_u = torch.sum(
            (qp * wq)[..., None, :] * y + (qm * wq)[..., None, :] * x, dim=-3
        )
        return k * proj_v, -k * proj_u

    # each source: (c_minus, c_plus, amplitude [P, 1, W], decay rate in
    # optical depth [P, 1, W], kind). The solar beam, and at m = 0 the
    # thermal source b0 exp(-b1 tau) (isotropic, so it has no m > 0 part)
    cq = two_minus_delta * omega / (4.0 * math.pi)          # [P, W]
    qp = cq[:, None, :] * _contract_legendre(
        (parity * lam_sun)[:, None] * lam, beta
    )                                                       # [P, N, W]
    qm = cq[:, None, :] * _contract_legendre(lam_sun[:, None] * lam, beta)
    sources = [(*greens(qp, qm), (t_top * f0[None, :])[:, None, :],
                sbar[:, None, :], "beam")]
    thermal_m = thermal if (thermal is not None and m_idx == 0) else None
    if thermal_m is not None:
        b0, b1, _ = thermal_m
        q_th = (1.0 - omega)[:, None, :].expand(P, N, -1)   # [P, N, W]
        sources.append(
            (*greens(q_th, q_th), b0[:, None, :], b1[:, None, :], "thermal")
        )

    # --- particular boundary values ----------------------------------------
    d1 = dtau[:, None, :]
    phi_mb = 0.0
    phi_pt = 0.0
    for c_m, c_p, amp, decay, _ in sources:
        phi_mb = phi_mb + c_m * amp * ediff(decay, k, d1)
        phi_pt = phi_pt - c_p * amp * ediff(torch.zeros_like(k), k + decay, d1)

    def project(mat, vec):
        # [P, N, A, W] x [P, A, W] -> [P, N, W]
        return torch.sum(mat * vec[..., None, :, :], dim=-2)

    ip_plus_top = project(y, phi_pt)
    ip_minus_top = project(x, phi_pt)
    ip_plus_bot = project(x, phi_mb)
    ip_minus_bot = project(y, phi_mb)

    # --- BVP blocks ------------------------------------------------------
    e = torch.exp(-k * d1)                                  # [P, A, W]
    xe = x * e[:, None, :, :]
    ye = y * e[:, None, :, :]

    # Ground reflection operator: the Lambertian rank-one 2 a w_j mu_j at
    # m = 0, or the BRDF's azimuth moments 2 pi rho_m w_j mu_j. The BVP
    # drive is not gated by include_ss (beam -> ground -> rescatter is
    # multiple scatter); include_ss gates only the user-direction term.
    wmu = const(w * mu)
    ground_thermal = (
        (1.0 - albedo) * thermal_m[2] if thermal_m is not None else None
    )                                                       # [W]
    if surface_ops is None:
        ones_n = torch.ones((N, 1, 1), dtype=dt, device=dev)
        refl = (2.0 * is_m0 * albedo[None, None, :] * wmu[None, :, None]
                * ones_n)                                   # [N, N, W]
        ground_sun = is_m0 * albedo * mu0 * t_ground * f0 / math.pi  # [W]
        ground_direct = ground_sun if ground_thermal is None else (
            ground_sun + ground_thermal
        )
        ground_direct = ground_direct[None, :] * torch.ones(
            (N, 1), dtype=dt, device=dev
        )                                                   # [N, W]
    else:
        refl = 2.0 * math.pi * surface_ops["rho_stream"] * wmu[None, :, None]
        sun_in = (mu0 * t_ground * f0)[None, :]             # [1, W]
        ground_direct = two_minus_delta * surface_ops["rho_sun_stream"] * (
            sun_in
        )                                                   # [N, W]
        if ground_thermal is not None:
            ground_direct = ground_direct + ground_thermal[None, :]

    idx = torch.arange(P, device=dev)
    first_m = (idx == 0)[:, None, None, None]
    last_m = (idx == P - 1)[:, None, None, None]
    first_v = (idx == 0)[:, None, None]
    last_v = (idx == P - 1)[:, None, None]

    def two_by_two(tl, tr, bl, br):
        top = torch.cat([tl, tr], dim=-2)
        bot = torch.cat([bl, br], dim=-2)
        return torch.cat([top, bot], dim=-3)

    zero_n = torch.zeros_like(x)
    diag_tl = torch.where(first_m, y, -y)
    diag_tr = torch.where(first_m, xe, -xe)
    refl_b = refl[None]                                     # [1, N, N, W]
    grd_bl = xe - lane_mm(refl_b, ye)
    grd_br = y - lane_mm(refl_b, x)
    diag_bl = torch.where(last_m, grd_bl, xe)
    diag_br = torch.where(last_m, grd_br, y)
    diag_blocks = two_by_two(diag_tl, diag_tr, diag_bl, diag_br)

    xn = torch.roll(x, -1, dims=0)
    yen = torch.roll(ye, -1, dims=0)
    upper = two_by_two(zero_n, zero_n, -xn, -yen)
    xprev = torch.roll(x, 1, dims=0)
    yeprev = torch.roll(ye, 1, dims=0)
    lower = two_by_two(yeprev, xprev, zero_n, zero_n)

    rhs_top = torch.where(
        first_v, -ip_minus_top,
        ip_minus_top - torch.roll(ip_minus_bot, 1, dims=0),
    )
    rhs_ground = (
        ground_direct[None] - ip_plus_bot
        + torch.sum(refl_b * ip_minus_bot[..., None, :, :], dim=-2)
    )
    rhs_bot = torch.where(
        last_v, rhs_ground,
        torch.roll(ip_plus_top, -1, dims=0) - ip_plus_bot,
    )
    rhs = torch.cat([rhs_top, rhs_bot], dim=-2)            # [P, 2N, W]

    sol = lane_block_thomas_solve(lower, diag_blocks, upper, rhs)
    coeff_l = sol[..., :N, :]                               # [P, N(A), W]
    coeff_m = sol[..., N:, :]

    if with_levels:
        ea = e[:, None, :, :]
        levels = {
            "i_plus_top": project(x, coeff_l) + project(y * ea, coeff_m)
            + project(y, phi_pt),
            "i_minus_top": project(y, coeff_l) + project(x * ea, coeff_m)
            + project(x, phi_pt),
            "i_plus_bot": project(x * ea, coeff_l) + project(y, coeff_m)
            + project(x, phi_mb),
            "i_minus_bot": project(y * ea, coeff_l) + project(x, coeff_m)
            + project(y, phi_mb),
        }

    # --- post-processing -------------------------------------------------
    lamw = lam * const(w)[None, :]                          # [L, N]
    t1 = torch.einsum("lj,pjaw->plaw", lamw, x)
    t2 = torch.einsum("lj,pjaw->plaw", lamw, y)
    par = parity[None, :, None, None]
    tt_v = t1 + par * t2
    tt_u = t2 + par * t1
    half_om = 0.5 * omega[:, None, None, :]
    lupar = parity[:, None] * lam_user

    def user_proj(tab, tt):
        return half_om * torch.einsum("lu,lpw,plaw->puaw", tab, beta, tt)

    pv_up = user_proj(lam_user, tt_v)
    pu_up = user_proj(lam_user, tt_u)
    pv_dn = user_proj(lupar, tt_v)
    pu_dn = user_proj(lupar, tt_u)

    cu = (1.0 / const(user_mu))[None, :, None, None]        # [1, U, 1, 1]
    du = dtau[:, None, None, :]                             # [P, 1, 1, W]
    ku = k[:, None, :, :]                                   # [P, 1, A, W]
    zero = torch.zeros_like(ku)

    efwd_k = ediff(zero, ku + cu, du) * cu
    erev_k = ediff(ku, cu + zero, du) * cu

    lu_c = coeff_l[:, None, :, :]
    mu_c = coeff_m[:, None, :, :]
    s_up = torch.sum(pv_up * lu_c * efwd_k + pu_up * mu_c * erev_k, dim=-2)
    s_dn = torch.sum(pv_dn * lu_c * erev_k + pu_dn * mu_c * efwd_k, dim=-2)

    for c_m, c_p, amp, decay, kind in sources:
        sbu = decay[:, None, :, :]                          # [P, 1, 1, W]
        ampu = amp[:, None, :, :]
        zero_s = torch.zeros_like(sbu)
        efwd_s = ediff(zero_s, sbu + cu, du) * cu
        erev_s = ediff(sbu, cu + zero_s, du) * cu
        green_minus_up = ddiff2(zero, sbu + cu, ku + cu, du) * cu
        green_plus_up = (
            efwd_s - ediff(ku + sbu, sbu + cu, du) * cu
        ) / (ku + sbu)
        green_minus_dn = ddiff2(ku, cu + zero, sbu + zero, du) * cu
        green_plus_dn = (
            erev_s - ediff(sbu, ku + sbu + cu, du) * cu
        ) / (ku + sbu)

        cmu = c_m[:, None, :, :]
        cpu = c_p[:, None, :, :]
        s_up = s_up + torch.sum(
            pv_up * cmu * ampu * green_minus_up
            - pu_up * cpu * ampu * green_plus_up,
            dim=-2,
        )
        s_dn = s_dn + torch.sum(
            pv_dn * cmu * ampu * green_minus_dn
            - pu_dn * cpu * ampu * green_plus_dn,
            dim=-2,
        )
        if kind == "beam":
            if include_ss:
                cbeam = two_minus_delta * omega[:, None, :] / (4.0 * math.pi)
                beam_up = cbeam * _contract_legendre(
                    lam_user * (parity * lam_sun)[:, None], beta
                )                                           # [P, U, W]
                beam_dn = cbeam * _contract_legendre(
                    lam_sun[:, None] * lam_user, beta
                )
                s_up = s_up + beam_up * ampu[..., 0, :] * efwd_s[..., 0, :]
                s_dn = s_dn + beam_dn * ampu[..., 0, :] * erev_s[..., 0, :]
        else:
            # the thermal source's own emission, isotropic
            direct = (1.0 - omega)[:, None, :] * ampu[..., 0, :]
            s_up = s_up + direct * efwd_s[..., 0, :]
            s_dn = s_dn + direct * erev_s[..., 0, :]

    # attenuate + sum layers
    od_user = dtau[:, None, :] * cu[0, :, :, 0][None]      # [P, U, W]
    cum_above = torch.cumsum(od_user, dim=0) - od_user
    cum_below = (
        torch.flip(torch.cumsum(torch.flip(od_user, (0,)), dim=0), (0,))
        - od_user
    )
    rad_up = torch.sum(torch.exp(-cum_above) * s_up, dim=0)  # [U, W]
    rad_dn = torch.sum(torch.exp(-cum_below) * s_dn, dim=0)

    # ground reflection of the downwelling diffuse field
    i_minus_ground = (
        torch.sum(ye[P - 1] * coeff_l[P - 1][None], dim=-2)
        + torch.sum(x[P - 1] * coeff_m[P - 1][None], dim=-2)
        + torch.sum(y[P - 1] * phi_mb[P - 1][None], dim=-2)
    )                                                       # [N, W]
    if surface_ops is None:
        refl_sum = 2.0 * is_m0 * albedo * torch.sum(
            wmu[:, None] * i_minus_ground, dim=0
        )                                                   # [W]
        ground_up = refl_sum[None, :] * torch.ones(
            (len(user_mu), 1), dtype=dt, device=dev
        )
        if include_ss:
            ground_up = ground_up + ground_sun[None, :]
    else:
        ground_up = 2.0 * math.pi * torch.einsum(
            "ujw,j,jw->uw", surface_ops["rho_user"], wmu, i_minus_ground
        )
        if include_ss:
            ground_up = ground_up + (
                two_minus_delta * surface_ops["rho_sun_user"] * sun_in
            )
    if ground_thermal is not None:
        ground_up = ground_up + ground_thermal[None, :]
    total_od_user = torch.sum(od_user, dim=0)
    rad_up = rad_up + torch.exp(-total_od_user) * ground_up
    rad = torch.where(user_up[:, None], rad_up, rad_dn)
    if with_levels:
        return rad, levels
    return rad


def solve_nstream(
    dtau,
    omega,
    beta,
    albedo,
    tables: ModeTables,
    user_up,
    user_azimuth,
    include_ss: bool = True,
    chapman=None,
    num_azimuth: int | None = None,
    f0=None,
    thermal_b0=None,
    thermal_b1_bottom=None,
    surface_emission=None,
    brdf=None,
    brdf_args=None,
    return_internal: bool = False,
):
    """N-stream plane-parallel DO radiance, wavelength-minor.

    dtau/omega [P, W] (TOA first); beta [L, P, W]; albedo [W]; ``tables``
    from ``rt.disco.build_mode_tables``; ``chapman`` an optional [P, P]
    pseudo-spherical chapman matrix. ``thermal_b0`` / ``thermal_b1_bottom``
    [P, W] are the Planck source at each layer's top and bottom and
    ``surface_emission`` [W] the ground's (thermal emission, m = 0 only).
    ``brdf`` (a kernel of ``rt.brdf``) with ``brdf_args`` [W, nargs]
    replaces the Lambertian ground by that BRDF's azimuth moments
    (``disco.brdf_azimuth_moments``). Returns radiance [U, W]; with
    ``return_internal`` also the dict that ``rt.do_source`` evaluates
    along rays: the level fields (``levels``, each [M, P, N, W]), the
    mode tables that were used, the clamped omega, beta, the beam's
    t_top and sbar, dtau, the quadrature weights, f0 and the thermal
    layer fit (None without thermal sources).

    The azimuth modes run as a Python loop; under autograd each mode is
    checkpointed, so backward recomputes one mode at a time instead of
    holding every mode's [P, 2N, 2N, W] BVP blocks.
    """
    dt = dtau.dtype
    dev = dtau.device

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    mu0 = tables.mu0
    mu = np.asarray(tables.mu)
    w = np.asarray(tables.w)
    t_top, t_ground, sbar = beam_attenuation(dtau, mu0, chapman)

    M = tables.lam_stream.shape[0]
    if num_azimuth is not None:
        M = min(M, num_azimuth)
    nstr = 2 * len(mu)
    luse = min(beta.shape[0], max(nstr, 1))
    beta = beta[:luse]

    user_mu = np.asarray(tables.user_mu)
    user_up_t = torch.as_tensor(np.asarray(user_up, dtype=bool), device=dev)
    user_azimuth = torch.as_tensor(
        np.asarray(user_azimuth), dtype=dt, device=dev
    )
    if f0 is None:
        f0 = torch.ones(albedo.shape, dtype=dt, device=dev)
    else:
        f0 = torch.as_tensor(f0, dtype=dt, device=dev).broadcast_to(
            albedo.shape
        )

    thermal = None
    if thermal_b0 is not None or thermal_b1_bottom is not None:
        thermal = thermal_layer_fit(thermal_b0, thermal_b1_bottom, dtau,
                                    surface_emission, albedo)
    surface_ops = None
    if brdf is not None:
        mom = brdf_azimuth_moments(
            brdf, brdf_args, const(mu), const(user_mu), mu0, np.arange(M),
        )
        # [M, W, ...] -> the lane layout [M, ..., W]
        surface_ops = {k: v.movedim(1, -1) for k, v in mom.items()}

    U = len(user_mu)
    W = dtau.shape[-1]
    rad = torch.zeros((U, W), dtype=dt, device=dev)
    levels = []
    for m in range(M):
        args = (
            m,
            const(tables.lam_stream[m, :luse]),
            const(tables.lam_sun[m, :luse]),
            const(tables.lam_user[m, :luse]),
            const(tables.parity[m, :luse]),
            dtau, omega, beta, t_top, sbar, t_ground,
            albedo, mu, w, mu0, user_mu, user_up_t, include_ss, f0,
            thermal, return_internal,
            None if surface_ops is None else {
                k: v[m] for k, v in surface_ops.items()
            },
        )
        if torch.is_grad_enabled():
            r_m = checkpoint(_mode_radiance, *args, use_reentrant=False)
        else:
            r_m = _mode_radiance(*args)
        if return_internal:
            r_m, lv = r_m
            levels.append(lv)
        az = torch.cos(m * (math.pi - user_azimuth))[:, None]
        rad = rad + az * r_m
    if not return_internal:
        return rad
    internal = {
        "levels": {
            k: torch.stack([lv[k] for lv in levels]) for k in levels[0]
        },
        "lam": np.asarray(tables.lam_stream[:M, :luse]),
        "lam_sun": np.asarray(tables.lam_sun[:M, :luse]),
        "parity": np.asarray(tables.parity[:M, :luse]),
        "omega": clamp_ssa(omega),
        "beta": beta,
        "t_top": t_top,
        "sbar": sbar,
        "dtau": dtau,
        "w_quad": w,
        "f0": f0,
        "thermal": thermal,
    }
    return rad, internal


def solve_nstream_m0_levels(
    dtau,
    omega,
    beta,
    albedo,
    tables: ModeTables,
    include_ss: bool = True,
    chapman=None,
    f0=None,
    thermal_b0=None,
    thermal_b1_bottom=None,
    surface_emission=None,
):
    """The m = 0 solve's level stream fields, wavelength-minor
    (``sasktran2_tpu/rt/disco_nstream.py:540``): everything the flux
    assembly needs.

    Same inputs as ``solve_nstream``. Returns (levels, t_top, t_ground):
    levels a dict of [P, N, W] stream fields at the layer tops and bottoms,
    t_top [P, W] and t_ground [W] the direct beam's transmission. Unlike
    ``solve_nstream``'s modes, this one is not checkpointed: every flux
    output of an engine call depends on it, and each output's Jacobian
    row would recompute it.
    """
    dt = dtau.dtype
    dev = dtau.device

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    mu0 = tables.mu0
    mu = np.asarray(tables.mu)
    w = np.asarray(tables.w)
    t_top, t_ground, sbar = beam_attenuation(dtau, mu0, chapman)
    nstr = 2 * len(mu)
    luse = min(beta.shape[0], max(nstr, 1))
    beta = beta[:luse]
    if f0 is None:
        f0 = torch.ones(albedo.shape, dtype=dt, device=dev)
    else:
        f0 = torch.as_tensor(f0, dtype=dt, device=dev).broadcast_to(
            albedo.shape
        )
    thermal = None
    if thermal_b0 is not None or thermal_b1_bottom is not None:
        thermal = thermal_layer_fit(thermal_b0, thermal_b1_bottom, dtau,
                                    surface_emission, albedo)
    user_mu = np.asarray(tables.user_mu)
    user_up = torch.ones(len(user_mu), dtype=torch.bool, device=dev)
    args = (
        0,
        const(tables.lam_stream[0, :luse]),
        const(tables.lam_sun[0, :luse]),
        const(tables.lam_user[0, :luse]),
        const(tables.parity[0, :luse]),
        dtau, omega, beta, t_top, sbar, t_ground,
        albedo, mu, w, mu0, user_mu, user_up, include_ss, f0, thermal,
        True,
    )
    _, levels = _mode_radiance(*args)
    return levels, t_top, t_ground
