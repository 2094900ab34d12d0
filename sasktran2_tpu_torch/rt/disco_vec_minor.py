"""Wavelength-minor polarized (I, Q, U) discrete-ordinates solver
(counterpart of ``sasktran2_tpu/rt/disco_vec_minor.py``).

Same physics and layout as the reference: the sign-transform reduction of
the vector system to the scalar symmetric machinery (``rt/disco_vec.py``),
with every array carrying the wavelength axis last and the solver state
flattened into (stream x stokes) blocks of size K = 3N. Each
greek-coefficient contraction uses four static host tables, one per greek
(a1, a2, a3, b1), built by ``build_vector_minor_tables``.

The eigensolve runs at n = K (the Jacobi kernel at n = 24 for 16 streams,
n = 6 for 4 streams) and the boundary-value problem at 2K on the Thomas
kernel: unpivoted at 2K <= 24 (4 streams: K = 12), and at 16 streams the
48 x 48 blocks with partial pivoting, as the reference's scan solves them
(``ops/lanes.py`` holds that dispatch).

Scope: solar beam source and a Lambertian surface, as the reference's
fast path. Shapes: dtau/omega [P, W]; a1/a2/a3/b1 [L, P, W]; albedo/f0
[W]; radiance [U, 3, W].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..ops.lanes import (
    lane_block_thomas_solve,
    lane_cholesky,
    lane_jacobi_eigh_scan,
    lane_mm,
    lane_solve_upper,
    lane_t,
)
from ..ops.linalg import ddiff2, ediff
from ..ops.quadrature import streams
from ..ops.wigner import wigner_d
from .disco import KMIN, beam_attenuation, clamp_ssa
from .disco_vec import DSIGN, NS, _pi_matrices

__all__ = ["build_vector_minor_tables", "solve_nstream_vector"]


@dataclass(frozen=True)
class VectorMinorTables:
    """Static per-azimuth-mode tables for the wavelength-minor polarized
    solver. G = 4 greeks ordered (a1, a2, a3, b1); K = 3N; KU = 3U.

    kernel_a / kernel_b : [M, G, L, K, K] symmetrization kernels
    q_plus / q_minus    : [M, G2, L, K]   beam source tables (G2 = a1, b1)
    stream_sum          : [M, L, 3, K]    S[l, c, (j s)] = w_j Pi_j[s, c]
    par_d               : [M, L, 3]       nu_l * dsign[c]
    user_up / user_dn   : [M, G, L, U, 3, 3]  user projection tables
    beam_user_up / _dn  : [M, G2, L, U, 3]    direct-beam user tables
    mu, w               : [N] stream cosines / weights
    mu0                 : float
    user_mu             : [U]
    """

    kernel_a: np.ndarray
    kernel_b: np.ndarray
    q_plus: np.ndarray
    q_minus: np.ndarray
    stream_sum: np.ndarray
    par_d: np.ndarray
    user_up: np.ndarray
    user_dn: np.ndarray
    beam_user_up: np.ndarray
    beam_user_dn: np.ndarray
    mu: np.ndarray
    w: np.ndarray
    mu0: float
    user_mu: np.ndarray


def build_vector_minor_tables(
    nstr: int,
    nlegendre: int,
    mu0: float,
    user_mu: np.ndarray,
    num_azimuth: int | None = None,
) -> VectorMinorTables:
    """Fold the generalized-spherical-function algebra into static
    per-greek tables (host-side, numpy)."""
    if num_azimuth is None:
        num_azimuth = nstr
    M = num_azimuth
    mu, w = streams(nstr)
    N = len(mu)
    K = N * NS
    L = max(nlegendre, 1)
    user_mu = np.asarray(user_mu, dtype=np.float64)
    U = len(user_mu)
    theta0 = np.arccos(np.clip(mu0, -1.0, 1.0))
    ls = np.arange(L)

    kernel_a = np.zeros((M, 4, L, K, K))
    kernel_b = np.zeros((M, 4, L, K, K))
    q_plus = np.zeros((M, 2, L, K))
    q_minus = np.zeros((M, 2, L, K))
    stream_sum = np.zeros((M, L, NS, K))
    par_d = np.zeros((M, L, NS))
    user_up = np.zeros((M, 4, L, U, NS, NS))
    user_dn = np.zeros((M, 4, L, U, NS, NS))
    beam_user_up = np.zeros((M, 2, L, U, NS))
    beam_user_dn = np.zeros((M, 2, L, U, NS))

    # B_l decomposition patterns: greek -> [(row a, col b, sign)]
    patterns = {
        0: [(0, 0, 1.0)],           # a1
        1: [(1, 1, 1.0)],           # a2
        2: [(2, 2, 1.0)],           # a3
        3: [(0, 1, -1.0), (1, 0, -1.0)],  # b1
    }

    for m in range(M):
        pi = _pi_matrices(mu, m, L)        # [L, N, 3, 3]
        pi_user = _pi_matrices(user_mu, m, L)  # [L, U, 3, 3]
        d0_sun = wigner_d(np.array(theta0), m, 0, L)
        parity = (-1.0) ** (ls + m)        # [L]

        # G diagonals: gminus (C^A kernel), gplus (C^B kernel)
        gplus = np.stack(
            [1.0 + parity, 1.0 + parity, 1.0 - parity], axis=-1
        )  # [L, 3]
        gminus = np.stack(
            [1.0 - parity, 1.0 - parity, 1.0 + parity], axis=-1
        )

        # pi flattened over (stream, stokes) -> [L, K, 3(col)]
        pif = pi.reshape(L, K, NS)
        pif_user = pi_user  # [L, U, 3, 3]

        for g, pat in patterns.items():
            for a, b, sgn in pat:
                # kernel_X[l, (is), (jt)] += 0.5 sgn G_X[l, b]
                #   pi[l,(is),a] pi[l,(jt),b]
                outer = pif[:, :, a][:, :, None] * pif[:, :, b][:, None, :]
                kernel_a[m, g] += 0.5 * sgn * gminus[:, b, None, None] * outer
                kernel_b[m, g] += 0.5 * sgn * gplus[:, b, None, None] * outer
                # user tables: U_X[l, u, s, b] += sgn pi_user[l,u,s,a]
                # (up: plain; down: nu_l dsign[a] pi_user[l,u,s,a])
                user_up[m, g, :, :, :, b] += sgn * pif_user[..., a]
                user_dn[m, g, :, :, :, b] += (
                    sgn * DSIGN[a] * parity[:, None, None]
                    * pif_user[..., a]
                )

        # beam source tables: (B_l e1) = (a1, -b1, 0)
        # Q~+ = c sum_l nu_l d0_l (Pi B)e1 ; Q~- without nu
        q_plus[m, 0] = (parity * d0_sun)[:, None] * pif[:, :, 0]
        q_plus[m, 1] = -(parity * d0_sun)[:, None] * pif[:, :, 1]
        q_minus[m, 0] = d0_sun[:, None] * pif[:, :, 0]
        q_minus[m, 1] = -d0_sun[:, None] * pif[:, :, 1]

        # user beam tables (dsign only touches the U row, which (B e1)
        # never populates, so up/dn differ only in the nu_l factor)
        beam_user_up[m, 0] = (parity * d0_sun)[:, None, None] * pif_user[..., 0]
        beam_user_up[m, 1] = -(parity * d0_sun)[:, None, None] * pif_user[..., 1]
        beam_user_dn[m, 0] = d0_sun[:, None, None] * pif_user[..., 0]
        beam_user_dn[m, 1] = -d0_sun[:, None, None] * pif_user[..., 1]

        # stream sums: S[l, c, (j s)] = w_j pi[l, j, s, c]
        stream_sum[m] = np.einsum(
            "ljsc,j->lcjs", pi, w
        ).reshape(L, NS, K)
        par_d[m] = parity[:, None] * DSIGN[None, :]

    return VectorMinorTables(
        kernel_a=kernel_a,
        kernel_b=kernel_b,
        q_plus=q_plus,
        q_minus=q_minus,
        stream_sum=stream_sum,
        par_d=par_d,
        user_up=user_up,
        user_dn=user_dn,
        beam_user_up=beam_user_up,
        beam_user_dn=beam_user_dn,
        mu=mu,
        w=w,
        mu0=float(mu0),
        user_mu=user_mu,
    )


def _mode_radiance_vec(
    m_idx, tab,
    dtau, omega, greeks, t_top, sbar, t_ground,
    albedo, mu, w, mu0, user_mu, user_up, include_ss, f0,
    with_levels=False,
):
    """One azimuth mode, wavelength-minor polarized
    (``disco_vec_minor.py:195``). ``m_idx`` is the mode number, ``tab`` the
    mode's slice of the static tables (tensors) and ``greeks`` [4, L, P,
    W]. Returns radiance [U, 3, W] in the transformed frame (the caller's
    azimuth synthesis untransforms U of downwelling outputs), and with
    ``with_levels`` also the level stream fields, a dict of [P, K, W]."""
    dt = dtau.dtype
    dev = dtau.device

    def const(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    N = len(mu)
    K = N * NS
    P = dtau.shape[0]
    W = dtau.shape[-1]
    omega = clamp_ssa(omega)

    (kern_a, kern_b, qp_tab, qm_tab, s_tab, par_d,
     uu_tab, ud_tab, bu_tab, bd_tab) = tab

    G, L = greeks.shape[0], greeks.shape[1]
    greeks_f = greeks.reshape(G * L, P, W)

    # --- symmetrized layer matrices ----------------------------------------
    ca = torch.einsum("lij,lpw->pijw", kern_a.reshape(G * L, K, K), greeks_f)
    cb = torch.einsum("lij,lpw->pijw", kern_b.reshape(G * L, K, K), greeks_f)
    mu_f = np.repeat(mu, NS)
    w_f = np.repeat(w, NS)
    s = np.sqrt(w_f / mu_f)
    scale = const(s[:, None] * s[None, :])[None, :, :, None]
    diag = const(np.diag(1.0 / mu_f))[None, :, :, None]
    om = omega[:, None, None, :]
    a_hat = diag - om * ca * scale
    b_hat = diag - om * cb * scale

    # --- eigensolve (the Jacobi kernel at n = K) ---------------------------
    chol = lane_cholesky(b_hat)
    m_sym = lane_mm(lane_mm(lane_t(chol), a_hat), chol)
    m_sym = 0.5 * (m_sym + lane_t(m_sym))
    k2, v = lane_jacobi_eigh_scan(m_sym)
    k = torch.sqrt(torch.clamp(k2, min=KMIN * KMIN))       # [P, A, W]
    f_hat = lane_solve_upper(lane_t(chol), v)
    g_hat = lane_mm(chol, v) / k[..., None, :, :]
    dinv = const(1.0 / np.sqrt(w_f * mu_f))[None, :, None, None]
    x = 0.5 * dinv * (f_hat - g_hat)                        # [P, K, A, W]
    y = 0.5 * dinv * (f_hat + g_hat)

    is_m0 = 1.0 if m_idx == 0 else 0.0
    two_minus_delta = 1.0 if m_idx == 0 else 2.0

    # --- beam source vectors -----------------------------------------------
    greeks2 = greeks[[0, 3]].reshape(2 * L, P, W)          # a1, b1 rows
    cq = two_minus_delta * omega / (4.0 * math.pi)          # [P, W]
    qp = cq[:, None, :] * torch.einsum(
        "lk,lpw->pkw", qp_tab.reshape(2 * L, K), greeks2
    )
    qm = cq[:, None, :] * torch.einsum(
        "lk,lpw->pkw", qm_tab.reshape(2 * L, K), greeks2
    )
    wq = const(w_f)[None, :, None]

    # c_minus = +k <Q, [X; Y]>, c_plus = -k <Q, [Y; X]>
    proj_v = torch.sum(
        (qp * wq)[..., None, :] * x + (qm * wq)[..., None, :] * y, dim=-3
    )                                                       # [P, A, W]
    proj_u = torch.sum(
        (qp * wq)[..., None, :] * y + (qm * wq)[..., None, :] * x, dim=-3
    )
    c_minus = k * proj_v
    c_plus = -k * proj_u
    amp_beam = (t_top * f0[None, :])[:, None, :]           # [P, 1, W]
    sb = sbar[:, None, :]

    # --- particular boundary values -----------------------------------------
    d1 = dtau[:, None, :]
    phi_mb = c_minus * amp_beam * ediff(sb, k, d1)
    phi_pt = -c_plus * amp_beam * ediff(torch.zeros_like(k), k + sb, d1)

    def project(mat, vec):
        # [P, K, A, W] x [P, A, W] -> [P, K, W]
        return torch.sum(mat * vec[..., None, :, :], dim=-2)

    ip_plus_top = project(y, phi_pt)
    ip_minus_top = project(x, phi_pt)
    ip_plus_bot = project(x, phi_mb)
    ip_minus_bot = project(y, phi_mb)

    # --- BVP blocks (2K x 2K) ------------------------------------------------
    e = torch.exp(-k * d1)                                  # [P, A, W]
    xe = x * e[:, None, :, :]
    ye = y * e[:, None, :, :]

    # Lambertian ground reflects I only: refl[(is),(jt),w] =
    # 2 a delta_{s0} delta_{t0} w_j mu_j
    e1mask = np.zeros(K)
    e1mask[0::NS] = 1.0
    wmu_i = np.zeros(K)
    wmu_i[0::NS] = w * mu
    refl = (
        2.0 * is_m0 * albedo[None, None, :]
        * const(e1mask[:, None] * wmu_i[None, :])[:, :, None]
    )                                                       # [K, K, W]
    ground_sun = is_m0 * albedo * mu0 * t_ground * f0 / math.pi  # [W]
    ground_direct = ground_sun[None, :] * const(e1mask[:, None])  # [K, W]

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
    refl_b = refl[None]                                     # [1, K, K, W]
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
    rhs = torch.cat([rhs_top, rhs_bot], dim=-2)            # [P, 2K, W]

    sol = lane_block_thomas_solve(lower, diag_blocks, upper, rhs)
    coeff_l = sol[..., :K, :]                               # [P, K(A), W]
    coeff_m = sol[..., K:, :]

    if with_levels:
        # level stream fields at layer tops/bottoms (transformed frame,
        # flattened K), for the limb ray-source evaluation
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

    # --- post-processing ------------------------------------------------------
    # stream sums: t1[p, l, c, a, w] = sum_k S[l, c, k] X[p, k, a, w]
    t1 = torch.einsum("lck,pkaw->plcaw", s_tab, x)
    t2 = torch.einsum("lck,pkaw->plcaw", s_tab, y)
    pd = par_d[:, :, None, None]                            # [L, 3, 1, 1]
    g_v = t1 + pd * t2
    g_u = t2 + pd * t1

    # user projections: sum over greeks g, moments l and Pi columns b of
    # tab[g, l, u, s, b] greek[g, l, p, w] g[p, l, b, a, w], for the
    # (up, down) tables and the (g_v, g_u) sums at once; the greek sum is
    # taken first, so no [P, G*L, ...] tile of g is formed
    half_om = 0.5 * omega[:, None, None, None, :]
    tabs = torch.stack([uu_tab, ud_tab])                    # [2, G, L, U, 3, 3]
    tg = torch.einsum("dglusb,glpw->pwldusb", tabs, greeks)
    gg = torch.stack([g_v, g_u])                            # [2, P, L, 3, A, W]
    proj = torch.einsum("pwldusb,eplbaw->depusaw", tg, gg)
    pv_up = half_om * proj[0, 0]                            # [P, U, 3, A, W]
    pu_up = half_om * proj[0, 1]
    pv_dn = half_om * proj[1, 0]
    pu_dn = half_om * proj[1, 1]

    # direct beam into user directions: [P, U, 3, W]
    cbeam = (two_minus_delta * omega / (4.0 * math.pi))[:, None, None, :]
    bu = bu_tab.reshape(2 * L, *bu_tab.shape[2:])           # [2L, U, 3]
    bd = bd_tab.reshape(2 * L, *bd_tab.shape[2:])
    beam_up = cbeam * torch.einsum("lus,lpw->pusw", bu, greeks2)
    beam_dn = cbeam * torch.einsum("lus,lpw->pusw", bd, greeks2)

    # --- layer source integrals (scalar multipliers per mode a) -------------
    cu = (1.0 / const(user_mu))[None, :, None, None]        # [1, U, 1, 1]
    du = dtau[:, None, None, :]                             # [P, 1, 1, W]
    ku = k[:, None, :, :]                                   # [P, 1, A, W]
    zero = torch.zeros_like(ku)

    efwd_k = ediff(zero, ku + cu, du) * cu
    erev_k = ediff(ku, cu + zero, du) * cu

    lu_c = coeff_l[:, None, :, :]                           # [P, 1, A, W]
    mu_c = coeff_m[:, None, :, :]
    s_up = torch.sum(
        pv_up * (lu_c * efwd_k)[:, :, None]
        + pu_up * (mu_c * erev_k)[:, :, None],
        dim=-2,
    )                                                       # [P, U, 3, W]
    s_dn = torch.sum(
        pv_dn * (lu_c * erev_k)[:, :, None]
        + pu_dn * (mu_c * efwd_k)[:, :, None],
        dim=-2,
    )

    sbu = sb[:, None, :, :]                                 # [P, 1, 1, W]
    ampu = amp_beam[:, None, :, :]
    zero_s = torch.zeros_like(sbu)
    efwd_s = ediff(zero_s, sbu + cu, du) * cu
    erev_s = ediff(sbu, cu + zero_s, du) * cu
    green_minus_up = ddiff2(zero, sbu + cu, ku + cu, du) * cu
    green_plus_up = (efwd_s - ediff(ku + sbu, sbu + cu, du) * cu) / (ku + sbu)
    green_minus_dn = ddiff2(ku, cu + zero, sbu + zero, du) * cu
    green_plus_dn = (
        erev_s - ediff(sbu, ku + sbu + cu, du) * cu
    ) / (ku + sbu)

    cmu = c_minus[:, None, :, :]
    cpu = c_plus[:, None, :, :]
    s_up = s_up + torch.sum(
        pv_up * (cmu * ampu * green_minus_up)[:, :, None]
        - pu_up * (cpu * ampu * green_plus_up)[:, :, None],
        dim=-2,
    )
    s_dn = s_dn + torch.sum(
        pv_dn * (cmu * ampu * green_minus_dn)[:, :, None]
        - pu_dn * (cpu * ampu * green_plus_dn)[:, :, None],
        dim=-2,
    )
    if include_ss:
        s_up = s_up + beam_up * (ampu * efwd_s)[..., 0, :][:, :, None]
        s_dn = s_dn + beam_dn * (ampu * erev_s)[..., 0, :][:, :, None]

    # attenuate + sum layers
    od_user = dtau[:, None, :] * cu[0, :, :, 0][None]      # [P, U, W]
    cum_above = torch.cumsum(od_user, dim=0) - od_user
    cum_below = (
        torch.flip(torch.cumsum(torch.flip(od_user, (0,)), dim=0), (0,))
        - od_user
    )
    rad_up = torch.sum(torch.exp(-cum_above)[:, :, None] * s_up, dim=0)
    rad_dn = torch.sum(torch.exp(-cum_below)[:, :, None] * s_dn, dim=0)
    # [U, 3, W]

    # ground reflection of the downwelling diffuse field (I only)
    i_minus_ground = (
        torch.sum(ye[P - 1] * coeff_l[P - 1][None], dim=-2)
        + torch.sum(x[P - 1] * coeff_m[P - 1][None], dim=-2)
        + torch.sum(y[P - 1] * phi_mb[P - 1][None], dim=-2)
    )                                                       # [K, W]
    i_minus_i = i_minus_ground[0::NS]                       # [N, W]
    wmu = const(w * mu)
    refl_sum = 2.0 * is_m0 * albedo * torch.sum(
        wmu[:, None] * i_minus_i, dim=0
    )                                                       # [W]
    ground_up_i = refl_sum + ground_sun if include_ss else refl_sum
    total_od_user = torch.sum(od_user, dim=0)               # [U, W]
    ground_i = torch.exp(-total_od_user) * ground_up_i[None, :]
    zeros_qu = torch.zeros_like(ground_i)
    rad_up = rad_up + torch.stack([ground_i, zeros_qu, zeros_qu], dim=1)

    # rad_dn stays in the transformed frame; the caller's azimuth
    # synthesis carries the D untransform (the sign of U's sine weight)
    rad = torch.where(user_up[:, None, None], rad_up, rad_dn)
    if with_levels:
        return rad, levels
    return rad


_replayed_mode_vec = spans.replayed_mode(_mode_radiance_vec)


def solve_nstream_vector(
    dtau,
    omega,
    a1, a2, a3, b1,
    albedo,
    tables: VectorMinorTables,
    user_up,
    user_azimuth,
    include_ss: bool = True,
    chapman=None,
    num_azimuth: int | None = None,
    f0=None,
    return_internal: bool = False,
):
    """Polarized N-stream plane-parallel DO radiance, wavelength-minor
    (``sasktran2_tpu/rt/disco_vec_minor.py:512``).

    dtau/omega [P, W] (TOA first); a1/a2/a3/b1 [L, P, W]; albedo [W];
    ``chapman`` an optional [P, P] pseudo-spherical chapman matrix.
    Returns radiance [U, 3, W] (I, Q, U), sun-normalized unless ``f0`` is
    given. With ``return_internal`` also the dict that
    ``rt.do_source.ms_source_along_rays_vec_minor`` evaluates along rays:
    the level fields (``levels``, each [M, P, K, W]), the clamped omega,
    the greeks [4, L, P, W], the beam's t_top and sbar, dtau, the sun's
    d^l_{m0} and the parities [M, L], the stream-sum tables and f0.

    The azimuth modes run as a Python loop; under autograd each mode is
    checkpointed, so backward recomputes one mode at a time instead of
    holding every mode's [P, 2K, 2K, W] BVP blocks.
    """
    dt = dtau.dtype
    dev = dtau.device

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    mu0 = tables.mu0
    mu = np.asarray(tables.mu)
    w = np.asarray(tables.w)
    t_top, t_ground, sbar = beam_attenuation(dtau, mu0, chapman)

    M = tables.kernel_a.shape[0]
    if num_azimuth is not None:
        M = min(M, num_azimuth)
    nstr = 2 * len(mu)
    luse = min(a1.shape[0], tables.kernel_a.shape[2], max(nstr, 1))
    greeks = torch.stack([v[:luse] for v in (a1, a2, a3, b1)], dim=0).to(dt)

    user_mu = np.asarray(tables.user_mu)
    user_up_np = np.asarray(user_up, dtype=bool)
    user_up_t = torch.as_tensor(user_up_np, device=dev)
    user_azimuth = torch.as_tensor(
        np.asarray(user_azimuth), dtype=dt, device=dev
    )
    if f0 is None:
        f0 = torch.ones(albedo.shape, dtype=dt, device=dev)
    else:
        f0 = torch.as_tensor(f0, dtype=dt, device=dev).broadcast_to(
            albedo.shape
        )

    # azimuth synthesis: (I, Q) ~ cos m dphi; U ~ sin m dphi, with the
    # downwelling D-untransform folded into the sign of the U weight
    dphi = math.pi - user_azimuth                            # [U]
    dsign_dn = const(np.where(user_up_np, 1.0, -1.0))

    U = len(user_mu)
    W = dtau.shape[-1]
    rad = torch.zeros((U, NS, W), dtype=dt, device=dev)
    levels = []
    for m in range(M):
        with spans.span("do_mode", mode=m, recompute=0) as span:
            tab = tuple(
                const(t)
                for t in (
                    tables.kernel_a[m, :, :luse],
                    tables.kernel_b[m, :, :luse],
                    tables.q_plus[m, :, :luse],
                    tables.q_minus[m, :, :luse],
                    tables.stream_sum[m, :luse],
                    tables.par_d[m, :luse],
                    tables.user_up[m, :, :luse],
                    tables.user_dn[m, :, :luse],
                    tables.beam_user_up[m, :, :luse],
                    tables.beam_user_dn[m, :, :luse],
                )
            )
            if span:
                span.count(table_bytes=spans.nbytes(tab))
            args = (
                m, tab,
                dtau, omega, greeks, t_top, sbar, t_ground,
                albedo, mu, w, mu0, user_mu, user_up_t, include_ss, f0,
                return_internal,
            )
            if torch.is_grad_enabled():
                r_m = checkpoint(_replayed_mode_vec, *args,
                                 use_reentrant=False)
            else:
                r_m = _mode_radiance_vec(*args)
        if return_internal:
            r_m, lv = r_m
            levels.append(lv)
        cosm = torch.cos(m * dphi)[:, None]
        sinm = torch.sin(m * dphi)[:, None]
        az = torch.stack([cosm, cosm, sinm * dsign_dn[:, None]], dim=1)
        rad = rad + az * r_m                                 # [U, 3, W]
    if not return_internal:
        return rad
    theta0 = np.arccos(np.clip(mu0, -1.0, 1.0))
    ls = np.arange(luse)
    internal = {
        "levels": {
            k: torch.stack([lv[k] for lv in levels]) for k in levels[0]
        },
        "omega": clamp_ssa(omega),
        "greeks": greeks,                                    # [4, L, P, W]
        "t_top": t_top,
        "sbar": sbar,
        "dtau": dtau,
        "d0_sun": np.stack([
            wigner_d(np.array(theta0), m, 0, luse) for m in range(M)
        ]),                                                  # [M, L]
        "parity": np.stack([(-1.0) ** (ls + m) for m in range(M)]),
        "stream_sum": np.asarray(tables.stream_sum[:M, :luse]),
        "par_d": np.asarray(tables.par_d[:M, :luse]),
        "mu0": mu0,
        "f0": f0,
    }
    return rad, internal
