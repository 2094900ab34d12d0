"""Wavelength-minor two-stream discrete-ordinates solver (counterpart of
``sasktran2_tpu/rt/twostream.py``).

The nstr = 2 case of the plane-parallel DO problem: closed-form
homogeneous solutions (no eigensolver) and a pivot-free 2x2 block-Thomas
sweep over the layers for the boundary-value problem. Same physics as the
N-stream solver (same mode tables, Green's-function particular solution,
post-processing multipliers) at one quadrature point per hemisphere,
scalar radiance, Lambertian surface, the solar beam and the thermal
source.

The layer sweeps (``lax.scan`` in the reference) are Python loops over
[W] tensors: there is no TPU kernel behind them to port.

Shapes: dtau/omega [P, W], beta [L, P, W], albedo/f0 [W]; radiance [U, W].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.linalg import ddiff2, ediff
from .disco import (
    KMIN,
    ModeTables,
    beam_attenuation,
    build_mode_tables,
    clamp_ssa,
    thermal_layer_fit,
)

__all__ = ["build_mode_tables", "solve_twostream"]


def _mode_radiance(
    m_idx, lam, lam_sun, lam_user, parity,
    dtau, omega, beta, t_top, sbar, t_ground,
    albedo, mu1, w1, mu0, user_mu, user_up, include_ss, f0, thermal,
):
    """One azimuth mode: lam/lam_sun/parity [L], lam_user [L, U] (numpy);
    ``thermal`` None or (b0, b1, surface emission) from
    ``disco.thermal_layer_fit``. Returns radiance [U, W]."""
    dt, dev = dtau.dtype, dtau.device

    def const(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    omega = clamp_ssa(omega)
    even = (parity > 0).astype(np.float64)

    # --- homogeneous solution (closed form, N = 1) ---------------------
    lam2 = lam * lam
    cb = torch.einsum("l,lpw->pw", const(lam2 * even), beta)
    ca = torch.einsum("l,lpw->pw", const(lam2 * (1.0 - even)), beta)
    a_hat = 1.0 / mu1 - omega * ca * (w1 / mu1)
    b_hat = 1.0 / mu1 - omega * cb * (w1 / mu1)
    k = torch.sqrt(torch.clamp(a_hat * b_hat, min=KMIN * KMIN))
    sqrt_b = torch.sqrt(b_hat)
    f_hat = 1.0 / sqrt_b
    g_hat = sqrt_b / k
    d = 1.0 / np.sqrt(w1 * mu1)
    x = 0.5 * d * (f_hat - g_hat)  # up component of v_a
    y = 0.5 * d * (f_hat + g_hat)  # down component

    is_m0 = 1.0 if m_idx == 0 else 0.0
    two_minus_delta = 1.0 if m_idx == 0 else 2.0

    # --- particular (Green's function) sources --------------------------
    # (c_minus, c_plus, amplitude, decay rate in optical depth, kind): the
    # solar beam, and at m = 0 the isotropic thermal source b0 exp(-b1 tau)
    cq = two_minus_delta * omega / (4.0 * math.pi)
    qp = cq * torch.einsum("l,lpw->pw", const(lam * parity * lam_sun), beta)
    qm = cq * torch.einsum("l,lpw->pw", const(lam * lam_sun), beta)
    sources = [(k * (w1 * (qp * x + qm * y)), -k * (w1 * (qp * y + qm * x)),
                t_top * f0[None, :], sbar, "beam")]
    thermal_m = thermal if (thermal is not None and m_idx == 0) else None
    if thermal_m is not None:
        b0, b1, _ = thermal_m
        q_th = 1.0 - omega
        sources.append((k * (w1 * (q_th * x + q_th * y)),
                        -k * (w1 * (q_th * y + q_th * x)), b0, b1, "thermal"))
    phi_mb = 0.0                                  # phi^- at layer bottom
    phi_pt = 0.0                                  # phi^+ at layer top
    for c_m, c_p, amp, decay, _ in sources:
        phi_mb = phi_mb + c_m * amp * ediff(decay, k, dtau)
        phi_pt = phi_pt - c_p * amp * ediff(
            torch.zeros_like(k), k + decay, dtau
        )

    ip_plus_top = y * phi_pt
    ip_minus_top = x * phi_pt
    ip_plus_bot = x * phi_mb
    ip_minus_bot = y * phi_mb

    # --- BVP: 2x2 block tridiagonal ------------------------------------
    refl = 2.0 * is_m0 * albedo * (w1 * mu1)      # [W]
    ground_sun = is_m0 * albedo * mu0 * t_ground * f0 / math.pi
    ground_direct = ground_sun if include_ss else 0.0 * ground_sun
    ground_thermal = (
        (1.0 - albedo) * thermal_m[2] if thermal_m is not None else None
    )
    if ground_thermal is not None:
        ground_direct = ground_direct + ground_thermal

    e = torch.exp(-k * dtau)
    xe = x * e
    ye = y * e

    P = dtau.shape[0]
    idx = torch.arange(P, device=dev)[:, None]
    first = idx == 0
    last = idx == P - 1
    d_tl = torch.where(first, y, -y)
    d_tr = torch.where(first, xe, -xe)
    d_bl = torch.where(last, xe - refl[None, :] * ye, xe)
    d_br = torch.where(last, y - refl[None, :] * x, y)
    # upper blocks' bottom row: -X_{p+1}, -Y_{p+1} E_{p+1}; lower blocks'
    # top row: Y_{p-1} E_{p-1}, X_{p-1}
    u_bl = -torch.roll(x, -1, dims=0)
    u_br = -torch.roll(ye, -1, dims=0)
    l_tl = torch.roll(ye, 1, dims=0)
    l_tr = torch.roll(x, 1, dims=0)
    rhs_top = torch.where(
        first, -ip_minus_top,
        ip_minus_top - torch.roll(ip_minus_bot, 1, dims=0),
    )
    rhs_bot = torch.where(
        last,
        ground_direct[None, :] - ip_plus_bot + refl[None, :] * ip_minus_bot,
        torch.roll(ip_plus_top, -1, dims=0) - ip_plus_bot,
    )
    coeff_l, coeff_m = _thomas_2x2(
        (l_tl, l_tr), (d_tl, d_tr, d_bl, d_br), (u_bl, u_br),
        (rhs_top, rhs_bot),
    )

    # --- post-processing at the user angles ----------------------------
    su1 = torch.einsum("lu,lpw->upw", const(lam_user * lam[:, None]), beta)
    su2 = torch.einsum(
        "lu,lpw->upw", const(lam_user * (lam * parity)[:, None]), beta
    )
    half_om_w = 0.5 * omega[None] * w1
    pv_up = half_om_w * (x[None] * su1 + y[None] * su2)
    pu_up = half_om_w * (y[None] * su1 + x[None] * su2)
    pv_dn = half_om_w * (x[None] * su2 + y[None] * su1)
    pu_dn = half_om_w * (y[None] * su2 + x[None] * su1)

    cbeam = two_minus_delta * omega[None] / (4.0 * math.pi)
    beam_up = cbeam * torch.einsum(
        "lu,lpw->upw", const(lam_user * (parity * lam_sun)[:, None]), beta
    )
    beam_dn = cbeam * torch.einsum(
        "lu,lpw->upw", const(lam_user * lam_sun[:, None]), beta
    )

    c_user = (1.0 / user_mu)[:, None, None]      # [U, 1, 1]
    du = dtau[None]
    ku = k[None]
    zero = torch.zeros_like(ku)

    efwd_k = ediff(zero, ku + c_user, du) * c_user
    erev_k = ediff(ku, c_user + zero, du) * c_user
    lu_c = coeff_l[None]
    mu_c = coeff_m[None]
    s_up = pv_up * lu_c * efwd_k + pu_up * mu_c * erev_k
    s_dn = pv_dn * lu_c * erev_k + pu_dn * mu_c * efwd_k

    for c_m, c_p, amp, decay, kind in sources:
        sbu = decay[None]
        ampu = amp[None]
        efwd_s = ediff(zero, sbu + c_user, du) * c_user
        erev_s = ediff(sbu, c_user + zero, du) * c_user
        green_minus_up = ddiff2(zero, sbu + c_user, ku + c_user, du) * c_user
        green_plus_up = (
            efwd_s - ediff(ku + sbu, sbu + c_user, du) * c_user
        ) / (ku + sbu)
        green_minus_dn = ddiff2(ku, c_user + zero, sbu, du) * c_user
        green_plus_dn = (
            erev_s - ediff(sbu, ku + sbu + c_user, du) * c_user
        ) / (ku + sbu)
        cmu = c_m[None]
        cpu = c_p[None]
        s_up = s_up + (pv_up * cmu * ampu * green_minus_up
                       - pu_up * cpu * ampu * green_plus_up)
        s_dn = s_dn + (pv_dn * cmu * ampu * green_minus_dn
                       - pu_dn * cpu * ampu * green_plus_dn)
        if kind == "beam":
            if include_ss:
                s_up = s_up + beam_up * ampu * efwd_s
                s_dn = s_dn + beam_dn * ampu * erev_s
        else:
            # the thermal source's own emission, isotropic
            one_minus_om = (1.0 - omega)[None]
            s_up = s_up + one_minus_om * ampu * efwd_s
            s_dn = s_dn + one_minus_om * ampu * erev_s

    # attenuate and sum the layers
    od_user = du * c_user                        # [U, P, W]
    cum_above = torch.cumsum(od_user, dim=1) - od_user
    cum_below = (
        torch.flip(torch.cumsum(torch.flip(od_user, (1,)), dim=1), (1,))
        - od_user
    )
    rad_up = torch.sum(torch.exp(-cum_above) * s_up, dim=1)  # [U, W]
    rad_dn = torch.sum(torch.exp(-cum_below) * s_dn, dim=1)

    # ground reflection of the downwelling diffuse field
    i_minus_ground = (
        ye[P - 1] * coeff_l[P - 1]
        + x[P - 1] * coeff_m[P - 1]
        + y[P - 1] * phi_mb[P - 1]
    )
    ground_up = (refl * i_minus_ground)[None, :]
    if ground_thermal is not None:
        ground_up = ground_up + ground_thermal[None, :]
    if include_ss:
        ground_up = ground_up + ground_sun[None, :]
    total_od_user = torch.sum(od_user, dim=1)
    rad_up = rad_up + torch.exp(-total_od_user) * ground_up
    return torch.where(user_up[:, None], rad_up, rad_dn)


def _thomas_2x2(lower, diag, upper, rhs):
    """Pivot-free block-Thomas sweep of the 2x2-block tridiagonal BVP,
    one loop step per layer on [W] tensors (reference
    ``sktran_do_pentadiagonal.cpp``).

    lower = (l_tl, l_tr), the blocks' top row (the bottom row is zero);
    upper = (u_bl, u_br), the bottom row (the top row is zero); diag =
    (d_tl, d_tr, d_bl, d_br); rhs = (r_t, r_b); all [P, W]. Returns the
    coefficients (L, M), each [P, W].
    """
    l_tl, l_tr = lower
    d_tl, d_tr, d_bl, d_br = diag
    u_bl, u_br = upper
    r_t, r_b = rhs
    P = r_t.shape[0]

    # forward: x_{p-1} = G_{p-1} x_p + h_{p-1}, so the effective diagonal
    # is D + L G_{p-1} (lower's bottom row is zero)
    z = torch.zeros_like(r_t[0])
    g_tl = g_tr = g_bl = g_br = h_t = h_b = z
    gs = []
    for p in range(P):
        a = d_tl[p] + l_tl[p] * g_tl + l_tr[p] * g_bl
        b = d_tr[p] + l_tl[p] * g_tr + l_tr[p] * g_br
        c = d_bl[p]
        dd = d_br[p]
        rt_eff = r_t[p] - (l_tl[p] * h_t + l_tr[p] * h_b)
        rb_eff = r_b[p]
        inv = 1.0 / (a * dd - b * c)
        # G = -D'^{-1} U with D'^{-1} = inv [[dd, -b], [-c, a]]
        g_tl = -inv * (-b * u_bl[p])
        g_tr = -inv * (-b * u_br[p])
        g_bl = -inv * (a * u_bl[p])
        g_br = -inv * (a * u_br[p])
        h_t = inv * (dd * rt_eff - b * rb_eff)
        h_b = inv * (-c * rt_eff + a * rb_eff)
        gs.append((g_tl, g_tr, g_bl, g_br, h_t, h_b))

    # back substitution: x_{P-1} = h_{P-1}; x_p = G_p x_{p+1} + h_p
    xt, xb = gs[-1][4], gs[-1][5]
    out_t, out_b = [xt], [xb]
    for p in range(P - 2, -1, -1):
        gtl, gtr, gbl, gbr, ht, hb = gs[p]
        xt, xb = gtl * xt + gtr * xb + ht, gbl * xt + gbr * xb + hb
        out_t.append(xt)
        out_b.append(xb)
    return torch.stack(out_t[::-1]), torch.stack(out_b[::-1])


def solve_twostream(
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
):
    """Two-stream plane-parallel DO radiance, wavelength-minor.

    dtau/omega [P, W] (TOA first); beta [L, P, W]; albedo [W]; ``tables``
    from ``rt.disco.build_mode_tables(2, ...)``; ``chapman`` an optional
    [P, P] pseudo-spherical chapman matrix; the thermal sources as in
    ``disco_nstream.solve_nstream``. Returns radiance [U, W].
    """
    if len(tables.mu) != 1:
        msg = "solve_twostream requires nstr = 2 tables"
        raise ValueError(msg)
    dt, dev = dtau.dtype, dtau.device
    mu0 = tables.mu0
    mu1 = float(tables.mu[0])
    w1 = float(tables.w[0])
    t_top, t_ground, sbar = beam_attenuation(dtau, mu0, chapman)

    M = tables.lam_stream.shape[0]
    if num_azimuth is not None:
        M = min(M, num_azimuth)
    luse = min(beta.shape[0], 2)
    beta = beta[:luse]

    user_mu = torch.as_tensor(np.asarray(tables.user_mu), dtype=dt, device=dev)
    user_up = torch.as_tensor(np.asarray(user_up, dtype=bool), device=dev)
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

    rad = 0.0
    for m in range(M):
        r_m = _mode_radiance(
            m,
            tables.lam_stream[m, :luse, 0],
            tables.lam_sun[m, :luse],
            tables.lam_user[m, :luse, :],
            tables.parity[m, :luse],
            dtau, omega, beta, t_top, sbar, t_ground,
            albedo, mu1, w1, mu0, user_mu, user_up, include_ss, f0, thermal,
        )
        # the reference's relative-azimuth convention: cos(m (pi - dphi))
        az = torch.cos(m * (math.pi - user_azimuth))[:, None]
        rad = rad + az * r_m
    return rad
