"""The discrete-ordinates solve of the reference, one azimuth mode at a
time, in plain torch: a plane-parallel (or pseudo-spherical, with a
Chapman matrix) stack of homogeneous layers under a collimated solar beam
over a Lambertian ground.

Per mode: the layer eigenproblem by Cholesky and a symmetric eigensolve
(``torch.linalg``); the beam's particular solution by Green's-function
coefficients; the boundary-value problem (no diffuse light at the top,
continuity at every interface, Lambertian reflection at the ground)
assembled as one dense matrix and solved by ``torch.linalg.solve``; and
the radiance at the user directions by integrating each layer's source
analytically. The equations are those of upstream SASKTRAN2's DO engine
as the port's generic route states them (``sasktran2_tpu_torch/rt/
disco.py``); the reference keeps the same ceiling on the single-scatter
albedo and the same floor on the eigenvalues, so that it computes the same
discretised problem. Its derivatives come from autograd.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .special import ddiff2, ediff, normalized_alp, streams

SSA_CEILING = 1.0 - 1e-4
KMIN = 1e-8


def clamp_ssa(omega):
    """omega below ``SSA_CEILING``, with a derivative of 1 everywhere."""
    return omega + (omega.clamp(max=SSA_CEILING) - omega).detach()


def beam(dtau, mu0, chapman=None):
    """Direct-beam transmission at each layer top t_top [n, P], at the
    ground t_ground [n], and each layer's mean slant factor sbar [n, P]."""
    P = dtau.shape[-1]
    if chapman is None:
        c = torch.tril(torch.ones((P, P), dtype=dtau.dtype,
                                  device=dtau.device)) / mu0
    else:
        c = torch.as_tensor(chapman, dtype=dtau.dtype, device=dtau.device)
    bottom = dtau @ c.T
    top = torch.cat([torch.zeros_like(bottom[..., :1]), bottom[..., :-1]], -1)
    sbar = (bottom - top) / torch.clamp(dtau, min=1e-30)
    return torch.exp(-top), torch.exp(-bottom[..., -1]), sbar


def chapman_matrix(altitudes_m, earth_radius_m, mu0):
    """[P, P] slant paths of straight solar rays through spherical shells:
    row p maps the TOA-first layer optical depths to the slant optical
    depth from the top of the atmosphere down to the bottom of layer p."""
    radii = earth_radius_m + np.asarray(altitudes_m, dtype=np.float64)
    P = len(radii) - 1
    c = np.zeros((P, P))
    for p in range(P):
        r_b = radii[P - 1 - p]
        rt = r_b * np.sqrt(max(1.0 - mu0 * mu0, 0.0))
        for q in range(p + 1):
            r_hi, r_lo = radii[P - q], radii[P - 1 - q]
            c[p, q] = (np.sqrt(max(r_hi**2 - rt**2, 0.0))
                       - np.sqrt(max(r_lo**2 - rt**2, 0.0))) / (r_hi - r_lo)
    return c


def _eigen(omega, beta, lam, parity, mu, w):
    """k [n, P, N] and the up / down parts X, Y [n, P, N, N] of the
    downward-decaying homogeneous solutions."""
    t = lambda a: torch.as_tensor(a, dtype=beta.dtype, device=beta.device)  # noqa: E731
    even = t((parity > 0).astype(np.float64))
    ll = t(lam)[:, :, None] * t(lam)[:, None, :]             # [L, N, N]
    s = np.sqrt(w / mu)
    scale = t(s[:, None] * s[None, :])
    ca = torch.einsum("npl,lij->npij", beta * (1.0 - even), ll)
    cb = torch.einsum("npl,lij->npij", beta * even, ll)
    diag = t(np.diag(1.0 / mu))
    a_hat = diag - omega[..., None, None] * ca * scale
    b_hat = diag - omega[..., None, None] * cb * scale
    chol = torch.linalg.cholesky(b_hat)
    sym = chol.transpose(-1, -2) @ a_hat @ chol
    k2, v = torch.linalg.eigh(0.5 * (sym + sym.transpose(-1, -2)))
    k = torch.sqrt(torch.clamp(k2, min=KMIN * KMIN))
    f = torch.linalg.solve_triangular(chol.transpose(-1, -2), v, upper=True)
    g = (chol @ v) / k[..., None, :]
    dinv = t(1.0 / np.sqrt(w * mu))[:, None]
    return k, 0.5 * dinv * (f - g), 0.5 * dinv * (f + g)


def _bvp(k, x, y, dtau, phi_mb, phi_pt, refl, ground_direct):
    """The homogeneous coefficients (L, M) [n, P, N] of every layer from
    the boundary-value problem, assembled as one dense matrix: per layer,
    the continuity of the downward field at its top (at the top of the
    atmosphere: no diffuse light) and of the upward field at its bottom
    (at the ground: the Lambertian reflection of the downward field plus
    the direct beam's)."""
    n, P, N = k.shape
    B = 2 * N
    e = torch.exp(-k * dtau[..., None])
    xe, ye = x * e[..., None, :], y * e[..., None, :]
    pr = lambda m, v: torch.einsum("npia,npa->npi", m, v)  # noqa: E731
    ipt, imt = pr(y, phi_pt), pr(x, phi_pt)
    ipb, imb = pr(x, phi_mb), pr(y, phi_mb)
    sign = torch.full((P, 1, 1), -1.0, dtype=k.dtype, device=k.device)
    sign[0] = 1.0
    top = torch.cat([sign * y, sign * xe], -1)             # [n, P, N, B]
    ground = torch.cat([xe[:, -1] - refl @ ye[:, -1],
                        y[:, -1] - refl @ x[:, -1]], -1)[:, None]
    bottom = torch.cat([torch.cat([xe[:, :-1], y[:, :-1]], -1), ground], 1)
    zero = torch.zeros_like(top[:, 1:])
    diag = torch.cat([top, bottom], -2)                     # [n, P, B, B]
    upper = torch.cat([zero, torch.cat([-x[:, 1:], -ye[:, 1:]], -1)], -2)
    lower = torch.cat([torch.cat([ye[:, :-1], x[:, :-1]], -1), zero], -2)
    i = np.arange(B)
    p = np.arange(P)[:, None, None]
    flat = lambda rows, cols: torch.as_tensor(  # noqa: E731
        (rows * B + i[:, None]) * (P * B) + cols * B + i[None, :],
        device=k.device).reshape(-1)
    A = torch.zeros((n, P * B * P * B), dtype=k.dtype, device=k.device)
    A[:, flat(p, p)] = diag.reshape(n, -1)
    A[:, flat(p[:-1], p[:-1] + 1)] = upper.reshape(n, -1)
    A[:, flat(p[1:], p[1:] - 1)] = lower.reshape(n, -1)
    rhs_top = torch.cat([-imt[:, :1], imt[:, 1:] - imb[:, :-1]], 1)
    rhs_ground = (ground_direct - ipb[:, -1]
                  + torch.einsum("nij,nj->ni", refl, imb[:, -1]))[:, None]
    rhs_bot = torch.cat([ipt[:, 1:] - ipb[:, :-1], rhs_ground], 1)
    rhs = torch.cat([rhs_top, rhs_bot], -1).reshape(n, P * B)
    sol = torch.linalg.solve(A.reshape(n, P * B, P * B), rhs)
    sol = sol.reshape(n, P, B)
    return sol[..., :N], sol[..., N:]


def solve_mode(m, dtau, omega, beta, albedo, mu0, user_mu, user_up, f0,
               include_ss, chapman=None, nstr=16):
    """Azimuth mode ``m`` of the solve: (radiance [n, U] at the user
    cosines ``user_mu`` [U] (up where ``user_up``), the stream fields at
    each layer's top and bottom, and what the limb source needs).

    dtau, omega [n, P] and beta [n, P, L] TOA first; albedo, f0 [n]."""
    dt, dev = dtau.dtype, dtau.device
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)  # noqa: E731
    mu, w = streams(nstr)
    N = len(mu)
    L = beta.shape[-1]
    lam = normalized_alp(mu, m, L)                         # [L, N]
    lam_sun = normalized_alp(np.array(mu0), m, L)           # [L]
    lam_user = normalized_alp(np.asarray(user_mu), m, L)    # [L, U]
    parity = (-1.0) ** (np.arange(L) + m)
    tmd = 1.0 if m == 0 else 2.0
    is0 = 1.0 if m == 0 else 0.0
    omega = clamp_ssa(omega)
    k, x, y = _eigen(omega, beta, lam, parity, mu, w)

    # the beam's source at the streams and its Green's coefficients
    c = tmd * omega / (4.0 * math.pi)
    qp = c[..., None] * torch.einsum("npl,li->npi", beta,
                                     t((parity * lam_sun)[:, None] * lam))
    qm = c[..., None] * torch.einsum("npl,li->npi", beta,
                                     t(lam_sun[:, None] * lam))
    wt = t(w)
    proj_v = (torch.einsum("npi,npia->npa", qp * wt, x)
              + torch.einsum("npi,npia->npa", qm * wt, y))
    proj_u = (torch.einsum("npi,npia->npa", qp * wt, y)
              + torch.einsum("npi,npia->npa", qm * wt, x))
    c_minus, c_plus = k * proj_v, -k * proj_u
    t_top, t_ground, sbar = beam(dtau, mu0, chapman)
    amp = t_top * f0[:, None]
    d = dtau[..., None]
    phi_mb = c_minus * amp[..., None] * ediff(sbar[..., None], k, d)
    phi_pt = -c_plus * amp[..., None] * ediff(torch.zeros_like(k),
                                              k + sbar[..., None], d)

    wmu = t(w * mu)
    refl = (2.0 * is0 * albedo)[:, None, None] * wmu.expand(N, N)
    ground_sun = is0 * albedo * mu0 * t_ground * f0 / math.pi
    lc, mc = _bvp(k, x, y, dtau, phi_mb, phi_pt, refl,
                  ground_sun[:, None].expand(-1, N))

    # radiance at the user directions
    U = len(user_mu)
    um = t(user_mu)[:, None]                                 # [U, 1]
    cb = 1.0 / um
    lam_t = t(lam)
    t1 = torch.einsum("lj,npja->npla", lam_t, x * wt[:, None])
    t2 = torch.einsum("lj,npja->npla", lam_t, y * wt[:, None])
    par = t(parity)[:, None]
    tt_v, tt_u = t1 + par * t2, t2 + par * t1
    half_om = 0.5 * omega[..., None, None]

    def proj(tab, tt):
        return half_om * torch.einsum("npl,lu,npla->npua", beta, t(tab), tt)

    pv_up, pu_up = proj(lam_user, tt_v), proj(lam_user, tt_u)
    pv_dn = proj(parity[:, None] * lam_user, tt_v)
    pu_dn = proj(parity[:, None] * lam_user, tt_u)
    beam_up = c[..., None] * torch.einsum(
        "npl,lu->npu", beta, t(lam_user * (parity * lam_sun)[:, None]))
    beam_dn = c[..., None] * torch.einsum(
        "npl,lu->npu", beta, t(lam_user * lam_sun[:, None]))
    du = dtau[..., None, None]
    ku = k[..., None, :]
    zk = torch.zeros_like(ku)
    efwd_k = ediff(zk, ku + cb, du) / um
    erev_k = ediff(ku, cb + zk, du) / um
    lu, mu_c = lc[..., None, :], mc[..., None, :]
    s_up = (pv_up * lu * efwd_k + pu_up * mu_c * erev_k).sum(-1)
    s_dn = (pv_dn * lu * erev_k + pu_dn * mu_c * efwd_k).sum(-1)
    sbu = sbar[..., None, None]
    zs = torch.zeros_like(sbu)
    efwd_s = ediff(zs, sbu + cb, du) / um
    erev_s = ediff(sbu, cb + zs, du) / um
    gm_up = ddiff2(zk, sbu + cb, ku + cb, du) / um
    gp_up = (efwd_s - ediff(ku + sbu, sbu + cb, du) / um) / (ku + sbu)
    gm_dn = ddiff2(ku, cb + zk, sbu, du) / um
    gp_dn = (erev_s - ediff(sbu, ku + sbu + cb, du) / um) / (ku + sbu)
    ampu = amp[..., None, None]
    cmu, cpu = c_minus[..., None, :], c_plus[..., None, :]
    s_up = s_up + (pv_up * cmu * ampu * gm_up - pu_up * cpu * ampu * gp_up).sum(-1)
    s_dn = s_dn + (pv_dn * cmu * ampu * gm_dn - pu_dn * cpu * ampu * gp_dn).sum(-1)
    if include_ss:
        s_up = s_up + beam_up * ampu[..., 0] * efwd_s[..., 0]
        s_dn = s_dn + beam_dn * ampu[..., 0] * erev_s[..., 0]
    od_user = dtau[..., None] / t(user_mu)                   # [n, P, U]
    above = torch.cumsum(od_user, 1) - od_user
    below = od_user.flip(1).cumsum(1).flip(1) - od_user
    rad_up = (torch.exp(-above) * s_up).sum(1)
    e_last = torch.exp(-k[:, -1] * dtau[:, -1, None])
    i_minus_ground = (
        torch.einsum("nia,na->ni", y[:, -1] * e_last[:, None, :], lc[:, -1])
        + torch.einsum("nia,na->ni", x[:, -1], mc[:, -1])
        + torch.einsum("nia,na->ni", y[:, -1], phi_mb[:, -1]))
    ground_up = (2.0 * is0 * albedo)[:, None] * (i_minus_ground @ wmu)[:, None]
    ground_up = ground_up.expand(-1, U)
    if include_ss:
        ground_up = ground_up + ground_sun[:, None]
    rad_up = rad_up + torch.exp(-od_user.sum(1)) * ground_up
    rad_dn = (torch.exp(-below) * s_dn).sum(1)
    rad = torch.where(torch.as_tensor(np.asarray(user_up), device=dev),
                      rad_up, rad_dn)

    e = torch.exp(-k * dtau[..., None])
    xe, ye = x * e[..., None, :], y * e[..., None, :]
    pr = lambda mat, v: torch.einsum("npia,npa->npi", mat, v)  # noqa: E731
    levels = {
        "i_plus_top": pr(x, lc) + pr(ye, mc) + pr(y, phi_pt),
        "i_minus_top": pr(y, lc) + pr(xe, mc) + pr(x, phi_pt),
        "i_plus_bot": pr(xe, lc) + pr(y, mc) + pr(x, phi_mb),
        "i_minus_bot": pr(ye, lc) + pr(x, mc) + pr(y, phi_mb),
    }
    extra = {"omega": omega, "lam": lam, "parity": parity, "w": w}
    return rad, levels, extra


def solve(dtau, omega, beta, albedo, mu0, user_mu, user_up, user_azimuth,
          f0, include_ss, num_modes, chapman=None, nstr=16):
    """The radiance [n, U] summed over ``num_modes`` azimuth modes,
    I = sum_m I_m cos(m (pi - relative azimuth)), and each mode's level
    fields and tables (for the limb source)."""
    beta = beta[..., :nstr]
    azi = np.asarray(user_azimuth, dtype=np.float64)
    total = 0.0
    modes = []
    for m in range(num_modes):
        rad, levels, extra = solve_mode(
            m, dtau, omega, beta, albedo, mu0, user_mu, user_up, f0,
            include_ss, chapman, nstr)
        cosm = torch.as_tensor(np.cos(m * (np.pi - azi)), dtype=dtau.dtype,
                               device=dtau.device)
        total = total + rad * cosm
        modes.append((levels, extra))
    return total, modes, beta
