"""The discrete-ordinates solver of the generic per-wavelength route
(counterpart of ``sasktran2_tpu/rt/disco.py``) and the pieces the
wavelength-minor solvers share with it: the single-scatter-albedo clamp,
solar-beam attenuation, the thermal layer fit, BRDF azimuth moments and
the per-azimuth-mode angular tables (``disco.py:61-231``).

The tables are host-side numpy, built by the same code as the JAX
package's; a test pins them array-equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

import torch

from .. import spans
from ..ops.eigen import jacobi_eigh
from ..ops.linalg import block_tridiag_solve, cholesky, ddiff2, ediff, solve_upper
from ..ops.quadrature import streams
from ..ops.wigner import normalized_alp
from .brdf import KERNELS as BRDF_KERNELS

# The solver needs omega strictly below 1: conservative scattering gives a
# zero eigenvalue in the m=0 mode. The ceiling and its reasons are the JAX
# package's (``sasktran2_tpu/rt/disco.py:61-73``); radiance shifts by about
# 1e-6 relative for a fully conservative atmosphere.
SSA_CEILING = 1.0 - 1e-4
KMIN = 1e-8


def clamp_ssa(omega):
    """Clamp omega below ``SSA_CEILING`` with a straight-through gradient:
    d(clamp)/d(omega) = 1 everywhere, so ssa weighting functions of a
    pure-Rayleigh (omega = 1) atmosphere are not zeroed."""
    return omega + (omega.clamp(max=SSA_CEILING) - omega).detach()


def beam_attenuation(dtau, mu0: float, chapman=None):
    """The direct solar beam through the layers (TOA first): its
    transmission at each layer top, t_top [P, W], and at the ground,
    t_ground [W], and each layer's mean slant factor sbar [P, W] (the slant
    optical depth across the layer over its dtau). ``chapman`` [P, P]
    (numpy) maps the layer dtau to the slant optical depth down to each
    layer's bottom; None is the plane-parallel 1/mu0
    (``sasktran2_tpu/rt/disco_nstream.py:413-425``)."""
    t_top, t_ground, sbar = beam_attenuation_leading(dtau.T, mu0, chapman)
    return t_top.T, t_ground, sbar.T


def beam_attenuation_leading(dtau, mu0: float, chapman=None):
    """``beam_attenuation`` in the batch-leading layout of the generic
    route: dtau [..., P] -> t_top [..., P], t_ground [...], sbar [..., P]."""
    P = dtau.shape[-1]
    if chapman is None:
        c = torch.tril(torch.ones((P, P), dtype=dtau.dtype,
                                  device=dtau.device)) / mu0
    else:
        c = torch.as_tensor(chapman, dtype=dtau.dtype,
                            device=dtau.device)
    slant_bottom = torch.einsum("pq,...q->...p", c, dtau)
    slant_top = torch.cat(
        [torch.zeros_like(slant_bottom[..., :1]), slant_bottom[..., :-1]],
        dim=-1)
    sbar = (slant_bottom - slant_top) / torch.clamp(dtau, min=1e-30)
    return torch.exp(-slant_top), torch.exp(-slant_bottom[..., -1]), sbar


def thermal_layer_fit(thermal_b0, thermal_b1_bottom, dtau,
                      surface_emission, albedo):
    """The thermal source of each layer as b0 exp(-b1 tau), tau the
    optical depth below the layer top, fitted to the Planck values at its
    top (``thermal_b0``) and bottom (``thermal_b1_bottom``), both [P, W]
    (``sasktran2_tpu/rt/disco_nstream.py:443-464``); a layer whose two
    values are not both positive gets their mean, flat. Returns (b0, b1,
    surface emission [W], zeros where None).

    The logarithm's arguments are floored where the fit does not apply, so
    that the branch ``torch.where`` discards stays finite in the backward
    pass too. The reference floors at 1e-300, which is 0 in float32: there
    the floor is the dtype's smallest normal number."""
    if thermal_b0 is None or thermal_b1_bottom is None:
        msg = (
            "a thermal source needs both thermal_b0 and thermal_b1_bottom "
            "(the Planck source at the layer tops and bottoms)"
        )
        raise ValueError(msg)
    dt = dtau.dtype
    floor = 1e-300 if dt == torch.float64 else torch.finfo(dt).tiny
    both_pos = (thermal_b0 > 0.0) & (thermal_b1_bottom > 0.0)
    b1 = torch.where(
        both_pos,
        torch.log(
            torch.clamp(thermal_b0, min=floor)
            / torch.clamp(thermal_b1_bottom, min=floor)
        ) / torch.clamp(dtau, min=1e-30),
        torch.zeros_like(dtau),
    )
    b0 = torch.where(
        both_pos, thermal_b0, 0.5 * (thermal_b0 + thermal_b1_bottom)
    )
    if surface_emission is None:
        surface_emission = torch.zeros_like(albedo)
    return b0, b1, surface_emission


BRDF_AZIMUTH_NODES = 64


def brdf_azimuth_moments(brdf, brdf_args, mu, user_mu, mu0, m_indices):
    """Per-mode azimuth moments of a scalar BRDF kernel
    (``sasktran2_tpu/rt/disco.py:201-231``): the cos(m x) moments of the
    kernel over a 64-point midpoint rule in the internal Fourier variable
    x, evaluated at the geometric relative azimuth pi - x, for every
    wavelength of ``brdf_args`` [W, nargs] at once and differentiable in
    it. ``mu`` [N] and ``user_mu`` [U] are tensors of the working dtype;
    ``m_indices`` the modes. Returns rho_stream [M, W, N, N], rho_user
    [M, W, U, N], rho_sun_stream [M, W, N] and rho_sun_user [M, W, U]
    (outgoing direction first, incoming second)."""
    if not isinstance(brdf, tuple(BRDF_KERNELS.values())):
        msg = (
            f"BRDF kernel {type(brdf).__module__}.{type(brdf).__name__} is "
            "not one of the port's (sasktran2_tpu_torch.rt.brdf); "
            "params.brdf_from_reference carries a JAX-side kernel over"
        )
        raise NotImplementedError(msg)
    if brdf_args is None:
        msg = "a BRDF needs its brdf_args [W, nargs]"
        raise ValueError(msg)
    dt, dev = brdf_args.dtype, brdf_args.device
    nq = BRDF_AZIMUTH_NODES
    xq = 2.0 * math.pi * (
        torch.arange(nq, dtype=dt, device=dev) + 0.5
    ) / nq
    phi_geo = math.pi - xq
    m = torch.as_tensor(np.asarray(m_indices), dtype=dt, device=dev)
    cosmx = torch.cos(m[:, None] * xq[None, :]) / nq     # [M, Q], (1/2pi) dx

    def moments(mu_out, mu_in):
        kern = brdf.kernel(
            mu_out[:, None, None], mu_in[None, :, None],
            phi_geo[None, None, :], brdf_args,
        )                                                # [W, O, I, Q]
        return torch.einsum("...oiq,mq->m...oi", kern, cosmx)

    mu0t = torch.full((1,), float(mu0), dtype=dt, device=dev)
    return {
        "rho_stream": moments(mu, mu),
        "rho_user": moments(user_mu, mu),
        "rho_sun_stream": moments(mu, mu0t)[..., 0],
        "rho_sun_user": moments(user_mu, mu0t)[..., 0],
    }


@dataclass(frozen=True)
class ModeTables:
    """Static per-azimuth-mode angular tables (host-side numpy).

    lam_stream [M, L, N], lam_sun [M, L], lam_user [M, L, U], parity
    [M, L]; mu, w [N] stream cosines and weights; mu0; user_mu [U].
    """

    lam_stream: np.ndarray
    lam_sun: np.ndarray
    lam_user: np.ndarray
    parity: np.ndarray
    mu: np.ndarray
    w: np.ndarray
    mu0: float
    user_mu: np.ndarray


def build_mode_tables(
    nstr: int,
    nlegendre: int,
    mu0: float,
    user_mu: np.ndarray,
    num_azimuth: int | None = None,
) -> ModeTables:
    """Build the static angular tables for all azimuth modes at one SZA.
    ``user_mu`` are positive cosines; the caller tracks whether each user
    direction is up- or down-welling."""
    if num_azimuth is None:
        num_azimuth = nstr
    mu, w = streams(nstr)
    L = max(nlegendre, 1)
    lam_stream = np.zeros((num_azimuth, L, len(mu)))
    lam_sun = np.zeros((num_azimuth, L))
    lam_user = np.zeros((num_azimuth, L, len(user_mu)))
    parity = np.zeros((num_azimuth, L))
    ls = np.arange(L)
    for m in range(num_azimuth):
        lam_stream[m] = normalized_alp(mu, m, L)
        lam_sun[m] = normalized_alp(np.array(mu0), m, L)
        lam_user[m] = normalized_alp(
            np.asarray(user_mu, dtype=np.float64), m, L
        )
        parity[m] = (-1.0) ** (ls + m)
    return ModeTables(
        lam_stream=lam_stream,
        lam_sun=lam_sun,
        lam_user=lam_user,
        parity=parity,
        mu=mu,
        w=w,
        mu0=float(mu0),
        user_mu=np.asarray(user_mu, dtype=np.float64),
    )


# ---------------------------------------------------------------------------
# The generic solver: batch-leading layout, the azimuth modes as a batch axis
# (counterpart of ``sasktran2_tpu/rt/disco.py:154-864``).
# ---------------------------------------------------------------------------
#
# Every array carries the caller's batch (the engine's wavelengths) in its
# leading axes, the layer axis P and the half-stream axis N trailing. The
# reference vmaps its per-mode solve over the azimuth modes; here the modes
# are one more leading axis: a per-mode table enters as [M, 1.., ...] (one
# singleton per batch axis) and a per-mode scalar (m = 0 or not) as
# [M, 1.., 1...], so each mode's arrays are [M, ..., P, ...] and every
# einsum broadcasts the mode axis against the batch. The eigensolve and the
# boundary-value problem move the whole (mode x batch) set to the minor axis
# of the lane kernels (``ops.eigen.jacobi_eigh``,
# ``ops.linalg.block_tridiag_solve``).


class _Modes:
    """The azimuth-mode axis of one solve, with ``nb`` batch axes after
    it: per-mode scalars (m = 0 or not) as [M, 1 x nb, 1 x trailing]."""

    def __init__(self, m_indices, nb: int, dt, dev):
        self.m = np.asarray(m_indices)
        self.nb = nb
        self.dt, self.dev = dt, dev

    def scalar(self, values, trailing: int):
        shape = (-1,) + (1,) * (self.nb + trailing)
        return torch.as_tensor(
            np.asarray(values, dtype=np.float64).reshape(shape),
            dtype=self.dt, device=self.dev)

    def is_m0(self, trailing: int = 0):
        return self.scalar(np.where(self.m == 0, 1.0, 0.0), trailing)

    def two_minus_delta(self, trailing: int = 0):
        return self.scalar(np.where(self.m == 0, 1.0, 2.0), trailing)


def _as(t, like, nb: int):
    """A per-mode numpy table [M, ...] as a tensor [M, 1 x nb, ...] of
    ``like``'s dtype and device."""
    t = np.asarray(t)
    t = t.reshape(t.shape[:1] + (1,) * nb + t.shape[1:])
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _assemble_symmetric(omega, beta, lam, parity, mu, w, nb):
    """The symmetrized layer matrices A_hat (odd-parity kernel) and B_hat
    (even-parity kernel), each [M, ..., P, N, N], from omega [..., P],
    beta [..., P, L] (``nb`` batch axes), the mode tables lam [M, L, N]
    and parity [M, L] (numpy) and the stream cosines and weights mu, w
    (numpy)."""
    even = (parity > 0).astype(np.float64)
    ll = lam[..., :, None] * lam[..., None, :]             # [M, L, N, N]
    ca = torch.einsum("...pl,...lij->...pij", beta,
                      _as(ll * (1.0 - even)[..., None, None], beta, nb))
    cb = torch.einsum("...pl,...lij->...pij", beta,
                      _as(ll * even[..., None, None], beta, nb))
    s = np.sqrt(w / mu)
    scale = torch.as_tensor(s[:, None] * s[None, :], dtype=beta.dtype,
                            device=beta.device)
    diag = torch.as_tensor(np.diag(1.0 / mu), dtype=beta.dtype,
                           device=beta.device)
    a_hat = diag - omega[..., None, None] * ca * scale
    b_hat = diag - omega[..., None, None] * cb * scale
    return a_hat, b_hat


def _eigensolve(a_hat, b_hat, mu, w):
    """The layer eigenproblem by Cholesky + symmetric eigensolve: (k
    [..., N], X [..., N, N], Y [..., N, N]), the columns of X / Y the up /
    down parts of the downward-decaying homogeneous solutions. The
    Cholesky factor and the triangular solve are the lane unrolled ones;
    the eigensolve is ``ops.eigen.jacobi_eigh``."""
    chol = cholesky(b_hat)
    m_sym = torch.einsum("...ji,...jk,...kl->...il", chol, a_hat, chol)
    m_sym = 0.5 * (m_sym + m_sym.transpose(-1, -2))
    k2, v = jacobi_eigh(m_sym)
    k = torch.sqrt(torch.clamp(k2, min=KMIN * KMIN))
    f_hat = solve_upper(chol.transpose(-1, -2), v)
    g_hat = (chol @ v) / k[..., None, :]
    dinv = torch.as_tensor(1.0 / np.sqrt(w * mu), dtype=a_hat.dtype,
                           device=a_hat.device)[:, None]
    x = 0.5 * dinv * (f_hat - g_hat)
    y = 0.5 * dinv * (f_hat + g_hat)
    return k, x, y


def _beam_sources(omega, beta, lam, lam_sun, parity, modes):
    """Q+ / Q- beam scattering sources at the stream angles, [M, ..., P, N]
    each: (2 - delta_m0) (omega / 4 pi) sum_l beta_l lam_li (parity_l)
    lam_sun_l."""
    c = modes.two_minus_delta(1) * omega / (4.0 * math.pi)
    qp = c[..., None] * torch.einsum(
        "...pl,...li->...pi", beta,
        _as((parity * lam_sun)[..., None] * lam, beta, modes.nb))
    qm = c[..., None] * torch.einsum(
        "...pl,...li->...pi", beta,
        _as(lam_sun[..., None] * lam, beta, modes.nb))
    return qp, qm


def _greens_coefficients(k, x, y, qp, qm, w):
    """Green's-function coefficients of a source (Q+, Q-) on the
    homogeneous modes, with the analytic J-norm -1/k:
    c_minus = k (Q+ . W X + Q- . W Y), c_plus = -k (Q+ . W Y + Q- . W X)."""
    wt = torch.as_tensor(w, dtype=k.dtype, device=k.device)
    wqp = qp * wt
    wqm = qm * wt
    proj_v = (torch.einsum("...pi,...pia->...pa", wqp, x)
              + torch.einsum("...pi,...pia->...pa", wqm, y))
    proj_u = (torch.einsum("...pi,...pia->...pa", wqp, y)
              + torch.einsum("...pi,...pia->...pa", wqm, x))
    return k * proj_v, -k * proj_u


def _particular_boundary(k, c_minus, c_plus, amp, decay, dtau):
    """The particular solution's non-zero boundary values,
    (phi_minus at the layer bottom, phi_plus at the layer top), each
    [..., P, N], for a source amp exp(-decay tau) across each layer."""
    d = dtau[..., None]
    sb = decay[..., None]
    tt = amp[..., None]
    phi_minus_bottom = c_minus * tt * ediff(sb, k, d)
    phi_plus_top = -c_plus * tt * ediff(torch.zeros_like(k), k + sb, d)
    return phi_minus_bottom, phi_plus_top


def _project(mat, vec):
    """[..., P, N, A] x [..., P, A] -> [..., P, N]."""
    return torch.einsum("...pia,...pa->...pi", mat, vec)


def _bvp_blocks(k, x, y, dtau, phi_mb, phi_pt, refl, ground_direct):
    """Assemble the block-tridiagonal boundary-value problem (TOA, the I+
    and I- continuity at each interface, the ground) and solve it for the
    homogeneous coefficients (L, M) of every layer, each [..., P, N].
    ``refl`` [..., N, N] is the ground reflection of I- into I+ (weights
    included), ``ground_direct`` [..., N] the ground's direct source."""
    P = k.shape[-2]
    N = k.shape[-1]
    e = torch.exp(-k * dtau[..., None])
    xe = x * e[..., None, :]
    ye = y * e[..., None, :]

    ip_plus_top = _project(y, phi_pt)
    ip_minus_top = _project(x, phi_pt)
    ip_plus_bot = _project(x, phi_mb)
    ip_minus_bot = _project(y, phi_mb)

    batch = torch.broadcast_shapes(
        x.shape[:-3], dtau.shape[:-1], refl.shape[:-2])
    full = batch + (P, N, N)
    refl_b = refl[..., None, :, :].expand(full)
    x_b, y_b, xe_b, ye_b = (t.expand(full) for t in (x, y, xe, ye))
    dev = k.device

    def two_by_two(tl, tr, bl, br):
        top = torch.cat([tl, tr], dim=-1)
        bot = torch.cat([bl, br], dim=-1)
        return torch.cat([top, bot], dim=-2)

    zero_n = torch.zeros(full, dtype=x.dtype, device=dev)
    idx = torch.arange(P, device=dev)
    is_first = (idx == 0)[:, None, None]
    is_last = (idx == P - 1)[:, None, None]

    diag_tl = torch.where(is_first, y_b, -y_b)
    diag_tr = torch.where(is_first, xe_b, -xe_b)
    grd_bl = xe_b - refl_b @ ye_b
    grd_br = y_b - refl_b @ x_b
    diag_bl = torch.where(is_last, grd_bl, xe_b)
    diag_br = torch.where(is_last, grd_br, y_b)
    diag = two_by_two(diag_tl, diag_tr, diag_bl, diag_br)

    xn = torch.roll(x_b, -1, dims=-3)
    yen = torch.roll(ye_b, -1, dims=-3)
    upper = two_by_two(zero_n, zero_n, -xn, -yen)
    xprev = torch.roll(x_b, 1, dims=-3)
    yeprev = torch.roll(ye_b, 1, dims=-3)
    lower = two_by_two(yeprev, xprev, zero_n, zero_n)

    ip_pt_next = torch.roll(ip_plus_top, -1, dims=-2)
    ip_mb_prev = torch.roll(ip_minus_bot, 1, dims=-2)
    is_first_v = (idx == 0)[:, None]
    is_last_v = (idx == P - 1)[:, None]
    rhs_top = torch.where(is_first_v, -ip_minus_top,
                          ip_minus_top - ip_mb_prev)
    rhs_ground = (
        ground_direct[..., None, :] - ip_plus_bot
        + torch.einsum("...pij,...pj->...pi", refl_b, ip_minus_bot)
    )
    rhs_bot = torch.where(is_last_v, rhs_ground, ip_pt_next - ip_plus_bot)
    rhs = torch.cat([rhs_top, rhs_bot], dim=-1).expand(batch + (P, 2 * N))

    sol = block_tridiag_solve(lower, diag, upper, rhs)
    return sol[..., :N], sol[..., N:]


def _user_projections(omega, beta, lam, lam_user, lam_sun, parity, x, y, w,
                      modes):
    """Scattering of each homogeneous mode and of the direct beam into the
    user directions: pv/pu up and down [M, ..., P, U, A] (the v_a / u_a
    shaped fields), beam up and down [M, ..., P, U]."""
    nb = modes.nb
    wt = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    lam_t = _as(lam, x, nb)
    t1 = torch.einsum("...lj,...pja->...pla", lam_t, x * wt[:, None])
    t2 = torch.einsum("...lj,...pja->...pla", lam_t, y * wt[:, None])
    par = _as(parity, x, nb)[..., None, :, None]            # [M, 1.., 1, L, 1]
    tt_v = t1 + par * t2
    tt_u = t2 + par * t1
    half_om = 0.5 * omega[..., None, None]
    up_tab = _as(lam_user, x, nb)
    dn_tab = _as(parity[..., :, None] * lam_user, x, nb)

    def proj(tab, tt):
        return half_om * torch.einsum("...pl,...lu,...pla->...pua",
                                      beta, tab, tt)

    pv_up = proj(up_tab, tt_v)
    pu_up = proj(up_tab, tt_u)
    pv_dn = proj(dn_tab, tt_v)
    pu_dn = proj(dn_tab, tt_u)
    cbeam = modes.two_minus_delta(1) * omega / (4.0 * math.pi)
    beam_up = cbeam[..., None] * torch.einsum(
        "...pl,...lu->...pu", beta,
        _as(lam_user * (parity * lam_sun)[..., :, None], x, nb))
    beam_dn = cbeam[..., None] * torch.einsum(
        "...pl,...lu->...pu", beta,
        _as(lam_user * (parity * parity * lam_sun)[..., :, None], x, nb))
    return pv_up, pu_up, pv_dn, pu_dn, beam_up, beam_dn


def _source_multipliers(k, dtau, decay, user_mu):
    """The divided-difference layer integrals of one particular source
    amp exp(-decay tau) toward the user directions: efwd_s, erev_s
    [..., P, U, 1] (the source itself) and the Green's multipliers of the
    minus / plus parts, up and down, [..., P, U, A]."""
    c = 1.0 / user_mu
    cb = c[:, None]
    du = dtau[..., None, None]
    ku = k[..., None, :]
    sbu = decay[..., None, None]
    um = user_mu[:, None]
    zk = torch.zeros_like(ku)
    zs = torch.zeros_like(sbu)
    efwd_s = ediff(zs, sbu + cb, du) / um
    erev_s = ediff(sbu, cb + zs, du) / um
    green_minus_up = ddiff2(zk, sbu + cb, ku + cb, du) / um
    green_plus_up = (efwd_s - ediff(ku + sbu, sbu + cb, du) / um) / (ku + sbu)
    green_minus_dn = ddiff2(ku, cb + zk, sbu, du) / um
    green_plus_dn = (erev_s - ediff(sbu, ku + sbu + cb, du) / um) / (ku + sbu)
    return (efwd_s, erev_s, green_minus_up, green_plus_up, green_minus_dn,
            green_plus_dn)


def _postprocess_mode(
    k, x, y, coeff_l, coeff_m, sources,
    omega, beta, dtau,
    lam, lam_user, lam_sun, parity, w, modes,
    user_mu, user_up, refl_user, gd_user_gated, gd_user_ungated,
    include_ss, phi_mb,
):
    """Radiance [M, ..., U] of every mode at the user directions: the
    layer source integrals (homogeneous modes, each particular source's
    Green's terms and its direct term), attenuated and summed from the
    ground up (upwelling user directions, at the TOA, plus the reflected
    ground term) or from the TOA down (downwelling, at the ground).
    ``sources`` lists (c_minus, c_plus, amp, decay, kind), kind "beam"
    (direct term gated by ``include_ss``) or "thermal" (isotropic direct
    term, m = 0, always included)."""
    P = k.shape[-2]
    pv_up, pu_up, pv_dn, pu_dn, beam_up, beam_dn = _user_projections(
        omega, beta, lam, lam_user, lam_sun, parity, x, y, w, modes)
    um = user_mu[:, None]
    cb = 1.0 / um
    du = dtau[..., None, None]
    ku = k[..., None, :]
    efwd_k = ediff(torch.zeros_like(ku), ku + cb, du) / um
    erev_k = ediff(ku, cb + torch.zeros_like(ku), du) / um
    lu = coeff_l[..., None, :]
    mu_c = coeff_m[..., None, :]
    s_up = torch.sum(pv_up * lu * efwd_k + pu_up * mu_c * erev_k, dim=-1)
    s_dn = torch.sum(pv_dn * lu * erev_k + pu_dn * mu_c * efwd_k, dim=-1)
    is_m0 = modes.is_m0(2)

    for c_minus, c_plus, amp, decay, kind in sources:
        (efwd_s, erev_s, gm_up, gp_up, gm_dn, gp_dn) = _source_multipliers(
            k, dtau, decay, user_mu)
        ampu = amp[..., None, None]
        cmu = c_minus[..., None, :]
        cpu = c_plus[..., None, :]
        s_up = s_up + torch.sum(
            pv_up * cmu * ampu * gm_up - pu_up * cpu * ampu * gp_up, dim=-1)
        s_dn = s_dn + torch.sum(
            pv_dn * cmu * ampu * gm_dn - pu_dn * cpu * ampu * gp_dn, dim=-1)
        if kind == "beam":
            if include_ss:
                s_up = s_up + beam_up * ampu[..., 0] * efwd_s[..., 0]
                s_dn = s_dn + beam_dn * ampu[..., 0] * erev_s[..., 0]
        else:
            one_minus_om = (1.0 - omega)[..., None]
            s_up = s_up + is_m0 * one_minus_om * ampu[..., 0] * efwd_s[..., 0]
            s_dn = s_dn + is_m0 * one_minus_om * ampu[..., 0] * erev_s[..., 0]

    od_user = dtau[..., :, None] / user_mu                 # [..., P, U]
    cum_above = torch.cumsum(od_user, dim=-2) - od_user
    cum_below = torch.flip(
        torch.cumsum(torch.flip(od_user, (-2,)), dim=-2), (-2,)) - od_user
    rad_up = torch.sum(torch.exp(-cum_above) * s_up, dim=-2)

    e = torch.exp(-k * dtau[..., None])
    i_minus_ground = (
        torch.einsum("...ia,...a->...i", (y * e[..., None, :])[..., P - 1, :, :],
                     coeff_l[..., P - 1, :])
        + torch.einsum("...ia,...a->...i", x[..., P - 1, :, :],
                       coeff_m[..., P - 1, :])
        + torch.einsum("...ia,...a->...i", y[..., P - 1, :, :],
                       phi_mb[..., P - 1, :])
    )
    ground_up = torch.einsum("...ui,...i->...u", refl_user, i_minus_ground)
    ground_up = ground_up + gd_user_ungated
    if include_ss:
        ground_up = ground_up + gd_user_gated
    total_od_user = torch.sum(od_user, dim=-2)
    rad_up = rad_up + torch.exp(-total_od_user) * ground_up
    rad_dn = torch.sum(torch.exp(-cum_below) * s_dn, dim=-2)
    return torch.where(user_up, rad_up, rad_dn)


def _level_fields(k, x, y, dtau, coeff_l, coeff_m, phi_mb, phi_pt):
    """The diffuse stream fields at each layer's top and bottom, a dict of
    [..., P, N] (for fluxes and the ray sources)."""
    e = torch.exp(-k * dtau[..., None])
    xe = x * e[..., None, :]
    ye = y * e[..., None, :]
    return {
        "i_plus_top": (_project(x, coeff_l) + _project(ye, coeff_m)
                       + _project(y, phi_pt)),
        "i_minus_top": (_project(y, coeff_l) + _project(xe, coeff_m)
                        + _project(x, phi_pt)),
        "i_plus_bot": (_project(xe, coeff_l) + _project(y, coeff_m)
                       + _project(x, phi_mb)),
        "i_minus_bot": (_project(ye, coeff_l) + _project(x, coeff_m)
                        + _project(y, phi_mb)),
    }


def _solve_one_mode(
    modes, lam, lam_sun, lam_user, parity,
    dtau, omega, beta, t_top, sbar, t_ground,
    albedo, mu, w, mu0, user_mu, user_up, include_ss,
    f0, thermal, surface_ops=None,
):
    """The full solve of every azimuth mode at once, batched over the
    caller's batch: (radiance [M, ..., U], level fields [M, ..., P, N],
    internals). ``thermal`` is None or (b0, b1, surface emission) from
    ``thermal_layer_fit``; ``surface_ops`` is None (Lambertian) or the
    BRDF azimuth moments [M, ..., ...] of ``brdf_azimuth_moments``."""
    dt, dev = dtau.dtype, dtau.device
    N = len(mu)
    U = len(user_mu)
    omega = clamp_ssa(omega)
    a_hat, b_hat = _assemble_symmetric(omega, beta, lam, parity, mu, w,
                                       modes.nb)
    k, x, y = _eigensolve(a_hat, b_hat, mu, w)

    qp, qm = _beam_sources(omega, beta, lam, lam_sun, parity, modes)
    c_minus, c_plus = _greens_coefficients(k, x, y, qp, qm, w)
    sources = [(c_minus, c_plus, t_top * f0[..., None], sbar, "beam")]
    if thermal is not None:
        b0, b1, _ = thermal
        q_th = modes.is_m0(2) * (1.0 - omega)[..., None] * torch.ones(
            N, dtype=dt, device=dev)
        c_minus_th, c_plus_th = _greens_coefficients(k, x, y, q_th, q_th, w)
        sources.append((c_minus_th, c_plus_th, b0, b1, "thermal"))

    phi_mb = 0.0
    phi_pt = 0.0
    for c_m, c_p, amp, decay, _kind in sources:
        mb, pt = _particular_boundary(k, c_m, c_p, amp, decay, dtau)
        phi_mb = phi_mb + mb
        phi_pt = phi_pt + pt

    # ground reflection: the Lambertian rank-one 2 a w mu at m = 0, or the
    # BRDF's per-mode azimuth moments
    wmu = torch.as_tensor(w * mu, dtype=dt, device=dev)
    is_m0 = modes.is_m0(0)
    if surface_ops is None:
        base = 2.0 * modes.is_m0(2) * albedo[..., None, None] * wmu
        refl = base.expand(base.shape[:-2] + (N, N))
        refl_user = base.expand(base.shape[:-2] + (U, N))
        ground_sun = is_m0 * albedo * mu0 * t_ground * f0 / math.pi
        gd_user_sun = ground_sun[..., None] * torch.ones(
            U, dtype=dt, device=dev)
    else:
        tmd = modes.two_minus_delta(1)
        sun_in = (mu0 * t_ground * f0)[..., None]
        refl = 2.0 * math.pi * surface_ops["rho_stream"] * wmu
        refl_user = 2.0 * math.pi * surface_ops["rho_user"] * wmu
        ground_sun = tmd * surface_ops["rho_sun_stream"] * sun_in
        gd_user_sun = tmd * surface_ops["rho_sun_user"] * sun_in

    ones_n = torch.ones(N, dtype=dt, device=dev)
    ground_thermal = (
        is_m0 * (1.0 - albedo) * thermal[2] if thermal is not None else None
    )
    if surface_ops is None:
        gd = ground_sun if ground_thermal is None else (
            ground_sun + ground_thermal)
        ground_direct = gd[..., None] * ones_n
    else:
        ground_direct = ground_sun if ground_thermal is None else (
            ground_sun + ground_thermal[..., None] * ones_n)

    coeff_l, coeff_m = _bvp_blocks(
        k, x, y, dtau, phi_mb, phi_pt, refl, ground_direct)
    gd_user_ungated = (
        ground_thermal[..., None] * torch.ones(U, dtype=dt, device=dev)
        if ground_thermal is not None
        else torch.zeros((), dtype=dt, device=dev)
    )
    rad = _postprocess_mode(
        k, x, y, coeff_l, coeff_m, sources,
        omega, beta, dtau,
        lam, lam_user, lam_sun, parity, w, modes,
        user_mu, user_up, refl_user, gd_user_sun, gd_user_ungated,
        include_ss, phi_mb,
    )
    internal = {"k": k, "x": x, "y": y, "coeff_l": coeff_l,
                "coeff_m": coeff_m, "c_minus": c_minus, "c_plus": c_plus}
    levels = _level_fields(k, x, y, dtau, coeff_l, coeff_m, phi_mb, phi_pt)
    return rad, levels, internal


def _solver_f0(f0, albedo):
    if f0 is None:
        return torch.ones(albedo.shape, dtype=albedo.dtype,
                          device=albedo.device)
    return torch.as_tensor(f0, dtype=albedo.dtype,
                           device=albedo.device).broadcast_to(albedo.shape)


def solve_plane_parallel(
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
    return_levels: bool = False,
    return_internal: bool = False,
    f0=None,
    thermal_b0=None,
    thermal_b1_bottom=None,
    surface_emission=None,
    brdf=None,
    brdf_args=None,
):
    """The multi-azimuth discrete-ordinates solve of a batch in a
    (pseudo-)spherical-beam plane-parallel atmosphere, batch-leading: the
    generic per-wavelength route's solver
    (``sasktran2_tpu/rt/disco.py:714-864``).

    dtau, omega [..., P] (TOA first); beta [..., P, L]; albedo [...];
    ``tables`` from ``build_mode_tables``; ``user_up`` [U] bool (True for
    upwelling user directions) and ``user_azimuth`` [U] (numpy);
    ``chapman`` an optional [P, P] chapman matrix; ``f0`` the solar
    irradiance [...] (default 1); ``thermal_b0`` / ``thermal_b1_bottom``
    [..., P] the Planck source at the layer tops and bottoms and
    ``surface_emission`` [...] the ground's; ``brdf`` (a kernel of
    ``rt.brdf``) with ``brdf_args`` [..., nargs] replaces the Lambertian
    ground by the BRDF's azimuth moments.

    All azimuth modes are solved at once, as one more leading batch axis.
    Returns radiance [..., U]; with ``return_levels`` also the m = 0 level
    fields (a dict of [..., P, N]); with ``return_internal`` also the dict
    ``rt.do_source.ms_source_along_rays`` reads: ``levels`` (each
    [M, ..., P, N]), ``t_top``, ``sbar``, ``t_ground``, ``dtau``, the
    clamped ``omega``, the truncated ``beta``, the mode tables ``lam``,
    ``lam_sun``, ``parity`` (numpy), ``mu0``, ``w_quad`` (numpy), ``f0``
    and ``thermal`` (the layer fit, or None).
    """
    dt, dev = dtau.dtype, dtau.device
    mu0 = tables.mu0
    t_top, t_ground, sbar = beam_attenuation_leading(dtau, mu0, chapman)

    M = tables.lam_stream.shape[0]
    if num_azimuth is not None:
        M = min(M, num_azimuth)
    mu = np.asarray(tables.mu)
    w = np.asarray(tables.w)
    nstr = 2 * len(mu)
    luse = min(beta.shape[-1], max(nstr, 1))
    beta = beta[..., :luse]
    lam = np.asarray(tables.lam_stream[:M, :luse])
    lam_sun = np.asarray(tables.lam_sun[:M, :luse])
    lam_user = np.asarray(tables.lam_user[:M, :luse])
    parity = np.asarray(tables.parity[:M, :luse])
    user_mu = torch.as_tensor(np.asarray(tables.user_mu), dtype=dt,
                              device=dev)
    user_up_t = torch.as_tensor(np.asarray(user_up, dtype=bool), device=dev)
    user_azimuth = torch.as_tensor(np.asarray(user_azimuth), dtype=dt,
                                   device=dev)
    modes = _Modes(np.arange(M), albedo.ndim, dt, dev)
    f0 = _solver_f0(f0, albedo)

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
        rad_modes, levels, internal = _solve_one_mode(
            modes, lam, lam_sun, lam_user, parity,
            dtau, omega, beta, t_top, sbar, t_ground,
            albedo, mu, w, mu0, user_mu, user_up_t, include_ss,
            f0, thermal, surface_ops,
        )
    # azimuth synthesis I(u) = sum_m I_m(u) cos(m (pi - dphi_u))
    m_t = torch.arange(M, dtype=dt, device=dev)
    cosines = torch.cos(m_t[:, None] * (math.pi - user_azimuth[None, :]))
    radiance = torch.einsum("m...u,mu->...u", rad_modes, cosines)

    if return_internal:
        internal = dict(internal)
        internal.update({
            "levels": levels,
            "t_top": t_top,
            "sbar": sbar,
            "t_ground": t_ground,
            "dtau": dtau,
            "omega": clamp_ssa(omega),
            "beta": beta,
            "lam": lam,
            "lam_sun": lam_sun,
            "parity": parity,
            "mu0": mu0,
            "w_quad": w,
            "f0": f0,
            "thermal": thermal,
        })
        return radiance, internal
    if return_levels:
        return radiance, {k: v[0] for k, v in levels.items()}
    return radiance
