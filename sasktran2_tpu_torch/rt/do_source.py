"""The discrete-ordinates multiple-scatter source evaluated along spherical
rays (counterpart of ``sasktran2_tpu/rt/do_source.py``, the scalar and
polarized wavelength-minor paths).

The DO solution's source function is evaluated analytically at both ends
of every traced segment: the level fields of the segment's layer, blended
linearly in depth between the layer's top and bottom, contracted with the
normalized associated Legendre functions (polarized: the generalized
spherical functions d0, P+ and P-) of the segment's propagation direction
and weighted by its azimuth cosines (and sines for U).

Layout on the card. The reference gathers the layer coefficients at every
segment (a [M, R, S, L, W] tensor, evaluated a few rays at a time under
``lax.map``). Here the endpoint evaluations are grouped by layer on the
host once per geometry (``build_layer_rows``): row j of layer p holds one
endpoint's angular coefficients. The contraction is then one batched
product [P, J, M*L] @ [P, M*L, W] per field (polarized: [P, 3J, 3*M*L]
@ [P, 3*M*L, W], the three Stokes rows of each endpoint against the three
greek components of B_l g_l), whose output [P, J(, 3), W] is the largest
intermediate, and a row lookup takes each endpoint's value back to its
segment.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.wigner import normalized_alp, wigner_d
from .raytrace import TracedRays


def build_ray_angular_tables(traced: TracedRays, nleg: int, num_azimuth: int):
    """Static angular tables: normalized ALP at each boundary's *signed*
    propagation cosine and the per-boundary azimuth cosines."""
    mu_signed = traced.cos_zenith  # [R, S+1]
    lam_b = np.zeros((num_azimuth, nleg) + mu_signed.shape)
    cosm = np.zeros((num_azimuth,) + mu_signed.shape)
    for m in range(num_azimuth):
        lam_b[m] = normalized_alp(mu_signed, m, nleg)
        cosm[m] = np.cos(m * (np.pi - traced.boundary_relazi))
    return {"lam_b": lam_b, "cosm": cosm}


def build_ray_vector_tables(traced: TracedRays, nleg: int, num_azimuth: int):
    """Static angular tables for the polarized ray source
    (``sasktran2_tpu/rt/do_source.py:224``): the three independent
    generalized-spherical-function entries of Pi_l^m (d0, P+, P-) at each
    boundary's *signed* propagation cosine, plus the per-boundary azimuth
    weights (cos for I/Q, sin for U)."""
    mu_signed = traced.cos_zenith  # [R, S+1]
    theta = np.arccos(np.clip(mu_signed, -1.0, 1.0))
    d0 = np.zeros((num_azimuth, nleg) + mu_signed.shape)
    pp = np.zeros_like(d0)
    pm = np.zeros_like(d0)
    cosm = np.zeros((num_azimuth,) + mu_signed.shape)
    sinm = np.zeros_like(cosm)
    dphi = np.pi - traced.boundary_relazi
    for m in range(num_azimuth):
        d0[m] = wigner_d(theta, m, 0, nleg)
        d2p = wigner_d(theta, m, 2, nleg)
        d2m = wigner_d(theta, m, -2, nleg)
        pp[m] = 0.5 * (d2p + d2m)
        pm[m] = 0.5 * (d2p - d2m)
        cosm[m] = np.cos(m * dphi)
        sinm[m] = np.sin(m * dphi)
    return {"d0": d0, "pp": pp, "pm": pm, "cosm": cosm, "sinm": sinm}


def _endpoint_coefficients(tables, rr, bb):
    """The angular coefficients of the endpoints at boundaries (rr, bb):
    [n, M, L] for the scalar tables of ``build_ray_angular_tables``
    (cosm[m] lam_b[m, l]); [n, 3, 3, M, L] for the vector tables of
    ``build_ray_vector_tables``, indexed (output Stokes row I/Q/U, greek
    component c0/c1/c2 of B_l g_l):

        I = cos (d0 c0),  Q = cos (P+ c1 - P- c2),  U = sin (-P- c1 + P+ c2).
    """
    if "lam_b" in tables:
        lam_b, cosm = tables["lam_b"], tables["cosm"]
        return np.moveaxis(lam_b[:, :, rr, bb] * cosm[:, None, rr, bb], -1, 0)
    cos = tables["cosm"][:, None, rr, bb]
    sin = tables["sinm"][:, None, rr, bb]
    d0, pp, pm = (tables[k][:, :, rr, bb] for k in ("d0", "pp", "pm"))
    zero = np.zeros_like(d0)
    coef = np.stack([
        np.stack([cos * d0, zero, zero]),
        np.stack([zero, cos * pp, -cos * pm]),
        np.stack([zero, -sin * pm, sin * pp]),
    ])                                              # [3, 3, M, L, n]
    return np.moveaxis(coef, -1, 0)


def build_layer_rows(traced: TracedRays, tables) -> dict:
    """Group the segment-endpoint evaluations of ``traced`` by layer.

    Each real segment (r, s) is evaluated at its entrance (boundary s, depth
    fraction ``seg_entrance_frac``) and its exit (boundary s + 1,
    ``seg_exit_frac``), both in layer ``seg_layer[r, s]`` (TOA first).
    ``tables`` comes from ``build_ray_angular_tables`` (scalar) or
    ``build_ray_vector_tables`` (polarized). Returns numpy tables:

    * ``coef`` [P, J, M, L] (scalar) or [P, J, 3, 3, M, L] (polarized): the
      angular coefficients of ``_endpoint_coefficients`` at the endpoint of
      row j of layer p; unused rows are zero;
    * ``frac`` [P, J]: the endpoint's depth fraction in its layer;
    * ``row_in`` / ``row_out`` [R, S]: the flat row p * J + j of each
      segment's entrance and exit. Padded segments point at row P * J,
      which the evaluation keeps at zero.
    """
    seg = traced.seg_layer
    R, S = seg.shape
    P = traced.od_weights.shape[-1] - 1
    r, s = np.nonzero(traced.mask > 0)
    n = len(r)
    p = np.concatenate([seg[r, s], seg[r, s]]).astype(np.int64)
    rr = np.concatenate([r, r])
    bb = np.concatenate([s, s + 1])
    frac = np.concatenate([
        traced.seg_entrance_frac[r, s], traced.seg_exit_frac[r, s]
    ])
    counts = np.bincount(p, minlength=P)
    starts = np.cumsum(counts) - counts
    order = np.argsort(p, kind="stable")
    j = np.empty_like(p)
    j[order] = np.arange(len(p)) - starts[p[order]]
    J = max(int(counts.max(initial=0)), 1)

    values = _endpoint_coefficients(tables, rr, bb)
    coef = np.zeros((P, J) + values.shape[1:])
    coef[p, j] = values
    frac_tab = np.zeros((P, J))
    frac_tab[p, j] = frac
    row = p * J + j
    row_in = np.full((R, S), P * J, dtype=np.int64)
    row_out = np.full((R, S), P * J, dtype=np.int64)
    row_in[r, s] = row[:n]
    row_out[r, s] = row[n:]
    return {"coef": coef, "frac": frac_tab, "row_in": row_in,
            "row_out": row_out}


def ms_source_along_rays_minor(internal, rows, include_ss: bool):
    """DO source per unit optical depth at the entrance and exit of every
    traced segment, wavelength-minor: (j_entrance, j_exit), each [R, S, W].

    ``internal`` comes from ``disco_nstream.solve_nstream(...,
    return_internal=True)`` (level fields [M, P, N, W]); ``rows`` from
    ``build_layer_rows``. ``include_ss`` adds the single scatter of the
    attenuated direct beam; a solve with thermal sources adds their
    isotropic (1 - omega) B at each endpoint. Padded segments get zero (the reference
    evaluates them in layer 0; the line-of-sight integral masks both).
    """
    levels = internal["levels"]
    omega = internal["omega"]                       # [P, W]
    beta = internal["beta"]                         # [L, P, W]
    dt, dev = omega.dtype, omega.device

    def const(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    lam = const(internal["lam"])                    # [M, L, N]
    parity = np.asarray(internal["parity"])         # [M, L]
    wq = const(internal["w_quad"])[:, None]         # [N, 1]
    M, L = parity.shape
    P, W = omega.shape

    def stream_sums(ip, im):
        s1 = torch.einsum("mln,mpnw->mplw", lam, ip * wq)
        s2 = torch.einsum("mln,mpnw->mplw", lam, im * wq)
        return s1 + const(parity)[:, None, :, None] * s2

    g_top = stream_sums(levels["i_plus_top"], levels["i_minus_top"])
    g_bot = stream_sums(levels["i_plus_bot"], levels["i_minus_bot"])

    # layer-space coefficients [M, P, L, W] -> [P, M*L, W]
    beta_plw = beta.movedim(0, 1)[None]             # [1, P, L, W]
    om = omega[None, :, None, :]

    def per_layer(c):
        return c.permute(1, 0, 2, 3).reshape(P, M * L, W)

    c_top = per_layer(0.5 * om * beta_plw * g_top)
    c_bot = per_layer(0.5 * om * beta_plw * g_bot)
    coef = const(rows["coef"][:, :, :M, :L])         # [P, J, M, L]
    J = coef.shape[1]
    coef = coef.reshape(P, J, M * L)
    frac = const(rows["frac"])[..., None]           # [P, J, 1]
    y = (1.0 - frac) * (coef @ c_top) + frac * (coef @ c_bot)
    if include_ss:
        two_minus_delta = np.where(np.arange(M) == 0, 1.0, 2.0)
        sun = const(parity * internal["lam_sun"] * two_minus_delta[:, None])
        c_beam = per_layer(
            om / (4.0 * math.pi) * beta_plw * sun[:, None, :, None]
        )
        amp = (internal["t_top"] * internal["f0"][None, :])[:, None, :]
        decay = (internal["sbar"] * internal["dtau"])[:, None, :]
        y = y + (coef @ c_beam) * amp * torch.exp(-decay * frac)
    thermal = internal.get("thermal")
    if thermal is not None:
        # the isotropic thermal source (1 - omega) b0 exp(-b1 tau) at the
        # endpoint's depth in its layer
        b0, b1, _ = thermal
        y = y + ((1.0 - omega) * b0)[:, None, :] * torch.exp(
            -(b1 * internal["dtau"])[:, None, :] * frac
        )
    flat = torch.cat([y.reshape(P * J, W), torch.zeros_like(y[0, :1])])
    R, S = rows["row_in"].shape

    def lookup(row):
        idx = torch.as_tensor(row.reshape(-1), device=dev)
        return flat.index_select(0, idx).reshape(R, S, W)

    return lookup(rows["row_in"]), lookup(rows["row_out"])


def ms_source_along_rays_vec_minor(internal, rows, include_ss: bool):
    """Polarized DO source per unit optical depth at the entrance and exit
    of every traced segment, in the ray meridian frame, wavelength-minor
    (``sasktran2_tpu/rt/do_source.py:386``): (j_entrance, j_exit), each
    [R, S, 3, W].

    ``internal`` comes from ``disco_vec_minor.solve_nstream_vector(...,
    return_internal=True)`` (levels [M, P, K, W], greeks [4, L, P, W]);
    ``rows`` from ``build_layer_rows`` on ``build_ray_vector_tables``. The
    generalized-spherical expansion is evaluated at the signed boundary
    cosines with the transformed level fields; B_l g_l is decomposed onto
    the greeks (bg0 = a1 g0 - b1 g1, bg1 = a2 g1 - b1 g0, bg2 = a3 g2).
    Per layer, one [J * 3, 3 * M * L] @ [3 * M * L, W] product per field
    (layer top, layer bottom, direct beam) gives every endpoint's (I, Q, U)
    at once, where the reference gathers [M, R, S, L, W] two rays at a
    time. A solve with a thermal source (the generic route's, through
    ``ms_source_along_rays_vec``) adds its unpolarized (1 - omega) B to I.
    Padded segments get zero.
    """
    levels = internal["levels"]
    omega = internal["omega"]                       # [P, W]
    greeks = internal["greeks"]                     # [4, L, P, W]
    dt, dev = omega.dtype, omega.device

    def const(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    parity = np.asarray(internal["parity"])         # [M, L]
    s_tab = const(internal["stream_sum"])           # [M, L, 3, K]
    par_d = const(internal["par_d"])                # [M, L, 3]
    M, L = parity.shape
    P, W = omega.shape
    a1, a2, a3, b1 = (g.movedim(0, 1)[None] for g in greeks)  # [1, P, L, W]

    def components(ip, im):
        # stream sums g [M, P, L, 3, W], then B_l g: [M, P, 3, L, W]
        t1 = torch.einsum("mlck,mpkw->mplcw", s_tab, ip)
        t2 = torch.einsum("mlck,mpkw->mplcw", s_tab, im)
        g = t1 + par_d[:, None, :, :, None] * t2
        g0, g1, g2 = g[..., 0, :], g[..., 1, :], g[..., 2, :]
        return torch.stack(
            [a1 * g0 - b1 * g1, a2 * g1 - b1 * g0, a3 * g2], dim=2
        )

    half_om = 0.5 * omega[None, :, None, None, :]

    def per_layer(c):
        # [M, P, 3, L, W] -> [P, 3 * M * L, W]
        return c.permute(1, 2, 0, 3, 4).reshape(P, 3 * M * L, W)

    c_top = per_layer(half_om * components(
        levels["i_plus_top"], levels["i_minus_top"]))
    c_bot = per_layer(half_om * components(
        levels["i_plus_bot"], levels["i_minus_bot"]))
    coef = const(rows["coef"][..., :M, :L])          # [P, J, 3, 3, M, L]
    J = coef.shape[1]
    coef = coef.reshape(P, J * 3, 3 * M * L)
    frac = const(np.repeat(rows["frac"], 3, axis=1))[..., None]  # [P, 3J, 1]
    y = (1.0 - frac) * (coef @ c_top) + frac * (coef @ c_bot)
    if include_ss:
        # beam column B_l e1 = (a1, -b1, 0) times nu_l d^l_{m0}(mu0)
        two_minus_delta = np.where(np.arange(M) == 0, 1.0, 2.0)
        sun = const(parity * internal["d0_sun"] * two_minus_delta[:, None])
        sun = sun[:, None, :, None]                  # [M, 1, L, 1]
        c_beam = torch.stack(
            [a1 * sun, -b1 * sun, torch.zeros_like(a1 * sun)], dim=2
        )                                            # [M, P, 3, L, W]
        c_beam = per_layer(
            omega[None, :, None, None, :] / (4.0 * math.pi) * c_beam
        )
        amp = (internal["t_top"] * internal["f0"][None, :])[:, None, :]
        decay = (internal["sbar"] * internal["dtau"])[:, None, :]
        y = y + (coef @ c_beam) * amp * torch.exp(-decay * frac)
    y = y.reshape(P * J, 3, W)
    thermal = internal.get("thermal")
    if thermal is not None:
        # the unpolarized thermal source (1 - omega) b0 exp(-b1 tau) adds
        # to I at the endpoint's depth in its layer
        b0, b1, _ = thermal
        th = ((1.0 - omega) * b0)[:, None, :] * torch.exp(
            -(b1 * internal["dtau"])[:, None, :] * const(rows["frac"])[..., None]
        )                                           # [P, J, W]
        e0 = torch.zeros(3, dtype=dt, device=dev)
        e0[0] = 1.0
        y = y + th.reshape(P * J, 1, W) * e0[:, None]
    flat = torch.cat([y, torch.zeros_like(y[:1])])
    R, S = rows["row_in"].shape

    def lookup(row):
        idx = torch.as_tensor(row.reshape(-1), device=dev)
        return flat.index_select(0, idx).reshape(R, S, 3, W)

    return lookup(rows["row_in"]), lookup(rows["row_out"])


# ---------------------------------------------------------------------------
# The generic route's sources: the batch-leading internals of
# ``rt.disco.solve_plane_parallel`` and ``rt.disco_vec.
# solve_plane_parallel_vector`` in the lane layout of the evaluations above.
# ---------------------------------------------------------------------------


def _lane_thermal(thermal):
    if thermal is None:
        return None
    b0, b1, surf = thermal
    return b0.movedim(-1, 0), b1.movedim(-1, 0), surf


def ms_source_along_rays(internal, rows, include_ss: bool):
    """The scalar DO source per unit optical depth at the entrance and
    exit of every traced segment from the generic solver's internals
    (counterpart of ``sasktran2_tpu/rt/do_source.py:547-633``):
    (j_entrance, j_exit), each [W, R, S].

    ``internal`` comes from ``disco.solve_plane_parallel(...,
    return_internal=True)`` on a batch of one axis W (levels [M, W, P, N],
    omega [W, P], beta [W, P, L]); ``rows`` from ``build_layer_rows`` on
    ``build_ray_angular_tables``. The reference gathers every segment's
    layer coefficients; here the internals move to the wavelength-minor
    layout and go through the per-layer evaluation of
    ``ms_source_along_rays_minor``, which computes the same sum. Padded
    segments get zero."""
    lane = {
        "levels": {k: v.movedim(1, -1) for k, v in internal["levels"].items()},
        "omega": internal["omega"].movedim(-1, 0),
        "beta": internal["beta"].permute(2, 1, 0),
        "lam": internal["lam"],
        "lam_sun": internal["lam_sun"],
        "parity": internal["parity"],
        "w_quad": internal["w_quad"],
        "t_top": internal["t_top"].movedim(-1, 0),
        "sbar": internal["sbar"].movedim(-1, 0),
        "dtau": internal["dtau"].movedim(-1, 0),
        "f0": internal["f0"],
        "thermal": _lane_thermal(internal.get("thermal")),
    }
    ji, jo = ms_source_along_rays_minor(lane, rows, include_ss)
    return ji.movedim(-1, 0), jo.movedim(-1, 0)


def ms_source_along_rays_vec(internal, rows, include_ss: bool):
    """The polarized DO source per unit optical depth at the entrance and
    exit of every traced segment, in the ray meridian frame, from the
    generic vector solver's internals (counterpart of
    ``sasktran2_tpu/rt/do_source.py:251-384``): (j_entrance, j_exit), each
    [W, R, S, 3].

    ``internal`` comes from ``disco_vec.solve_plane_parallel_vector(...,
    return_internal=True)`` on a batch of one axis W; ``rows`` from
    ``build_layer_rows`` on ``build_ray_vector_tables``. The stream-sum
    table S[l, c, (j s)] = w_j Pi_j[s, c] and the parity signs are built
    from the solve's mode tables, and the evaluation is
    ``ms_source_along_rays_vec_minor``'s, thermal source included."""
    pi = np.asarray(internal["pi_stream"])              # [M, L, N, 3, 3]
    M, L, N = pi.shape[:3]
    parity = np.asarray(internal["parity"])
    stream_sum = np.einsum("mljsc,j->mlcjs", pi,
                           np.asarray(internal["w_quad"])).reshape(
        M, L, 3, 3 * N)
    lane = {
        "levels": {k: v.movedim(1, -1) for k, v in internal["levels"].items()},
        "omega": internal["omega"].movedim(-1, 0),
        "greeks": torch.stack(
            [g.permute(2, 1, 0) for g in internal["greeks"]]),
        "d0_sun": internal["d0_sun"],
        "parity": parity,
        "stream_sum": stream_sum,
        "par_d": parity[..., None] * np.array([1.0, 1.0, -1.0]),
        "t_top": internal["t_top"].movedim(-1, 0),
        "sbar": internal["sbar"].movedim(-1, 0),
        "dtau": internal["dtau"].movedim(-1, 0),
        "f0": internal["f0"],
        "thermal": _lane_thermal(internal.get("thermal")),
    }
    ji, jo = ms_source_along_rays_vec_minor(lane, rows, include_ss)
    return ji.movedim(-1, 0), jo.movedim(-1, 0)
