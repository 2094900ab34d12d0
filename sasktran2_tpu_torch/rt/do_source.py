"""The discrete-ordinates multiple-scatter source evaluated along spherical
rays (counterpart of ``sasktran2_tpu/rt/do_source.py``, scalar
wavelength-minor path).

The DO solution's source function is evaluated analytically at both ends
of every traced segment: the level fields of the segment's layer, blended
linearly in depth between the layer's top and bottom, contracted with the
normalized associated Legendre functions of the segment's propagation
direction and weighted by its azimuth cosines.

Layout on the card. The reference gathers the layer coefficients at every
segment (a [M, R, S, L, W] tensor, evaluated a few rays at a time under
``lax.map``). Here the endpoint evaluations are grouped by layer on the
host once per geometry (``build_layer_rows``): row j of layer p holds one
endpoint's angular coefficients. The contraction is then one batched
product [P, J, M*L] @ [P, M*L, W] per field, whose output [P, J, W] is the
largest intermediate, and a row lookup takes each endpoint's value back
to its segment.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.wigner import normalized_alp
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


def build_layer_rows(traced: TracedRays, tables) -> dict:
    """Group the segment-endpoint evaluations of ``traced`` by layer.

    Each real segment (r, s) is evaluated at its entrance (boundary s, depth
    fraction ``seg_entrance_frac``) and its exit (boundary s + 1,
    ``seg_exit_frac``), both in layer ``seg_layer[r, s]`` (TOA first).
    Returns numpy tables:

    * ``coef`` [P, J, M, L]: cosm[m] * lam_b[m, l] at the endpoint of row j
      of layer p (``tables`` from ``build_ray_angular_tables``); unused
      rows are zero;
    * ``frac`` [P, J]: the endpoint's depth fraction in its layer;
    * ``row_in`` / ``row_out`` [R, S]: the flat row p * J + j of each
      segment's entrance and exit. Padded segments point at row P * J,
      which the evaluation keeps at zero.
    """
    lam_b, cosm = tables["lam_b"], tables["cosm"]
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

    coef = np.zeros((P, J) + lam_b.shape[:2])
    coef[p, j] = np.moveaxis(lam_b[:, :, rr, bb] * cosm[:, None, rr, bb], -1, 0)
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
    attenuated direct beam. Padded segments get zero (the reference
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
    flat = torch.cat([y.reshape(P * J, W), torch.zeros_like(y[0, :1])])
    R, S = rows["row_in"].shape

    def lookup(row):
        idx = torch.as_tensor(row.reshape(-1), device=dev)
        return flat.index_select(0, idx).reshape(R, S, W)

    return lookup(rows["row_in"]), lookup(rows["row_out"])
