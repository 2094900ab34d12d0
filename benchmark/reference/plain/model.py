"""The reference's radiance and weighting functions for one configuration.

``radiance`` computes, for ``n`` lanes (a wavelength of one call each), the
radiance of every line of sight from the level inputs; ``reference`` adds
the weighting functions by autograd, one backward pass per line of sight,
with respect to the Rayleigh pressure and temperature, the absorber's
mixing ratio and the surface albedo.

Two geometries, as the configuration says:

* ``PlaneParallel`` with ground-viewing rays: the DO solve evaluated at
  the rays' cosines, single and multiple scatter both from the DO field.
* ``Spherical`` with tangent-altitude rays: exact single scatter along
  the traced rays (the sun attenuated along its slant path to every
  segment boundary), plus the DO multiple-scatter source evaluated at
  every segment end from the DO solve at each point of a grid of solar
  zeniths, interpolated to each boundary's own, and integrated along the
  ray.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import disco
from .optics import layer_optics, level_optics
from .raytrace import trace_limb
from .special import interp_matrix, legendre_p, normalized_alp, safe_div


def _geometry(config):
    g = config["geometry"]
    alts = np.linspace(g["altitude_min_m"], g["altitude_max_m"],
                       g["num_altitudes"])
    return g, alts


def _num_modes(leg):
    """Azimuth modes with a non-zero term: the phase expansion's support."""
    nz = torch.nonzero(torch.any(leg.reshape(-1, leg.shape[-1]) != 0, 0))
    return int(nz.max()) + 1


def _limb_tables(config, alts):
    g = config["geometry"]
    rays = [(r["tangent_altitude_m"], r["cos_sza"], r["relative_azimuth"])
            for r in config["rays"]]
    traced = trace_limb(alts, g["earth_radius_m"], rays)
    bmask = np.zeros(traced.cos_sza.shape)
    bmask[:, :-1] += traced.mask
    bmask[:, 1:] += traced.mask
    cs = traced.cos_sza[bmask > 0]
    lo, hi = float(cs.min()), float(cs.max())
    if hi - lo < 1e-6:
        hi = lo + 1e-6
    grid = np.linspace(lo, hi, config["solver"]["num_do_sza"])
    wts = interp_matrix(grid, traced.cos_sza.ravel()).reshape(
        traced.cos_sza.shape + (len(grid),))
    return traced, grid, wts


def _integrate(ext, j_in, j_out, traced, t):
    """sum over segments of T(closer) (1 - e^-dtau) (J_in + J_out) / 2."""
    mask = t(traced.mask)
    od = torch.einsum("rsa,na->nrs", t(traced.od_weights), ext) * mask
    closer = od.flip(-1).cumsum(-1).flip(-1) - od
    return (-torch.expm1(-od) * 0.5 * (j_in + j_out) * mask
            * torch.exp(-closer)).sum(-1)


def _single_scatter(ext, ssa, leg, albedo, traced, t):
    """Exact single scatter of every limb ray, sun-normalised, [n, R].
    No limb ray of the configurations reaches the ground."""
    intw = t(traced.interp_weights)
    od = torch.einsum("rsa,na->nrs", t(traced.od_weights), ext)
    sun = torch.exp(-torch.clamp(
        torch.einsum("rba,na->nrb", t(traced.sun_weights), ext), max=300.0))
    kscat = ext * ssa
    kscat_b = torch.einsum("rba,na->nrb", intw, kscat)
    beta_b = safe_div(torch.einsum("rba,nal->nrbl", intw, leg * kscat[..., None]),
                      kscat_b[..., None])
    pt = t(np.moveaxis(legendre_p(traced.cos_scatter, leg.shape[-1]), 0, -1))
    j_b = kscat_b * torch.einsum("nrbl,rbl->nrb", beta_b, pt) / (
        4.0 * math.pi) * sun
    odc = torch.clamp(od, min=0.0)
    factor = torch.where(odc < 1e-12, 1.0 - 0.5 * odc,
                         -torch.expm1(-odc) / torch.clamp(odc, min=1e-12))
    mask = t(traced.mask)
    src = factor * 0.5 * (j_b[..., :-1] + j_b[..., 1:]) * t(traced.lengths) * mask
    odm = od * mask
    closer = odm.flip(-1).cumsum(-1).flip(-1) - odm
    return (src * torch.exp(-closer)).sum(-1)


def _ray_source(modes, omega, beta, traced, which, t):
    """The DO multiple-scatter source per unit optical depth at the
    entrance (``which`` = 0) or exit (1) of every segment, [n, R, S]."""
    R, S = traced.mask.shape
    layer = torch.as_tensor(traced.seg_layer, device=omega.device)
    frac = t(traced.seg_entrance_frac if which == 0 else traced.seg_exit_frac)
    b = np.arange(S) + which
    mu_b = traced.cos_zenith[:, b]
    dphi = np.pi - traced.boundary_relazi[:, b]
    L = beta.shape[-1]
    total = 0.0
    for m, (levels, extra) in enumerate(modes):
        lam = t(extra["lam"])
        wq = t(extra["w"])
        par = t(extra["parity"])

        def stream_sum(ip, im):
            return (torch.einsum("li,npi->npl", lam, ip * wq)
                    + par * torch.einsum("li,npi->npl", lam, im * wq))

        c_top = 0.5 * omega[..., None] * beta * stream_sum(
            levels["i_plus_top"], levels["i_minus_top"])   # [n, P, L]
        c_bot = 0.5 * omega[..., None] * beta * stream_sum(
            levels["i_plus_bot"], levels["i_minus_bot"])
        ang = t(np.moveaxis(normalized_alp(mu_b, m, L), 0, -1)
                * np.cos(m * dphi)[..., None])             # [R, S, L]
        top = c_top[:, layer]                               # [n, R, S, L]
        bot = c_bot[:, layer]
        val = (1.0 - frac)[..., None] * top + frac[..., None] * bot
        total = total + (val * ang).sum(-1)
    return total * t(traced.mask)


def radiance(config, lanes, pressure, temperature, vmr, albedo):
    """Radiance [n, R] of the configuration's rays for ``n`` lanes.
    ``lanes["wavelength_nm"]`` [n]; pressure, temperature, vmr [n, A] and
    albedo [n] tensors; ``lanes["xs_table"]`` the absorber's table."""
    dt, dev = pressure.dtype, pressure.device
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)  # noqa: E731
    g, alts = _geometry(config)
    solver = config["solver"]
    nstr = solver["num_streams"]
    nleg = max(nstr, solver["num_singlescatter_moments"])
    ext, ssa, leg = level_optics(lanes["wavelength_nm"], pressure,
                                 temperature, vmr, lanes["xs_table"], nleg)
    dtau, omega, beta = layer_optics(alts, ext, ssa, leg)
    f0 = torch.ones_like(albedo)
    num_modes = _num_modes(leg)
    rays = config["rays"]
    if g["geometry_type"] == "PlaneParallel":
        mu0 = rays[0]["cos_sza"]
        if any(r["kind"] != "GroundViewingSolar" or r["cos_sza"] != mu0
               for r in rays):
            msg = "the plane-parallel reference takes ground-viewing rays at one solar zenith"
            raise NotImplementedError(msg)
        rad, _, _ = disco.solve(
            dtau, omega, beta, albedo, mu0,
            [r["cos_viewing_zenith"] for r in rays], [True] * len(rays),
            [r["relative_azimuth"] for r in rays], f0,
            include_ss=solver["single_scatter_source"] == "DiscreteOrdinates",
            num_modes=num_modes, nstr=nstr)
        return rad
    if any(r["kind"] != "TangentAltitudeSolar" for r in rays):
        msg = "the spherical reference takes tangent-altitude rays"
        raise NotImplementedError(msg)
    if solver["single_scatter_source"] != "Exact":
        msg = "the spherical reference computes exact single scatter"
        raise NotImplementedError(msg)
    traced, grid, wts = _limb_tables(config, alts)
    rad = _single_scatter(ext, ssa, leg, albedo, traced, t) * f0[:, None]
    S = traced.mask.shape[1]
    j_in = j_out = 0.0
    for i, mu0 in enumerate(grid):
        chap = disco.chapman_matrix(alts, g["earth_radius_m"], float(mu0))
        _, modes, beta_t = disco.solve(
            dtau, omega, beta, albedo, float(mu0), [0.5], [True], [0.0], f0,
            include_ss=False, num_modes=num_modes, chapman=chap, nstr=nstr)
        om = disco.clamp_ssa(omega)
        j_in = j_in + _ray_source(modes, om, beta_t, traced, 0, t) * t(wts[:, :S, i])
        j_out = j_out + _ray_source(modes, om, beta_t, traced, 1, t) * t(wts[:, 1:, i])
    return rad + _integrate(ext, j_in, j_out, traced, t)


WF_NAMES = ("wf_rayleigh_pressure_pa", "wf_rayleigh_temperature_k",
            "wf_absorber", "wf_surface_albedo")


def reference(config, lanes, dtype=torch.float64, device="cpu",
              jacobians=True):
    """{"radiance": [n, R], and with ``jacobians`` each of ``WF_NAMES``:
    [A, n, R] for the level profiles, [n, R] for the albedo} as numpy.

    ``lanes``: wavelength_nm [n], pressure_pa, temperature_k, vmr [n, A],
    albedo [n] (numpy), xs_table."""
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)  # noqa: E731
    leaves = [t(lanes[k]) for k in ("pressure_pa", "temperature_k", "vmr",
                                    "albedo")]
    for leaf in leaves:
        leaf.requires_grad_(jacobians)
    with torch.set_grad_enabled(jacobians):
        rad = radiance(config, lanes, *leaves)
    out = {"radiance": rad.detach().cpu().numpy()}
    if not jacobians:
        return out
    R = rad.shape[1]
    rows = [torch.autograd.grad(rad[:, r].sum(), leaves,
                                retain_graph=r < R - 1) for r in range(R)]
    for j, name in enumerate(WF_NAMES):
        g = torch.stack([row[j] for row in rows], dim=-1)  # [n, (A,) R]
        g = g.detach().cpu().numpy()
        out[name] = g if g.ndim == 2 else np.moveaxis(g, 1, 0)
    return out
