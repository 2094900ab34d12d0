"""Successive-orders-of-scattering multiple scatter source (counterpart of
``sasktran2_tpu/rt/successive.py``): the spherical limb source of the
reference's HR ``DiffuseTable``.

Diffuse points live on the model altitude levels, directions on a
(Gauss-Legendre mu) x (uniform phi) product grid. Every (level,
direction) internal ray is traced once on the host into the padded tables
of ``SOGeometry`` (``build_so_geometry``, a copy of the JAX package's,
pinned bit-equal by the tests); the iteration is a fixed count of

    I <- I_first + transport(J(I)) + ground(I),
    J = omega / (4 pi) sum_l beta_l (G_l @ I).

Layout on the card. The reference's transport gathers a
[W, R, S, 2, 2, 4] tensor at every iteration (R = V D internal rays, S
padded segments): 8 GB per iteration at W = 64, V = 101, D = 100 in f32,
with only about a quarter of the segments real. Here the host compacts
the real segments and their boundaries once per engine
(``TransportPlan``) and writes every static linear map of the field
(segment optical depth, the optical depth between a segment and the
point, the solar optical depth, the level interpolation, the phase
function, the transport stencil, the sum over a ray's segments) as a
sparse CSR matrix, so each is one sparse-times-dense product with the
wavelengths in the dense columns. One transport step is a
``torch.autograd.Function`` that saves only the field and recomputes the
stencil product in its backward pass. The scattering kernel of each
(wavelength, level) is formed once per call (scalar [W, V, D, D],
polarized [W, V, 3D, 3D]) and applied by one batched matrix product per
iteration. The results equal the reference's to rounding: only the order
of the sums differs.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..memo import bounded_memo
from ..ops import _build
from ..ops.quadrature import gauss_legendre
from ..ops.sparse import SparseOp, apply_sparse
from ..ops.wigner import legendre_p
from ..util.torchmath import safe_div
from .raytrace import TracedRays, _solar_at_point, _sun_od_weights


@dataclass
class SOGeometry:
    """Static successive-orders tables (host precompute).

    D = number of directions, V = number of levels, R = V*D internal rays,
    S = max segments.
    """

    mu_d: np.ndarray          # [D] direction cosines (propagation, +up)
    phi_d: np.ndarray         # [D] direction azimuths (relative to sun)
    w_d: np.ndarray           # [D] sphere quadrature weights (sum 4 pi)
    g_l: np.ndarray           # [L, D, D] scattering kernels (w_in included)
    seg_idx: np.ndarray       # [R, S, 2] int level indices for segment OD
    seg_w: np.ndarray         # [R, S, 2] weights: seg_od = sum w * k[idx]
    seg_mask: np.ndarray      # [R, S]
    src_level_idx: np.ndarray  # [R, S, 2, 2] (entrance/exit, 2 levels)
    src_level_w: np.ndarray    # [R, S, 2, 2]
    src_dir_idx: np.ndarray    # [R, S, 2, 4] direction interp indices
    src_dir_w: np.ndarray      # [R, S, 2, 4]
    sun_weights: np.ndarray    # [R, S+1, A] OD-to-sun at boundaries
    cos_scatter: np.ndarray    # [R, S+1] solar scattering cosine
    interp_weights: np.ndarray  # [R, S+1, A] level interp at boundaries
    ground_hit: np.ndarray     # [R]
    ground_cos_sza: np.ndarray  # [R]
    nlev: int
    ndir: int
    # Stokes rotation (scattering plane -> local meridian plane) of the
    # first-order beam source at each internal-ray boundary; identity for
    # scalar runs (used only by the polarized field iteration)
    sun_c2: np.ndarray | None = None   # [R, S+1]
    sun_s2: np.ndarray | None = None


def _direction_grid(n_mu: int, n_phi: int):
    x, w = gauss_legendre(n_mu)
    phi = 2.0 * np.pi * (np.arange(n_phi) + 0.5) / n_phi
    wphi = 2.0 * np.pi / n_phi
    mu_d = np.repeat(x, n_phi)
    phi_d = np.tile(phi, n_mu)
    w_d = np.repeat(w * wphi, n_phi)
    return mu_d, phi_d, w_d


def build_so_geometry(
    altitude_grid_m: np.ndarray,
    earth_radius_m: float,
    cos_sza: float,
    nleg: int,
    n_mu: int = 8,
    n_phi: int = 8,
    refractive_index=None,
    ms_refraction: bool = False,
) -> SOGeometry:
    alts = np.asarray(altitude_grid_m, dtype=np.float64)
    radii = earth_radius_m + alts
    A = len(alts)

    integ = None
    if ms_refraction:
        from .refraction import RefractiveShellIntegrator

        integ = RefractiveShellIntegrator(radii, refractive_index)
    mu_d, phi_d, w_d = _direction_grid(n_mu, n_phi)
    D = len(mu_d)

    # scattering kernels: cos Theta between direction pairs
    smu = np.sqrt(np.maximum(1.0 - mu_d**2, 0.0))
    cos_t = (
        mu_d[:, None] * mu_d[None, :]
        + smu[:, None] * smu[None, :] * np.cos(phi_d[:, None] - phi_d[None, :])
    )
    pl = legendre_p(cos_t, nleg)  # [L, D, D]
    g_l = pl * w_d[None, None, :]

    R = A * D
    S = 2 * (A - 1)
    seg_idx = np.zeros((R, S, 2), dtype=np.int32)
    seg_w = np.zeros((R, S, 2))
    seg_mask = np.zeros((R, S))
    src_level_idx = np.zeros((R, S, 2, 2), dtype=np.int32)
    src_level_w = np.zeros((R, S, 2, 2))
    src_dir_idx = np.zeros((R, S, 2, 4), dtype=np.int32)
    src_dir_w = np.zeros((R, S, 2, 4))
    sun_w = np.zeros((R, S + 1, A))
    cos_scat = np.zeros((R, S + 1))
    interp_w = np.zeros((R, S + 1, A))
    ground_hit = np.zeros(R, dtype=bool)
    g_cs = np.zeros(R)
    sun_c2 = np.ones((R, S + 1))
    sun_s2 = np.zeros((R, S + 1))

    from .raytrace import _stokes_rotation

    def _sun_rot(cz, cs, relazi):
        szn = np.sqrt(max(1.0 - cz * cz, 0.0))
        sss = np.sqrt(max(1.0 - cs * cs, 0.0))
        d_hat = np.array([szn, 0.0, cz])
        sun_hat = np.array(
            [sss * np.cos(relazi), sss * np.sin(relazi), cs]
        )
        return _stokes_rotation(d_hat, sun_hat)

    sun_s = np.sqrt(max(1.0 - cos_sza**2, 0.0))
    sun_vec = np.array([sun_s, 0.0, cos_sza])

    def dir_interp(mu, phi):
        """4-point bilinear interpolation weights onto the direction grid."""
        xs = np.unique(mu_d)  # sorted gauss nodes
        phis = np.unique(phi_d)
        i = np.clip(np.searchsorted(xs, mu) - 1, 0, len(xs) - 2)
        f = np.clip((mu - xs[i]) / (xs[i + 1] - xs[i]), 0.0, 1.0)
        dphi = 2.0 * np.pi / len(phis)
        phi = phi % (2.0 * np.pi)
        j = int(np.floor((phi - phis[0]) / dphi)) % len(phis)
        j2 = (j + 1) % len(phis)
        g = ((phi - phis[j]) % (2.0 * np.pi)) / dphi
        g = np.clip(g, 0.0, 1.0)

        def didx(ii, jj):
            return ii * len(phis) + jj

        idx = [didx(i, j), didx(i, j2), didx(i + 1, j), didx(i + 1, j2)]
        wt = [(1 - f) * (1 - g), (1 - f) * g, f * (1 - g), f * g]
        return np.array(idx, dtype=np.int32), np.array(wt)

    for vi in range(A):
        r0 = radii[vi]
        for di in range(D):
            ri = vi * D + di
            mu = mu_d[di]
            phi = phi_d[di]
            if integ is not None:
                path = _upstream_path_refracted(r0, mu, radii, integ)
                blist_r = path["bounds"]
                czs_r = path["cz"]
                phis_e = path["phi_e"]
                nseg_r = len(blist_r) - 1
                ground_hit[ri] = path["ground"]
                sun_vec_r = sun_vec_local(phi, cos_sza)
                for s in range(nseg_r):
                    jlev = path["jlev"][s]
                    seg_idx[ri, s] = (jlev, jlev + 1)
                    seg_w[ri, s] = (path["w_lo"][s], path["w_hi"][s])
                    seg_mask[ri, s] = 1.0
                    for ei in (0, 1):
                        rr = blist_r[s + ei]
                        jl = int(np.clip(
                            np.searchsorted(radii, rr) - 1, 0, A - 2
                        ))
                        fl = np.clip(
                            (rr - radii[jl]) / (radii[jl + 1] - radii[jl]),
                            0.0, 1.0,
                        )
                        src_level_idx[ri, s, ei] = (jl, jl + 1)
                        src_level_w[ri, s, ei] = (1 - fl, fl)
                        idx4, w4 = dir_interp(czs_r[s + ei], phi)
                        src_dir_idx[ri, s, ei] = idx4
                        src_dir_w[ri, s, ei] = w4
                for b in range(nseg_r + 1):
                    rr = blist_r[b]
                    cz = czs_r[b]
                    cs, relazi = _solar_at_plane_point(
                        phis_e[b], cz, sun_vec_r
                    )
                    sun_w[ri, b] = integ.sun_od_weights(
                        rr, cs, earth_radius_m
                    )
                    szn = np.sqrt(max(1.0 - cz * cz, 0.0))
                    sss = np.sqrt(max(1.0 - cs * cs, 0.0))
                    cos_scat[ri, b] = -cz * cs - szn * sss * np.cos(relazi)
                    sun_c2[ri, b], sun_s2[ri, b] = _sun_rot(cz, cs, relazi)
                    jl = int(np.clip(
                        np.searchsorted(radii, rr) - 1, 0, A - 2
                    ))
                    fl = np.clip(
                        (rr - radii[jl]) / (radii[jl + 1] - radii[jl]),
                        0.0, 1.0,
                    )
                    interp_w[ri, b, jl] = 1 - fl
                    interp_w[ri, b, jl + 1] = fl
                g_cs[ri] = cos_sza if path["ground"] else 0.0
                continue
            # incoming ray: photons travel along (mu, phi) ARRIVING at the
            # point; trace backwards (upstream) to the far end.
            # Upstream direction has cosine -mu. The ray's tangent radius:
            sinz = np.sqrt(max(1.0 - mu * mu, 0.0))
            rt = r0 * sinz
            segs = _upstream_segments(r0, mu, radii, rt)
            ground_hit[ri] = segs["ground"]
            # boundaries: from far end toward the point (matching the LOS
            # integrator convention far -> near)
            blist = segs["bounds"][::-1]  # far-first
            ldists = segs["ldist"][::-1]
            nseg = len(blist) - 1
            for s in range(nseg):
                r_far, r_near = blist[s], blist[s + 1]
                seg_len = abs(ldists[s] - ldists[s + 1])
                rm = 0.5 * (r_far + r_near)
                jlev = int(np.clip(np.searchsorted(radii, rm) - 1, 0, A - 2))
                fr = np.clip((rm - radii[jlev]) / (radii[jlev + 1] - radii[jlev]),
                             0.0, 1.0)
                seg_idx[ri, s] = (jlev, jlev + 1)
                seg_w[ri, s] = ((1 - fr) * seg_len, fr * seg_len)
                seg_mask[ri, s] = 1.0
                # source evaluation at entrance/exit boundaries
                for ei, rr in enumerate((r_far, r_near)):
                    jl = int(np.clip(np.searchsorted(radii, rr) - 1, 0, A - 2))
                    fl = np.clip((rr - radii[jl]) / (radii[jl + 1] - radii[jl]),
                                 0.0, 1.0)
                    src_level_idx[ri, s, ei] = (jl, jl + 1)
                    src_level_w[ri, s, ei] = (1 - fl, fl)
                    # local propagation direction at rr (toward the point)
                    sdist = ldists[s + ei]
                    cs, cz, relazi, _ = _solar_at_point(
                        sdist, r0, mu, sun_vec_local(phi, cos_sza)
                    )
                    # direction in the grid frame: (cz, azimuth)
                    az = _azimuth_at_point(sdist, r0, mu, phi)
                    idx4, w4 = dir_interp(cz, az)
                    src_dir_idx[ri, s, ei] = idx4
                    src_dir_w[ri, s, ei] = w4
            # boundaries solar data for first-order scattering
            for b in range(nseg + 1):
                rr = blist[b]
                sdist = ldists[b]
                cs, cz, relazi, _ = _solar_at_point(
                    sdist, r0, mu, sun_vec_local(phi, cos_sza)
                )
                sun_w[ri, b] = _sun_od_weights(rr, cs, radii, earth_radius_m)
                szn = np.sqrt(max(1.0 - cz * cz, 0.0))
                sss = np.sqrt(max(1.0 - cs * cs, 0.0))
                cos_scat[ri, b] = -cz * cs - szn * sss * np.cos(relazi)
                sun_c2[ri, b], sun_s2[ri, b] = _sun_rot(cz, cs, relazi)
                jl = int(np.clip(np.searchsorted(radii, rr) - 1, 0, A - 2))
                fl = np.clip((rr - radii[jl]) / (radii[jl + 1] - radii[jl]),
                             0.0, 1.0)
                interp_w[ri, b, jl] = 1 - fl
                interp_w[ri, b, jl + 1] = fl
            g_cs[ri] = cos_sza if segs["ground"] else 0.0

    return SOGeometry(
        mu_d=mu_d, phi_d=phi_d, w_d=w_d, g_l=g_l,
        seg_idx=seg_idx, seg_w=seg_w, seg_mask=seg_mask,
        src_level_idx=src_level_idx, src_level_w=src_level_w,
        src_dir_idx=src_dir_idx, src_dir_w=src_dir_w,
        sun_weights=sun_w, cos_scatter=cos_scat, interp_weights=interp_w,
        ground_hit=ground_hit, ground_cos_sza=g_cs,
        nlev=A, ndir=D,
        sun_c2=sun_c2, sun_s2=sun_s2,
    )


def sun_vec_local(phi_dir, cos_sza):
    """Sun unit vector in a frame where the direction's horizontal azimuth
    is x and up is z: the sun sits at azimuth -phi_dir (the direction grid's
    phi is measured from the solar azimuth)."""
    ss = np.sqrt(max(1.0 - cos_sza**2, 0.0))
    return np.array([ss * np.cos(phi_dir), -ss * np.sin(phi_dir), cos_sza])


def _azimuth_at_point(sdist, r_ref, coszen_ref, phi_ref):
    """Azimuth (relative to the sun meridian) of the propagation direction
    at distance sdist along a straight ray whose azimuth at the reference
    point is phi_ref. In the great-circle plane of a straight ray the
    horizontal azimuth is constant relative to the sun meridian only in the
    plane approximation; for the 1D model we keep phi constant (the
    reference's diffuse-point model makes the same 1D assumption)."""
    return phi_ref


def _solar_at_plane_point(phi_e, cz_loc, sun_vec):
    """(cos_sza, relazi) at a point of the ray plane at earth angle
    ``phi_e`` from the reference point (positive along the propagation
    azimuth) where the propagation direction has local zenith cosine
    ``cz_loc``. Mirrors ``raytrace._solar_at_point`` with the position
    supplied as an angle instead of a straight-line distance (refracted
    rays bend, but stay in their plane by spherical symmetry)."""
    r_hat = np.array([np.sin(phi_e), 0.0, np.cos(phi_e)])
    t_hat = np.array([np.cos(phi_e), 0.0, -np.sin(phi_e)])
    sz = np.sqrt(max(1.0 - cz_loc * cz_loc, 0.0))
    p_hat = sz * t_hat + cz_loc * r_hat
    cs = float(np.dot(sun_vec, r_hat))
    ss = np.sqrt(max(1.0 - cs * cs, 0.0))
    if sz * ss < 1e-12:
        return cs, 0.0
    h_hat = (p_hat - cz_loc * r_hat) / sz
    y_hat = np.cross(r_hat, h_hat)
    relazi = float(
        np.arctan2(np.dot(sun_vec, y_hat), np.dot(sun_vec, h_hat))
    )
    return cs, relazi


def _upstream_path_refracted(r0, mu, radii, integ):
    """Curved upstream path of a photon ARRIVING at radius r0 with
    propagation cosine mu (+up), traced with refraction (Bouguer invariant
    n r sin z = const; reference traces HR incoming rays with the refracted
    tracer when ``multiple_scatter_refraction`` is set,
    ``diffuse_table.cpp:250``).

    Returns dict with far-first arrays: ``bounds`` radii, ``cz`` signed
    local propagation cosines, ``phi_e`` earth angles relative to the point
    (non-positive upstream), per-segment shell index ``jlev`` and exact
    linear-in-radius OD weights ``(w_lo, w_hi)``, and ``ground``.
    """
    A = len(radii)
    eps = 1e-6
    sinz = np.sqrt(max(1.0 - mu * mu, 0.0))
    invariant = integ.n_at(r0) * r0 * sinz
    rt = integ.tangent_radius(invariant)
    nt = integ.n_at(rt)

    def cz_at(rr, sign):
        s = min(invariant / (integ.n_at(rr) * rr), 1.0)
        return sign * np.sqrt(max(1.0 - s * s, 0.0))

    # Backward traversal from the point: (radius, cz sign) lists
    bounds = [r0]
    signs = [1.0 if mu > 0.0 else -1.0]
    ground = False
    if mu <= 0.0:
        # photon descends; upstream ascends to TOA (cz < 0 throughout)
        for j in range(A):
            if radii[j] > r0 + eps:
                bounds.append(radii[j])
                signs.append(-1.0)
    else:
        ground = rt <= radii[0] + eps
        for j in range(A - 1, -1, -1):
            if radii[j] < r0 - eps and radii[j] > rt + eps:
                bounds.append(radii[j])
                signs.append(1.0)
        if ground:
            if not np.isclose(bounds[-1], radii[0]):
                bounds.append(radii[0])
                signs.append(1.0)
        else:
            # tangent pass: descend to rt then (backwards) out to TOA
            bounds.append(rt)
            signs.append(0.0)
            for j in range(A):
                if radii[j] > rt + eps:
                    bounds.append(radii[j])
                    signs.append(-1.0)

    # per-gap curved integrals (backward traversal -> negative phi/arc)
    n_b = len(bounds)
    phi_e = [0.0]
    jlevs, wlos, whis = [], [], []
    for i in range(n_b - 1):
        ra, rb = bounds[i], bounds[i + 1]
        rm = 0.5 * (ra + rb)
        jlev = int(np.clip(np.searchsorted(radii, rm) - 1, 0, A - 2))
        _, w_lo, w_hi, dphi = integ.shell_integral(
            rt, nt, ra, rb, radii[jlev], radii[jlev + 1]
        )
        jlevs.append(jlev)
        wlos.append(w_lo)
        whis.append(w_hi)
        phi_e.append(phi_e[-1] - dphi)

    czs = [cz_at(rr, sg) for rr, sg in zip(bounds, signs)]
    # reverse to far-first (matching the straight-ray build's convention)
    return {
        "bounds": bounds[::-1],
        "cz": czs[::-1],
        "phi_e": phi_e[::-1],
        "jlev": jlevs[::-1],
        "w_lo": wlos[::-1],
        "w_hi": whis[::-1],
        "ground": ground,
    }


def _upstream_segments(r0, mu, radii, rt):
    """Boundary radii and signed arc distances along the upstream path of a
    photon ARRIVING at radius r0 with propagation cosine mu (+up).

    Returns dict(bounds=[point..far], ldist=[signed distances], ground).
    Distances measured along the propagation direction (the point is 0; the
    far end is negative).
    """
    A = len(radii)
    eps = 1e-6
    bounds = [r0]
    ldist = [0.0]

    def l_of(r):
        return np.sqrt(max(r * r - rt * rt, 0.0))

    if mu <= 0.0:
        # photon travels downward; upstream is upward: r increasing to TOA
        for j in range(A):
            if radii[j] > r0 + eps:
                bounds.append(radii[j])
                ldist.append(-(l_of(radii[j]) - l_of(r0)))
        return {"bounds": bounds, "ldist": ldist, "ground": False}
    # photon travels upward; upstream descends
    ground = rt <= radii[0] + eps
    below = [radii[j] for j in range(A - 1, -1, -1)
             if radii[j] < r0 - eps and radii[j] > rt + eps]
    for rr in below:
        bounds.append(rr)
        ldist.append(-(l_of(r0) - l_of(rr)))
    if ground:
        if not np.isclose(bounds[-1], radii[0]):
            bounds.append(radii[0])
            ldist.append(-(l_of(r0) - l_of(radii[0])))
        return {"bounds": bounds, "ldist": ldist, "ground": True}
    # tangent pass: descend to rt then ascend to TOA
    bounds.append(rt)
    ldist.append(-l_of(r0))
    for j in range(A):
        if radii[j] > rt + eps:
            bounds.append(radii[j])
            ldist.append(-(l_of(r0) + l_of(radii[j])))
    return {"bounds": bounds, "ldist": ldist, "ground": False}


# the geometries of the last few distinct argument sets, most recent last:
# each holds two [R, S+1, A] float64 tables (1.6 GB each at 101 altitudes
# and 100 directions), and an engine of a new solar zenith angle (one per
# scan in a limb retrieval) makes a new geometry
_GEOMETRY_CACHE: OrderedDict = OrderedDict()
GEOMETRY_CACHE_SIZE = 4


def so_geometry(
    altitude_grid_m: np.ndarray,
    earth_radius_m: float,
    cos_sza: float,
    nleg: int,
    n_mu: int = 8,
    n_phi: int = 8,
    refractive_index=None,
    ms_refraction: bool = False,
) -> SOGeometry:
    """``build_so_geometry``, memoised within the process on its arguments
    (the altitude grid's and the refractive index's bytes, the earth
    radius, ``cos_sza``, ``nleg``, ``n_mu``, ``n_phi`` and the refraction
    flag), so that engines of one geometry in different dtypes share one
    host build. The build's Python loops over every internal ray take
    minutes at 101 altitudes and 100 directions. The memo keeps the
    ``GEOMETRY_CACHE_SIZE`` most recently used geometries."""
    alts = np.ascontiguousarray(altitude_grid_m, dtype=np.float64)
    n_bytes = (
        None if refractive_index is None
        else np.ascontiguousarray(refractive_index, dtype=np.float64).tobytes()
    )
    key = (
        alts.tobytes(), float(earth_radius_m), float(cos_sza), int(nleg),
        int(n_mu), int(n_phi), bool(ms_refraction), n_bytes,
    )
    return bounded_memo(
        _GEOMETRY_CACHE, key,
        lambda: build_so_geometry(
            altitude_grid_m, earth_radius_m, cos_sza, nleg, n_mu=n_mu,
            n_phi=n_phi, refractive_index=refractive_index,
            ms_refraction=ms_refraction,
        ),
        GEOMETRY_CACHE_SIZE,
    )


# ---------------------------------------------------------------------------
# Compact transport plan (host) and its sparse operators (device)
# ---------------------------------------------------------------------------


class _Transport(torch.autograd.Function):
    """One transport step: out = raysum @ (C * (stencil @ J)).

    J [R, n W] holds the source of n Stokes components at every internal
    ray's point, C [nseg, W] the segment factors (1 - e^-od) e^-closer of
    each real segment, shared by the components. The step is linear in
    J, so the backward pass saves J (a few MB) instead of the
    [nseg, n W] stencil product, which it recomputes for C's gradient."""

    @staticmethod
    def forward(ctx, j, c, stencil, raysum, seg_ray):
        nseg, w = c.shape
        g = stencil.m @ j.contiguous()
        p = (g.view(nseg, -1, w) * c[:, None, :]).view(nseg, -1)
        ctx.save_for_backward(j, c)
        ctx.stencil, ctx.seg_ray = stencil, seg_ray
        return raysum.m @ p

    @staticmethod
    def backward(ctx, grad):
        j, c = ctx.saved_tensors
        nseg, w = c.shape
        gp = grad.index_select(0, ctx.seg_ray).view(nseg, -1, w)
        grad_j = grad_c = None
        if ctx.needs_input_grad[0]:
            grad_j = ctx.stencil.mt @ (gp * c[:, None, :]).view(nseg, -1)
        if ctx.needs_input_grad[1]:
            g = (ctx.stencil.m @ j.contiguous()).view(nseg, -1, w)
            grad_c = (gp * g).sum(1)
        return grad_j, grad_c, None, None, None


class TransportPlan:
    """The real segments of an ``SOGeometry``'s internal rays, compacted,
    and the field's static operators on one device in one dtype.

    Segment k is segment ``seg_s[k]`` of ray ``seg_ray[k]``, rays in
    order, the segments of a ray contiguous and far end first. Every ray
    with n segments owns n + 1 boundaries (a ray with none keeps its
    point, boundary 0, for the ground term); segment k runs from boundary
    ``seg_lo[k]`` to ``seg_lo[k] + 1``. The padded segments of the
    geometry carry zero weights in every table, so leaving them out
    changes no sum.

    The constructor builds every sparse operator on the host in float64
    and moves it, with the constants of the iteration, to ``device`` in
    ``dtype``: the maps od, closer, raysum, sun, interp and stencil, and
    the first-order phase function, scalar (``pt``, Legendre) or, given
    the polarized tables ``pol_tabs`` (``build_so_polarized_tables``),
    polarized (``b00``, ``b02``) with that field's kernel tables. An
    engine builds its plans once; the fields take them as they are.
    """

    def __init__(self, geom: SOGeometry, device, dtype, pol_tabs=None):
        mask = geom.seg_mask > 0
        R, S = mask.shape
        n_r = mask.sum(axis=1)
        if not np.array_equal(mask, np.arange(S)[None, :] < n_r[:, None]):
            msg = "internal-ray segments must be a prefix of the padded axis"
            raise ValueError(msg)
        self.geom, self.device, self.dtype = geom, device, dtype
        # V (levels of the field) is the altitude grid's size
        self.R, self.V, self.D = R, geom.nlev, geom.ndir
        self.nleg = geom.g_l.shape[0]
        seg_ray, seg_s = np.nonzero(mask)
        b_start = np.concatenate([[0], np.cumsum(n_r + 1)[:-1]])
        nb = int(np.sum(n_r + 1))
        bnd_ray = np.repeat(np.arange(R), n_r + 1)
        self._bnd_b = np.arange(nb) - b_start[bnd_ray]
        self._bnd_ray, self._n_r = bnd_ray, n_r
        self.nseg, self.nb = len(seg_ray), nb
        self.seg_ray, self.seg_s = seg_ray, seg_s
        self.seg_lo = b_start[seg_ray] + seg_s

        ops = ["od", "closer", "raysum", "sun", "interp", "stencil"]
        self.ops = {name: self._op(self._entries(name)) for name in ops}
        index = {"seg_ray": seg_ray, "seg_lo": self.seg_lo, "b0": b_start}
        self.index = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                      for k, v in index.items()}
        self.consts = {k: self._const(v) for k, v in {
            "ground_mu0": geom.ground_hit * np.maximum(geom.ground_cos_sza,
                                                       0.0),
            "f_dn_w": geom.w_d * np.abs(geom.mu_d) * (geom.mu_d < 0.0),
            "ground_hit": geom.ground_hit,
        }.items()}
        if pol_tabs is None:
            pt = np.moveaxis(legendre_p(geom.cos_scatter, self.nleg), 0, -1)
            self.ops["pt"] = self._op(self._phase_entries(pt))  # [R,S+1,L]
            self.consts["g_l"] = self._const(geom.g_l)          # [L, D, D]
            return
        for name in ("b00", "b02"):
            self.ops[name] = self._op(
                self._phase_entries(pol_tabs[name][..., :self.nleg]))
        # the quadrature weight of the incoming direction folded into the
        # kernel's basis tables [L, Do, Di]
        for name in ("t00", "t02", "t22", "t2m2"):
            self.consts[name] = self._const(
                pol_tabs[name][:self.nleg] * geom.w_d[None, None, :])
        for name in ("c2i", "s2i", "c2o", "s2o"):
            self.consts[name] = self._const(pol_tabs[name])     # [Do, Di]
        self.consts["sun_c2"] = self._const(self.boundary(geom.sun_c2))
        self.consts["sun_s2"] = self._const(self.boundary(geom.sun_s2))

    def boundary(self, table):
        """A padded [R, S+1, ...] table at the compact boundaries."""
        return np.asarray(table)[self._bnd_ray, self._bnd_b]

    def _const(self, arr):
        return torch.as_tensor(np.asarray(arr), dtype=self.dtype,
                               device=self.device)

    def _op(self, entries):
        return SparseOp(*entries, self.device, self.dtype)

    def _entries(self, name):
        geom, nseg, A = self.geom, self.nseg, self.V
        seg = np.arange(nseg)
        if name == "od":
            idx = geom.seg_idx[self.seg_ray, self.seg_s]       # [nseg, 2]
            w = geom.seg_w[self.seg_ray, self.seg_s]
            return np.repeat(seg, 2), idx, w, (nseg, A)
        if name == "closer":
            # the optical depth between a segment and the ray's point: the
            # later segments of the same ray
            rows, cols = [], []
            seg_start = np.concatenate([[0], np.cumsum(self._n_r)[:-1]])
            for n in np.unique(self._n_r):
                if n < 2:
                    continue
                iu, ju = np.triu_indices(int(n), 1)
                s0 = seg_start[self._n_r == n][:, None]
                rows.append((s0 + iu).ravel())
                cols.append((s0 + ju).ravel())
            rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
            cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
            return rows, cols, np.ones(len(rows)), (nseg, nseg)
        if name == "raysum":
            return self.seg_ray, seg, np.ones(nseg), (self.R, nseg)
        if name in ("sun", "interp"):
            tab = geom.sun_weights if name == "sun" else geom.interp_weights
            dense = self.boundary(tab)                          # [nb, A]
            rows, cols = np.nonzero(dense)
            return rows, cols, dense[rows, cols], (self.nb, A)
        # the transport stencil
        D = self.D
        sli = geom.src_level_idx[self.seg_ray, self.seg_s]      # [nseg, 2, 2]
        slw = geom.src_level_w[self.seg_ray, self.seg_s]
        sdi = geom.src_dir_idx[self.seg_ray, self.seg_s]        # [nseg, 2, 4]
        sdw = geom.src_dir_w[self.seg_ray, self.seg_s]
        cols = sli[..., :, None] * D + sdi[..., None, :]        # [nseg,2,2,4]
        vals = 0.5 * slw[..., :, None] * sdw[..., None, :]
        return np.repeat(seg, 16), cols, vals, (nseg, self.R)

    def _phase_entries(self, table):
        """A phase-function table at the boundaries [nb, L] contracted
        with the level-interpolated greek coefficients: [nb, A L]."""
        tab = self.boundary(table)                              # [nb, L]
        L = tab.shape[-1]
        r, a, v = self._entries("interp")[:3]
        rows = np.repeat(r, L)
        cols = (a[:, None] * L + np.arange(L)[None, :]).ravel()
        vals = (v[:, None] * tab[r]).ravel()
        return rows, cols, vals, (self.nb, self.V * L)

    def apply(self, name, x):
        """The operator ``name`` times x [K, N]."""
        return apply_sparse(x, self.ops[name])


def _check_nleg(plan: TransportPlan, leg):
    if leg.shape[-1] != plan.nleg:
        msg = (f"{leg.shape[-1]} Legendre moments for a geometry built with "
               f"nleg = {plan.nleg}")
        raise ValueError(msg)


def _ray_terms(plan: TransportPlan, extinction, ssa):
    """The per-wavelength segment and boundary quantities shared by the
    scalar and polarized fields, wavelength-minor: segment optical depth
    ``od``, ``trans`` (e^-closer) and ``factor`` (1 - e^-od) [nseg, W];
    the solar transmission ``t_sun``, the interpolated extinction ``k_b``
    and scattering extinction ``kscat_b`` [nb, W]; each ray's optical
    depth ``total_od`` [R, W]; and ``kscat`` [W, A]."""
    k_t = extinction.transpose(0, 1)
    od = plan.apply("od", k_t)
    closer = plan.apply("closer", od)
    sun_od = plan.apply("sun", k_t)
    kscat = extinction * ssa
    return {
        "od": od,
        "trans": torch.exp(-closer),
        "factor": -torch.expm1(-od),
        "t_sun": torch.exp(-torch.clamp(sun_od, max=300.0)),
        "kscat": kscat,
        "kscat_b": plan.apply("interp", kscat.transpose(0, 1)),
        "k_b": plan.apply("interp", k_t),
        "total_od": plan.apply("raysum", od),
    }


def _ground_beam(plan, terms, albedo):
    """Lambertian reflection of the direct beam at the far end of every
    ground-hitting internal ray, attenuated along it: [R, W]."""
    t_sun_g = terms["t_sun"].index_select(0, plan.index["b0"])
    return (plan.consts["ground_mu0"][:, None] * albedo[None, :] * t_sun_g
            / math.pi * torch.exp(-terms["total_od"]))


def _diffuse_ground(plan, terms):
    """The diffuse (Lambertian) ground term of the iteration: the
    downwelling flux at the bottom level reflected isotropically up every
    ground-hitting internal ray (reference DiffuseTable ground sphere,
    ``diffuse_table.cpp:521``). Returns (f_dn_w [D], ground_t [R, W])."""
    return (plan.consts["f_dn_w"],
            plan.consts["ground_hit"][:, None]
            * torch.exp(-terms["total_od"]))


def transport_step(plan: TransportPlan, j, c):
    """One transport of the source J [R, n W] with segment factors
    C [nseg, W]: [R, n W]. ``transport_step.calls`` counts the steps
    (forward passes)."""
    with _build.COUNT_LOCK:
        transport_step.calls += 1
    return _Transport.apply(j, c, plan.ops["stencil"], plan.ops["raysum"],
                            plan.index["seg_ray"])


transport_step.calls = 0


def successive_orders_field(
    extinction, ssa, leg_coeff, albedo, plan: TransportPlan, iterations: int,
    j_init=None,
):
    """Iterate the scalar scattering field of a wavelength batch on a
    scalar ``TransportPlan`` of the geometry.

    extinction/ssa [W, A], leg_coeff [W, A, L] (L the geometry's nleg),
    albedo [W]. Returns the
    diffuse plus direct-scatter radiance field I [W, V, D], its source J
    [W, V, D] and the diffuse ground-leaving radiance [W]
    (``sasktran2_tpu/rt/successive.py:459``).

    ``j_init`` (optional, [W, V, D]): the multiple-scatter-only source per
    unit optical depth that seeds the field before the first iteration,
    the DO-initialisation mode (reference ``initialize_hr_with_do``,
    ``diffuse_table.cpp:739-760``: one transport precedes the
    iteration)."""
    V, D, R, L = plan.V, plan.D, plan.R, plan.nleg
    W = extinction.shape[0]
    _check_nleg(plan, leg_coeff)
    terms = _ray_terms(plan, extinction, ssa)
    trans, factor, kscat = terms["trans"], terms["factor"], terms["kscat"]
    kscat_b = terms["kscat_b"]

    # first order (single scatter + ground direct) along internal rays
    legk = (leg_coeff * kscat[..., None]).permute(1, 2, 0).reshape(V * L, W)
    phase_b = safe_div(plan.apply("pt", legk), kscat_b)
    j_ss_b = safe_div(
        kscat_b * phase_b / (4.0 * math.pi) * terms["t_sun"], terms["k_b"]
    )
    lo = plan.index["seg_lo"]
    seg_src = factor * 0.5 * (j_ss_b.index_select(0, lo)
                              + j_ss_b.index_select(0, lo + 1))
    i_first = plan.apply("raysum", seg_src * trans)
    i_first = i_first + _ground_beam(plan, terms, albedo)     # [R, W]

    # scattering kernel of every (wavelength, level):
    # omega / (4 pi) sum_l beta_l G_l  [W, V, D, D]
    kern = torch.einsum(
        "wvl,ldi->wvdi", leg_coeff * (ssa / (4.0 * math.pi))[..., None],
        plan.consts["g_l"],
    )

    def scattering_source(i_t):
        # one matrix product per (wavelength, level) with the kernel as it
        # lies: an einsum would permute and copy the kernel at every
        # iteration, and autograd would keep each copy
        i = i_t.view(V, D, W).permute(2, 0, 1).unsqueeze(-1)   # [W, V, D, 1]
        j = torch.matmul(kern, i)
        return j.squeeze(-1).permute(1, 2, 0).reshape(R, W)

    c = factor * trans
    f_dn_w, ground_t = _diffuse_ground(plan, terms)

    def ground_diffuse(i_t):
        f_dn = f_dn_w @ i_t[:D]
        return (albedo * f_dn / math.pi)[None, :] * ground_t

    i_t = i_first
    if j_init is not None:
        j0 = j_init.permute(1, 2, 0).reshape(R, W)
        i_t = i_first + transport_step(plan, j0, c) + ground_diffuse(i_first)
    for _ in range(iterations):
        i_t = (i_first + transport_step(plan, scattering_source(i_t), c)
               + ground_diffuse(i_t))
    j_t = scattering_source(i_t)
    i_ground = albedo * (f_dn_w @ i_t[:D]) / math.pi

    def leading(x):
        return x.view(V, D, W).permute(2, 0, 1)

    return leading(i_t), leading(j_t), i_ground


# ---------------------------------------------------------------------------
# Polarized (NSTOKES=3) successive orders (host tables copied from the JAX
# package; see its module note on the componentwise Stokes interpolation)
# ---------------------------------------------------------------------------


def build_so_polarized_tables(geom: SOGeometry, nleg: int) -> dict:
    """Static pairwise tables for the polarized scattering kernel.

    Z(d <- d') = R_out(d', d) F(Theta) R_in(d', d)^T with
    F11 = sum a1 d^l_00, F12 = F21 = -sum b1 d^l_02,
    F22/F33 = 1/2 sum (a2+a3) d^l_22 +- (a2-a3) d^l_2-2  (I, Q, U block;
    reference polarization types, ``sktran_do_polarization_types.h``).
    """
    from ..ops.wigner import wigner_d
    from .raytrace import _stokes_rotation

    mu_d, phi_d = geom.mu_d, geom.phi_d
    D = len(mu_d)
    s_d = np.sqrt(np.maximum(1.0 - mu_d**2, 0.0))
    dvec = np.stack(
        [s_d * np.cos(phi_d), s_d * np.sin(phi_d), mu_d], axis=-1
    )  # [D, 3]

    cos_t = np.clip(dvec @ dvec.T, -1.0, 1.0)  # [D_out, D_in]... (in, out)?
    # dvec[i] . dvec[j]: symmetric, orientation irrelevant for Theta
    theta = np.arccos(cos_t)
    t00 = wigner_d(theta, 0, 0, nleg)    # [L, D, D]
    t02 = wigner_d(theta, 0, 2, nleg)
    t22 = wigner_d(theta, 2, 2, nleg)
    t2m2 = wigner_d(theta, 2, -2, nleg)

    c2o = np.ones((D, D))
    s2o = np.zeros((D, D))
    c2i = np.ones((D, D))
    s2i = np.zeros((D, D))
    z = np.array([0.0, 0.0, 1.0])
    for di in range(D):        # incoming direction (propagation)
        for do in range(D):    # outgoing direction
            u_in = dvec[di]
            d_out = dvec[do]
            # outgoing: scattering plane -> meridian(d_out), about d_out
            c2o[do, di], s2o[do, di] = _stokes_rotation(d_out, -u_in)
            # incoming: scattering plane -> meridian(d_in), about d_in;
            # the transpose (applied in the kernel) takes meridian ->
            # scattering. Scattering-plane normal is the same plane:
            n1 = np.cross(u_in, d_out)
            n2 = np.cross(z, u_in)
            s1n = np.linalg.norm(n1)
            s2n = np.linalg.norm(n2)
            if s1n < 1e-10 or s2n < 1e-10:
                continue
            n1 = n1 / s1n
            n2 = n2 / s2n
            c = float(np.dot(n1, n2))
            s = float(np.dot(np.cross(n1, n2), u_in))
            c2i[do, di] = c * c - s * s
            s2i[do, di] = -2.0 * s * c

    # first-order beam basis functions at the internal-ray boundaries
    theta_b = np.arccos(np.clip(geom.cos_scatter, -1.0, 1.0))
    b00 = wigner_d(theta_b, 0, 0, nleg)   # [L, R, S+1]
    b02 = wigner_d(theta_b, 0, 2, nleg)

    return {
        "t00": t00, "t02": t02, "t22": t22, "t2m2": t2m2,
        "c2o": c2o, "s2o": s2o, "c2i": c2i, "s2i": s2i,
        "b00": np.moveaxis(b00, 0, -1),   # [R, S+1, L]
        "b02": np.moveaxis(b02, 0, -1),
    }


def successive_orders_field_polarized(
    extinction, ssa, legs, albedo, plan: TransportPlan, iterations: int,
):
    """Polarized fixed-point iteration of a wavelength batch on a
    polarized ``TransportPlan`` (``sasktran2_tpu/rt/successive.py:669``).
    ``legs`` = (a1, a2, a3, b1), each [W, A, L]. Returns (I [W, V, D, 3], J [W, V, D, 3], i_ground [W]).

    The same transport as the scalar field, component by component (the
    reference's componentwise Stokes interpolation); the scattering step
    applies the rotated phase matrix, formed once per call as one
    [3D, 3D] kernel per (wavelength, level), and the first-order beam
    source carries its (Q, U) through the per-boundary scattering-plane
    rotations."""
    a1, a2, a3, b1 = legs
    V, D, R, nleg = plan.V, plan.D, plan.R, plan.nleg
    W = extinction.shape[0]
    _check_nleg(plan, a1)
    terms = _ray_terms(plan, extinction, ssa)
    trans, factor, kscat = terms["trans"], terms["factor"], terms["kscat"]
    kscat_b = terms["kscat_b"]

    # ---- first order: polarized beam scatter at boundaries -------------
    def phase(name, lc):
        num = (lc * kscat[..., None]).permute(1, 2, 0).reshape(V * nleg, W)
        return safe_div(plan.apply(name, num), kscat_b)

    f11_b = phase("b00", a1)
    f21_b = -phase("b02", b1)
    c2b, s2b = plan.consts["sun_c2"], plan.consts["sun_s2"]
    pref = safe_div(kscat_b / (4.0 * math.pi) * terms["t_sun"], terms["k_b"])
    j_b = torch.stack([
        pref * f11_b, pref * c2b[:, None] * f21_b, pref * s2b[:, None] * f21_b,
    ], dim=1)                                                  # [nb, 3, W]
    lo = plan.index["seg_lo"]
    seg_src = factor[:, None] * 0.5 * (j_b.index_select(0, lo)
                                       + j_b.index_select(0, lo + 1))
    i_first = plan.apply(
        "raysum", (seg_src * trans[:, None]).reshape(plan.nseg, 3 * W)
    ).view(R, 3, W)
    # unpolarized Lambertian ground reflection of the direct beam
    gterm = _ground_beam(plan, terms, albedo)
    zero = torch.zeros_like(gterm)
    i_first = i_first + torch.stack([gterm, zero, zero], dim=1)

    # ---- scattering kernel [W, V, 3D, 3D] (component-major) --------------
    # the quadrature weight of the incoming direction is folded into the
    # plan's basis tables and omega / (4 pi) into the greek coefficients
    pref2 = (ssa / (4.0 * math.pi))[..., None]

    def kernel(coeff, name):
        return torch.einsum("wvl,lde->wvde", coeff * pref2,
                            plan.consts[name])

    fa = kernel(a1, "t00")
    fb = -kernel(b1, "t02")
    p22 = kernel(0.5 * (a2 + a3), "t22")
    m22 = kernel(0.5 * (a2 - a3), "t2m2")
    f22 = p22 + m22
    f33 = p22 - m22
    c2i, s2i, c2o, s2o = (plan.consts[k] for k in ("c2i", "s2i", "c2o",
                                                   "s2o"))
    # rotate incoming meridian -> scattering plane (Q_s = c2i Q + s2i U,
    # U_s = -s2i Q + c2i U), apply the phase matrix, rotate the scattering
    # plane -> outgoing meridian (Q_o = c2o Q_p - s2o U_p,
    # U_o = s2o Q_p + c2o U_p)
    rows = [
        [fa, fb * c2i, fb * s2i],
        [c2o * fb, c2o * c2i * f22 + s2o * s2i * f33,
         c2o * s2i * f22 - s2o * c2i * f33],
        [s2o * fb, s2o * c2i * f22 - c2o * s2i * f33,
         s2o * s2i * f22 + c2o * c2i * f33],
    ]
    kern = torch.stack([torch.stack(r, dim=3) for r in rows], dim=2)
    kern = kern.view(W, V, 3 * D, 3 * D)

    def scattering_source(i_t):
        i = i_t.view(V, D, 3, W).permute(3, 0, 2, 1).reshape(W, V, 3 * D, 1)
        j = torch.matmul(kern, i)                           # [W, V, 3D, 1]
        return j.view(W, V, 3, D).permute(1, 3, 2, 0).reshape(R, 3 * W)

    c = factor * trans
    f_dn_w, ground_t = _diffuse_ground(plan, terms)

    def ground_diffuse(i_t):
        # Lambertian: depolarizing, reflects the I flux only
        f_dn = f_dn_w @ i_t.view(R, 3, W)[:D, 0]
        g = (albedo * f_dn / math.pi)[None, :] * ground_t
        z = torch.zeros_like(g)
        return torch.stack([g, z, z], dim=1).view(R, 3 * W)

    i_first = i_first.reshape(R, 3 * W)
    i_t = i_first
    for _ in range(iterations):
        i_t = (i_first + transport_step(plan, scattering_source(i_t), c)
               + ground_diffuse(i_t))
    j_t = scattering_source(i_t)
    i_ground = albedo * (f_dn_w @ i_t.view(R, 3, W)[:D, 0]) / math.pi

    def leading(x):
        return x.view(V, D, 3, W).permute(3, 0, 1, 2)

    return leading(i_t), leading(j_t), i_ground


def so_source_along_rays_polarized(j_field, traced: TracedRays, tables):
    """Polarized SO source at observer-ray segment endpoints
    (``sasktran2_tpu/rt/successive.py:833``).

    j_field [W, V, D, 3] (meridian-frame Stokes); for straight observer
    rays the local meridian plane equals the ray plane everywhere, so the
    interpolated Stokes vector is already in the line-of-sight frame.
    Returns (j_in, j_out) each [W, R, S, 3]."""
    outs = [
        so_source_along_rays(j_field[..., c], traced, tables)
        for c in range(3)
    ]
    return (torch.stack([o[0] for o in outs], dim=-1),
            torch.stack([o[1] for o in outs], dim=-1))


def observer_source_tables(traced: TracedRays, geom: SOGeometry):
    """Static (direction-interpolation) tables for evaluating the SO source
    field along the engine's observer rays: [R, S+1, 4] indices/weights onto
    the SO direction grid at each segment boundary."""
    xs = np.unique(geom.mu_d)
    phis = np.unique(geom.phi_d)
    nphi = len(phis)
    R, B = traced.cos_zenith.shape
    idx = np.zeros((R, B, 4), dtype=np.int32)
    wts = np.zeros((R, B, 4))
    dphi = 2.0 * np.pi / nphi
    for r in range(R):
        for b in range(B):
            mu = np.clip(traced.cos_zenith[r, b], xs[0], xs[-1])
            # boundary_relazi is the SUN's azimuth relative to the LOS
            # direction; the SO grid's phi is the DIRECTION's azimuth
            # relative to the sun — negatives of each other. Scalar/I/Q
            # are even in azimuth and insensitive; U is odd and flips
            # sign if the conventions are mixed (caught by the polarized
            # SO-vs-DO multiple-scatter-only comparison).
            phi = (-traced.boundary_relazi[r, b]) % (2.0 * np.pi)
            i = int(np.clip(np.searchsorted(xs, mu) - 1, 0, len(xs) - 2))
            f = np.clip((mu - xs[i]) / (xs[i + 1] - xs[i]), 0.0, 1.0)
            j = int(np.floor((phi - phis[0]) / dphi)) % nphi
            j2 = (j + 1) % nphi
            g = np.clip(((phi - phis[j]) % (2.0 * np.pi)) / dphi, 0.0, 1.0)
            idx[r, b] = (i * nphi + j, i * nphi + j2,
                         (i + 1) * nphi + j, (i + 1) * nphi + j2)
            wts[r, b] = ((1 - f) * (1 - g), (1 - f) * g,
                         f * (1 - g), f * g)
    return {"dir_idx": idx, "dir_w": wts}


def so_source_along_rays(j_field, traced: TracedRays, tables):
    """SO source (per unit optical depth) at observer-ray segment endpoints
    (``sasktran2_tpu/rt/successive.py:884``): the level interpolation of
    the traced rays, then the 4-point direction interpolation of
    ``observer_source_tables``.

    j_field: [W, V, D]; returns (j_in, j_out) each [W, R, S]."""
    dt, dev = j_field.dtype, j_field.device
    intw = torch.as_tensor(traced.interp_weights, dtype=dt, device=dev)
    didx = torch.as_tensor(tables["dir_idx"], dtype=torch.long, device=dev)
    dw = torch.as_tensor(tables["dir_w"], dtype=dt, device=dev)
    j_lev = torch.einsum("rba,wad->wrbd", intw, j_field)     # [W, R, B, D]
    j_dir = torch.gather(
        j_lev, -1, didx[None].expand(j_lev.shape[0], -1, -1, -1)
    )
    j_b = torch.einsum("wrbk,rbk->wrb", j_dir, dw)
    return j_b[..., :-1], j_b[..., 1:]
