"""Two-dimensional (altitude x horizontal-angle) structured ray tracing.

Role of the reference's Rust 2D tracer
(``upstream SASKTRAN2 rust/sasktran2-core/src/raytracer/trace2d.rs``): rays in
the orbital plane cross both shell boundaries and angle planes; each
segment carries bilinear (r, theta) interpolation weights so optical depths
become 4-entry gathers against the flattened [angle, altitude] extinction
field.

Conventions: the horizontal angle theta increases along the plane;
locations flatten as ``loc = angle_index * nalt + alt_index`` (matching the
2D atmosphere storage layout). The sun lies in the plane when
``solar_azimuth == 0``: the local solar zenith at angle theta is
``theta0 + theta`` with ``theta0 = acos(cos_sza_ref)`` at theta = 0.

(Copy of ``sasktran2_tpu/rt/raytrace2d.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TracedRays2D:
    """Sparse per-ray tables for the 2D geometry.

    od_idx/od_w : [R, S, 4] gather indices/weights: seg_od = sum w * k[idx]
    sun_idx/sun_w : [R, S+1, K] OD-to-sun gathers at segment boundaries
    interp_idx/interp_w : [R, S+1, 4] level quantity interp at boundaries
    cos_scatter : [R, S+1]; mask [R, S]; ground_hit etc. as in 1D
    """

    od_idx: np.ndarray
    od_w: np.ndarray
    lengths: np.ndarray
    sun_idx: np.ndarray
    sun_w: np.ndarray
    interp_idx: np.ndarray
    interp_w: np.ndarray
    mask: np.ndarray
    cos_scatter: np.ndarray
    ground_hit: np.ndarray
    ground_cos_sza: np.ndarray
    nloc: int


def _bilinear(radii, thetas, r, th):
    """4-entry (idx, w) interpolation of (r, theta) onto the 2D grid."""
    A = len(radii)
    H = len(thetas)
    i = int(np.clip(np.searchsorted(radii, r) - 1, 0, A - 2))
    f = np.clip((r - radii[i]) / (radii[i + 1] - radii[i]), 0.0, 1.0)
    j = int(np.clip(np.searchsorted(thetas, th) - 1, 0, H - 2))
    g = np.clip((th - thetas[j]) / (thetas[j + 1] - thetas[j]), 0.0, 1.0)
    idx = np.array([
        j * A + i, j * A + i + 1, (j + 1) * A + i, (j + 1) * A + i + 1
    ], dtype=np.int32)
    w = np.array([(1 - g) * (1 - f), (1 - g) * f, g * (1 - f), g * f])
    return idx, w


def trace_2d(
    altitude_grid_m,
    horizontal_angles,
    earth_radius_m,
    cos_sza_ref,
    rays,
    n_sun_steps: int = 64,
    refractive_index=None,
    los_refraction: bool = False,
):
    """Trace TangentAltitude rays (geometry-relative limb rays in the
    plane) through the 2D grid.

    With ``los_refraction`` the line of sight follows the altitude-
    refracted Bouguer path of the (1D) ``refractive_index`` profile —
    the role of the reference's structured 2D tracer's refracted paths
    (``upstream SASKTRAN2 rust/sasktran2-core/src/raytracer/trace2d.rs``,
    which also refracts on the altitude coordinate only). The solar
    attenuation stays straight (solar refraction is a 1D-path feature).
    """
    radii = earth_radius_m + np.asarray(altitude_grid_m, dtype=np.float64)
    thetas = np.asarray(horizontal_angles, dtype=np.float64)
    A, H = len(radii), len(thetas)
    nloc = A * H
    R = len(rays)
    # segments: shell crossings (2(A-1)) + angle crossings (H)
    S = 2 * (A - 1) + H + 2
    K = 4 * n_sun_steps

    integ = None
    if los_refraction:
        from .refraction import RefractiveShellIntegrator

        integ = RefractiveShellIntegrator(radii, refractive_index)

    t = TracedRays2D(
        od_idx=np.zeros((R, S, 4), dtype=np.int32),
        od_w=np.zeros((R, S, 4)),
        lengths=np.zeros((R, S)),
        sun_idx=np.zeros((R, S + 1, K), dtype=np.int32),
        sun_w=np.zeros((R, S + 1, K)),
        interp_idx=np.zeros((R, S + 1, 4), dtype=np.int32),
        interp_w=np.zeros((R, S + 1, 4)),
        mask=np.zeros((R, S)),
        cos_scatter=np.zeros((R, S + 1)),
        ground_hit=np.zeros(R, dtype=bool),
        ground_cos_sza=np.zeros(R),
        nloc=nloc,
    )

    theta0 = np.arccos(np.clip(cos_sza_ref, -1.0, 1.0))

    for ri, ray in enumerate(rays):
        if not hasattr(ray, "tangent_altitude_m"):
            # ground-viewing ray (engine maps GroundViewingSolar /
            # downward SolarAnglesObserverLocation into the plane)
            _trace_ground_2d(t, ri, ray, radii, thetas, theta0,
                             n_sun_steps)
            continue
        if integ is not None:
            _trace_limb_curved_2d(
                t, ri, ray, radii, thetas, theta0, integ,
                earth_radius_m, n_sun_steps,
            )
            continue
        rt = earth_radius_m + ray.tangent_altitude_m
        th_t = ray.horizontal_angle_radians
        # line: r cos(theta - th_t) = rt ; traversal increases theta when
        # viewing azimuth ~ 0 (ray direction along +theta)
        # crossings with shells: theta = th_t +- acos(rt / r_j)
        crossings = []
        for j in range(A):
            if radii[j] <= rt:
                continue
            dth = np.arccos(np.clip(rt / radii[j], -1.0, 1.0))
            crossings.append(th_t - dth)
            crossings.append(th_t + dth)
        for th in thetas:
            if abs(th - th_t) < np.pi / 2:
                crossings.append(th)
        crossings = np.array(sorted(set(crossings)))
        # restrict to within the atmosphere (|r| <= TOA)
        def r_of(th):
            c = np.cos(th - th_t)
            return rt / c if c > 1e-12 else np.inf

        pts = [th for th in crossings if r_of(th) <= radii[-1] * (1 + 1e-12)]
        pts = np.array(pts)
        if len(pts) < 2:
            continue
        # arc-length parameterization: l = rt tan(theta - th_t)
        ls = rt * np.tan(pts - th_t)
        order = np.argsort(ls)
        pts, ls = pts[order], ls[order]

        for s in range(len(pts) - 1):
            th_a, th_b = pts[s], pts[s + 1]
            l_a, l_b = ls[s], ls[s + 1]
            seg_len = l_b - l_a
            if seg_len <= 0:
                continue
            th_m = np.arctan2(0.5 * (l_a + l_b), rt) + th_t
            r_m = np.hypot(rt, 0.5 * (l_a + l_b))
            # exact radial quadrature (linear-in-radius) x midpoint in theta
            from .raytrace import _exact_shell_weights

            A2 = len(radii)
            j = int(np.clip(np.searchsorted(radii, r_m) - 1, 0, A2 - 2))
            w_lo, w_hi = _exact_shell_weights(l_a, l_b, rt, radii[j],
                                              radii[j + 1])
            H2 = len(thetas)
            jt2 = int(np.clip(np.searchsorted(thetas, th_m) - 1, 0, H2 - 2))
            g = np.clip((th_m - thetas[jt2]) / (thetas[jt2 + 1] - thetas[jt2]),
                        0.0, 1.0)
            idx = np.array([
                jt2 * A2 + j, jt2 * A2 + j + 1,
                (jt2 + 1) * A2 + j, (jt2 + 1) * A2 + j + 1,
            ], dtype=np.int32)
            wv = np.array([
                (1 - g) * w_lo, (1 - g) * w_hi, g * w_lo, g * w_hi,
            ])
            t.od_idx[ri, s] = idx
            t.od_w[ri, s] = wv
            t.lengths[ri, s] = seg_len
            t.mask[ri, s] = 1.0
            # boundary s = entrance (far end first: pts sorted along +l,
            # which is the propagation direction toward the observer if the
            # observer sits at +theta side; far end = most negative l)
            _fill_boundary_2d(t, ri, s, th_a, l_a, rt, th_t, radii, thetas,
                              theta0, n_sun_steps)
        _fill_boundary_2d(t, ri, len(pts) - 1, pts[-1], ls[-1], rt, th_t,
                          radii, thetas, theta0, n_sun_steps)
    return t


def _trace_ground_2d(t, ri, ray, radii, thetas, theta0, n_sun_steps):
    """Downward-looking (ground-hitting) ray through the 2D grid: the
    straight line from the ground point upward toward the observer, with
    the ground point at the horizontal angle where the in-plane local SZA
    matches the ray's cos_sza (the same placement convention as the limb
    mapping). Reference capability: GroundViewingSolar with Geometry2D
    (``tests/engine/test_geometry2d_emission.py`` ground test)."""
    from .raytrace import _exact_shell_weights

    A = len(radii)
    H = len(thetas)
    muv = abs(ray.cos_viewing_zenith)
    th_g = theta0 - np.arccos(np.clip(ray.cos_sza, -1.0, 1.0))
    sv = np.sqrt(max(1.0 - muv * muv, 0.0))
    rt = radii[0] * sv
    ls = np.sqrt(np.maximum(radii**2 - rt * rt, 0.0))
    th_b = th_g + (np.arctan2(ls, rt) - np.arctan2(ls[0], rt))

    t.ground_hit[ri] = True
    t.ground_cos_sza[ri] = float(ray.cos_sza)
    # scattering cosine for the slanted direction: cos Theta = -cos(alpha
    # - theta0) with alpha the ray's global in-plane polar angle
    alpha = th_g + np.arccos(np.clip(muv, -1.0, 1.0))
    cs = float(-np.cos(alpha - theta0))

    # propagation ground -> TOA (far end first: the ground)
    for s in range(A - 1):
        w_lo, w_hi = _exact_shell_weights(
            ls[s], ls[s + 1], rt, radii[s], radii[s + 1]
        )
        th_m = 0.5 * (th_b[s] + th_b[s + 1])
        jt2 = int(np.clip(np.searchsorted(thetas, th_m) - 1, 0, H - 2))
        g = np.clip(
            (th_m - thetas[jt2]) / (thetas[jt2 + 1] - thetas[jt2]),
            0.0, 1.0,
        )
        t.od_idx[ri, s] = np.array([
            jt2 * A + s, jt2 * A + s + 1,
            (jt2 + 1) * A + s, (jt2 + 1) * A + s + 1,
        ], dtype=np.int32)
        t.od_w[ri, s] = np.array([
            (1 - g) * w_lo, (1 - g) * w_hi, g * w_lo, g * w_hi,
        ])
        t.lengths[ri, s] = ls[s + 1] - ls[s]
        t.mask[ri, s] = 1.0
        _fill_boundary_2d(
            t, ri, s, th_b[s], 0.0, rt, th_g, radii, thetas, theta0,
            n_sun_steps, r_override=radii[s], cos_scatter=cs,
        )
    _fill_boundary_2d(
        t, ri, A - 1, th_b[-1], 0.0, rt, th_g, radii, thetas, theta0,
        n_sun_steps, r_override=radii[-1], cos_scatter=cs,
    )


def _trace_limb_curved_2d(t, ri, ray, radii, thetas, theta0, integ, re,
                          n_sun_steps):
    """Limb ray along the altitude-refracted Bouguer path through the 2D
    grid (role of the reference 2D tracer's refracted paths,
    ``trace2d.rs``). The radial machinery is the 1D curved tracer's
    (``raytrace._trace_limb_curved``); the horizontal angle at each shell
    boundary accumulates the swept earth-center angle, and the OD gathers
    stay bilinear in (r, theta). The scattering cosine uses the
    tangent-point direction (refraction bends the look vector < ~1 deg)
    and the solar path stays straight."""
    A = len(radii)
    P = A - 1
    H = len(thetas)
    rt_straight = re + ray.tangent_altitude_m
    th_t = ray.horizontal_angle_radians
    rt = integ.tangent_radius(rt_straight)
    nt = integ.n_at(rt)
    hits_ground = rt < radii[0]

    if hits_ground:
        bounds = list(radii)
        t.ground_hit[ri] = True
        t.ground_cos_sza[ri] = float(np.cos(theta0 - th_t))
        it = 0
        phi0 = integ.shell_integral(rt, nt, rt, radii[0], rt, radii[0])[3]
    else:
        jt = int(np.searchsorted(radii, rt))
        desc = list(range(A - 1, jt - 1, -1))
        bounds = (
            [radii[j] for j in desc] + [rt]
            + [radii[j] for j in reversed(desc)]
        )
        it = len(desc)
        phi0 = 0.0

    nseg = len(bounds) - 1
    seg = []
    for s in range(nseg):
        lo, hi = sorted((bounds[s], bounds[s + 1]))
        if hi <= lo:
            seg.append(None)
            continue
        rm = 0.5 * (lo + hi)
        j = int(np.clip(np.searchsorted(radii, rm) - 1, 0, P - 1))
        L, wlo, whi, dphi = integ.shell_integral(
            rt, nt, lo, hi, radii[j], radii[j + 1]
        )
        seg.append((j, L, wlo, whi, dphi))

    # earth-center angle at each boundary, phi = 0 at the tangent point
    phis = [0.0] * (nseg + 1)
    if hits_ground:
        phis[0] = phi0
        for s in range(nseg):
            dphi = seg[s][4] if seg[s] else 0.0
            phis[s + 1] = phis[s] + dphi
    else:
        phis[it] = 0.0
        for s in range(it - 1, -1, -1):
            dphi = seg[s][4] if seg[s] else 0.0
            phis[s] = phis[s + 1] - dphi
        for s in range(it, nseg):
            dphi = seg[s][4] if seg[s] else 0.0
            phis[s + 1] = phis[s] + dphi

    for s in range(nseg):
        if seg[s] is None:
            # still fill the boundary so interp/sun tables stay aligned
            _fill_boundary_2d(
                t, ri, s, th_t + phis[s], 0.0, rt, th_t, radii, thetas,
                theta0, n_sun_steps, r_override=bounds[s],
            )
            continue
        j, L, wlo, whi, dphi = seg[s]
        th_a = th_t + phis[s]
        th_b = th_t + phis[s + 1]
        th_m = 0.5 * (th_a + th_b)
        jt2 = int(np.clip(np.searchsorted(thetas, th_m) - 1, 0, H - 2))
        g = np.clip(
            (th_m - thetas[jt2]) / (thetas[jt2 + 1] - thetas[jt2]), 0.0, 1.0
        )
        t.od_idx[ri, s] = np.array([
            jt2 * A + j, jt2 * A + j + 1,
            (jt2 + 1) * A + j, (jt2 + 1) * A + j + 1,
        ], dtype=np.int32)
        t.od_w[ri, s] = np.array([
            (1 - g) * wlo, (1 - g) * whi, g * wlo, g * whi,
        ])
        t.lengths[ri, s] = L
        t.mask[ri, s] = 1.0
        _fill_boundary_2d(
            t, ri, s, th_a, 0.0, rt, th_t, radii, thetas, theta0,
            n_sun_steps, r_override=bounds[s],
        )
    _fill_boundary_2d(
        t, ri, nseg, th_t + phis[nseg], 0.0, rt, th_t, radii, thetas,
        theta0, n_sun_steps, r_override=bounds[nseg],
    )


def _fill_boundary_2d(t, ri, b, th, l, rt, th_t, radii, thetas, theta0,
                      n_sun_steps, r_override=None, cos_scatter=None):
    r = np.hypot(rt, l) if r_override is None else r_override
    idx, w = _bilinear(radii, thetas, r, th)
    t.interp_idx[ri, b] = idx
    t.interp_w[ri, b] = w
    # Fixed in-plane sun: local sza(theta) = theta0 - theta (this sign
    # reproduces the 1D pinned convention: at the tangent point the
    # scattering cosine equals -sin(theta0 - th_t) for relazi = 0).
    sza = theta0 - th
    # the scattering angle between the straight ray and the fixed sun is
    # constant along the ray (tangent-point value; ground rays pass their
    # own slanted-direction value)
    t.cos_scatter[ri, b] = (
        -np.sin(theta0 - th_t) if cos_scatter is None else cos_scatter
    )
    _sun_march(t, ri, b, r, th, sza, radii, thetas, n_sun_steps)


def _sun_march(t, ri, b, r0, th0, sza, radii, thetas, n_steps):
    """Walk toward the sun (in-plane direction at local zenith angle sza)
    accumulating 4-entry bilinear gathers along equal steps to TOA."""
    # position in plane: x = r sin(th), z = r cos(th); sun direction at
    # angle (sza measured from local up at theta=0 frame): global direction
    # toward sun: (sin(0th?)...). Sun is fixed: direction (sin(theta0_sun),
    # cos(theta0_sun)) with theta0_sun = sza - th... Using sza(th) =
    # theta0 + th, the global sun direction is (sin(-theta0), cos(-theta0))
    # measured in the same plane: unit vector s = (sin(-theta0),
    # cos(-theta0))? Equivalent: local zenith angle at any point th is
    # theta0 + th, consistent with a fixed global direction
    # s = (-sin(theta0), cos(theta0)).
    theta0 = sza + th0
    s_hat = np.array([np.sin(theta0), np.cos(theta0)])
    p = np.array([r0 * np.sin(th0), r0 * np.cos(th0)])
    rtoa = radii[-1]
    # path length to TOA: solve |p + t s| = rtoa
    bq = 2 * np.dot(p, s_hat)
    cq = np.dot(p, p) - rtoa * rtoa
    disc = bq * bq - 4 * cq
    if disc <= 0:
        return
    t_end = (-bq + np.sqrt(disc)) / 2.0
    if t_end <= 0:
        return
    dstep = t_end / n_steps
    K = t.sun_idx.shape[-1]
    kk = 0
    for i in range(n_steps):
        q = p + (i + 0.5) * dstep * s_hat
        rq = np.linalg.norm(q)
        if rq < radii[0]:
            # shadowed by the ground
            t.sun_w[ri, b, 0] = 1e10
            t.sun_idx[ri, b, 0] = 0
            return
        thq = np.arctan2(q[0], q[1])
        idx, w = _bilinear(radii, thetas, rq, thq)
        t.sun_idx[ri, b, kk : kk + 4] = idx
        t.sun_w[ri, b, kk : kk + 4] = w * dstep
        kk += 4
