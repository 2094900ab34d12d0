"""Host-side spherical-shell and plane-parallel ray tracing.

(Copy of ``sasktran2_tpu/rt/raytrace.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins its tables, and those of
``apply_solar_table``, to the original's.)

The reference traces rays in C++/Rust (``upstream SASKTRAN2 cpp/lib/raytracing/
spherical_shell.cpp``, ``rust/sasktran2-core/src/raytracer/trace.rs``) into
per-ray ``TracedLayer`` lists. On TPU the geometry is *static*: rays are
traced once on the host in float64 numpy and compiled into dense, padded
weight tables that turn every optical-depth integral into a single batched
matrix multiply against the extinction profile:

    seg_od[ray, seg] = sum_alt od_weights[ray, seg, alt] * k[alt]      (LOS)
    sun_od[ray, seg] = sum_alt sun_weights[ray, seg, alt] * k[alt]     (beam)

Segments are ordered from the far end of the ray toward the observer
(matching the reference convention, ``types.rs:31-49``), padded to a static
maximum count with zero weights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TracedRays:
    """Static padded per-ray tables (numpy, built once per geometry).

    S = max segments per ray; A = number of altitude levels.

    od_weights : [R, S, A] maps level extinction -> segment OD
    sun_weights : [R, S+1, A] maps level extinction -> OD toward the sun
        from each segment *boundary* (entrance of each segment, plus the
        observer-side end), used by single scatter at quadrature points
    interp_weights : [R, S+1, A] linear interpolation of any level quantity
        onto segment boundaries
    lengths : [R, S] geometric segment lengths [m]
    mask : [R, S] 1.0 for real segments
    cos_scatter : [R, S+1] cosine of the scattering angle (sun -> LOS
        direction) at segment boundaries
    cos_zenith : [R, S+1] local zenith cosine of the LOS propagation
        direction at segment boundaries (+1 = travelling straight up)
    cos_sza : [R, S+1] local cosine solar zenith at segment boundaries
    ground_hit : [R] bool
    ground_cos_sza / ground_cos_vza / ground_relazi : [R] surface-reflection
        geometry for rays hitting the ground
    tangent_altitude : [R] (nan for non-limb rays)
    seg_layer : [R, S] int, TOA-first layer index containing each segment
        (for evaluating layer-resolved multiple-scatter source functions)
    seg_entrance_frac / seg_exit_frac : [R, S] fractional depth of the
        segment entrance/exit within the layer, 0 at the layer top and 1 at
        the layer bottom
    boundary_relazi : [R, S+1] relative solar azimuth at each boundary
    """

    od_weights: np.ndarray
    sun_weights: np.ndarray
    interp_weights: np.ndarray
    lengths: np.ndarray
    mask: np.ndarray
    cos_scatter: np.ndarray
    cos_zenith: np.ndarray
    cos_sza: np.ndarray
    ground_hit: np.ndarray
    ground_cos_sza: np.ndarray
    ground_cos_vza: np.ndarray
    ground_relazi: np.ndarray
    tangent_altitude: np.ndarray
    seg_layer: np.ndarray
    seg_entrance_frac: np.ndarray
    seg_exit_frac: np.ndarray
    boundary_relazi: np.ndarray
    # Stokes rotation (scattering plane -> ray meridian plane) at
    # boundaries, for polarized single scatter: cos(2 sigma), sin(2 sigma).
    # The meridian plane contains the ray-frame vertical (up at the
    # reference point) and the propagation direction; for straight rays the
    # rotation is constant along the ray.
    cos2rot: np.ndarray | None = None
    sin2rot: np.ndarray | None = None


# Active grid interpolation policy for the current trace (reference
# ``cpp/lib/grids/grid.cpp:103-126``: linear / shell / lower). Tracing is
# single-threaded host precompute, so a module-level setting scoped by
# ``trace_spherical`` is safe.
_INTERP_METHOD = "linear"


def _exact_shell_weights(l0, l1, rt, r_lo, r_hi):
    """2-entry OD weights for a segment inside one shell, honoring the
    active interpolation policy.

    linear (default): extinction linear in radius between the bounding
    levels (r_lo, r_hi); ``int k dl`` over the segment [l0, l1] (signed
    distances from the tangent point, r(l) = hypot(rt, l)) is analytic:
        int r dl = F(l1) - F(l0),  F(l) = (l r(l) + rt^2 asinh(l/rt)) / 2.
    shell: constant in-shell extinction = mean of the bounding levels
    (reference grid.cpp:112-119 equal weights).
    lower: constant in-shell extinction = lower level (grid.cpp:121-125).

    Returns (w_lo, w_hi) with seg_od = w_lo k(r_lo) + w_hi k(r_hi). The
    midpoint rule the linear policy replaces under-integrates near the
    tangent point by several percent.
    """
    dl = l1 - l0
    if dl <= 0:
        return 0.0, 0.0
    if _INTERP_METHOD == "shell":
        return 0.5 * dl, 0.5 * dl
    if _INTERP_METHOD == "lower":
        return dl, 0.0

    def F(l):
        r = np.hypot(rt, l)
        if rt > 0:
            return 0.5 * (l * r + rt * rt * np.arcsinh(l / rt))
        return 0.5 * l * abs(l)

    i_r = F(l1) - F(l0)
    dr = r_hi - r_lo
    if dr <= 0:
        return dl, 0.0
    w_hi = (i_r - r_lo * dl) / dr
    w_hi = min(max(w_hi, 0.0), dl)
    return dl - w_hi, w_hi


def _shell_path_length(r_shell, rt, s_far, s_near):
    """Path length within a shell for a straight ray with tangent radius rt.

    Distance along ray from tangent point to radius r: l(r) = sqrt(r^2-rt^2).
    """
    return np.sqrt(np.maximum(r_shell**2 - rt**2, 0.0))


def _interp_weights_at_radius(r, radii):
    """Interpolation weights of a radius onto the level grid, honoring the
    active policy (linear fractional / shell half-half / lower)."""
    A = len(radii)
    w = np.zeros(A)
    if r <= radii[0]:
        w[0] = 1.0
    elif r >= radii[-1]:
        w[-1] = 1.0
    else:
        # floor semantics (side="right") so a point exactly on a grid
        # level uses that level as its "lower" index, matching the
        # reference's i = floor((x - x0)/dx)
        j = np.searchsorted(radii, r, side="right") - 1
        if _INTERP_METHOD == "shell":
            w[j] = 0.5
            w[j + 1] = 0.5
        elif _INTERP_METHOD == "lower":
            w[j] = 1.0
        else:
            f = (r - radii[j]) / (radii[j + 1] - radii[j])
            w[j] = 1.0 - f
            w[j + 1] = f
    return w


def _sun_od_weights(r, cos_sza_local, radii, earth_radius):
    """OD-to-sun weight row: straight path from radius r toward the sun
    (local cos SZA) out the top of the atmosphere, integrating linearly
    interpolated extinction across shells.

    Returns [A] weights such that sun_od = weights . extinction_levels.
    Rays that would pass below the surface return large weights on the
    bottom level (the transmission then underflows to zero).
    """
    A = len(radii)
    w = np.zeros(A)
    # Tangent radius of the solar ray
    sin_sza = np.sqrt(max(1.0 - cos_sza_local**2, 0.0))
    rt = r * sin_sza
    if cos_sza_local < 0.0 and rt <= earth_radius:
        # sun below horizon: fully attenuated
        w[0] = 1e10
        return w

    def leg(r_from, r_to):
        # integrate between two radii along the slant path (outgoing branch)
        nonlocal w
        jf = np.clip(np.searchsorted(radii, r_from, side="right") - 1, 0, A - 2)
        jt = np.clip(np.searchsorted(radii, r_to, side="right") - 1, 0, A - 2)
        # walk shells from r_from up to r_to with exact linear-in-radius
        # quadrature per shell
        r0 = r_from
        for j in range(jf, jt + 1):
            r1 = min(radii[j + 1], r_to)
            if r1 <= r0:
                continue
            l0 = np.sqrt(max(r0**2 - rt**2, 0.0))
            l1 = np.sqrt(max(r1**2 - rt**2, 0.0))
            w_lo, w_hi = _exact_shell_weights(
                l0, l1, rt, radii[j], radii[j + 1]
            )
            w[j] += w_lo
            w[j + 1] += w_hi
            r0 = r1

    if cos_sza_local >= 0.0:
        # outgoing only: from r to TOA
        leg(r, radii[-1])
    else:
        # descend to tangent radius then ascend to TOA
        leg(max(rt, radii[0]), r)  # descending branch has same lengths
        leg(max(rt, radii[0]), radii[-1])
    return w


def trace_spherical(
    altitude_grid_m: np.ndarray,
    earth_radius_m: float,
    cos_sza_ref: float,
    rays,
    nsub: int = 1,
    use_native=True,
    refractive_index: np.ndarray | None = None,
    los_refraction: bool = False,
    solar_refraction: bool = False,
    interp_method: str = "linear",
) -> TracedRays:
    """Trace a set of viewing-geometry rays through 1D spherical shells.

    ``rays`` is a list of viewing-geometry policy objects
    (:mod:`sasktran2_tpu.viewinggeo`). Shell boundaries coincide with the
    altitude grid; each traversed shell produces one segment (``nsub``
    reserved for future sub-layering).

    The solar geometry follows the reference's single-SZA-per-ray model for
    limb rays (``TangentAltitudeSolar`` carries cos_sza at the tangent
    point); plane-parallel-style variation of SZA along the ray is applied
    via the local-angle geometry of the straight line.
    """
    from ..viewinggeo import (
        GroundViewingSolar,
        SolarAnglesObserverLocation,
        TangentAltitudeSolar,
    )

    radii = earth_radius_m + np.asarray(altitude_grid_m, dtype=np.float64)
    A = len(radii)
    R = len(rays)
    S = 2 * (A - 1)  # worst case: limb ray through all shells twice

    global _INTERP_METHOD
    if interp_method not in ("linear", "shell", "lower"):
        msg = f"unknown interpolation method: {interp_method}"
        raise ValueError(msg)
    if interp_method != "linear":
        use_native = False  # the native C++ tracer is linear-only

    refracting = los_refraction or solar_refraction
    if refracting:
        from .refraction import RefractiveShellIntegrator

        integ = RefractiveShellIntegrator(radii, refractive_index)
        use_native = False  # refraction is traced on the Python path
        if solar_refraction:
            def sun_od_fn(r, cs):
                return integ.sun_od_weights(r, cs, earth_radius_m)
        else:
            def sun_od_fn(r, cs):
                return _sun_od_weights(r, cs, radii, earth_radius_m)
    else:
        integ = None
        sun_od_fn = None

    if use_native:
        native = _trace_native(radii, earth_radius_m, rays)
        if native is not None:
            return native
        if use_native == "require":
            msg = "native tracer requested but unavailable"
            raise RuntimeError(msg)

    od_weights = np.zeros((R, S, A))
    sun_weights = np.zeros((R, S + 1, A))
    interp_weights = np.zeros((R, S + 1, A))
    lengths = np.zeros((R, S))
    mask = np.zeros((R, S))
    cos_scatter = np.zeros((R, S + 1))
    cos_zenith = np.zeros((R, S + 1))
    cos_sza_b = np.zeros((R, S + 1))
    ground_hit = np.zeros(R, dtype=bool)
    g_cos_sza = np.zeros(R)
    g_cos_vza = np.zeros(R)
    g_relazi = np.zeros(R)
    tangent_alt = np.full(R, np.nan)
    seg_layer = np.zeros((R, S), dtype=np.int64)
    seg_entrance_frac = np.zeros((R, S))
    seg_exit_frac = np.zeros((R, S))
    boundary_relazi = np.zeros((R, S + 1))
    cos2rot = np.ones((R, S + 1))
    sin2rot = np.zeros((R, S + 1))

    out_arrays = (
        od_weights, sun_weights, interp_weights, lengths, mask,
        cos_scatter, cos_zenith, cos_sza_b,
        seg_layer, seg_entrance_frac, seg_exit_frac, boundary_relazi,
        cos2rot, sin2rot,
    )

    _INTERP_METHOD = interp_method
    try:
        for ri, ray in enumerate(rays):
            if isinstance(ray, TangentAltitudeSolar):
                rt = earth_radius_m + ray.tangent_altitude_m
                tangent_alt[ri] = ray.tangent_altitude_m
                cos_sza0 = ray.cos_sza
                relazi = ray.relative_azimuth
                if los_refraction:
                    hit = _trace_limb_curved(
                        ri, rt, radii, earth_radius_m, cos_sza0, relazi,
                        integ, sun_od_fn, *out_arrays,
                    )
                    if hit is not None:
                        ground_hit[ri] = True
                        g_cos_sza[ri], g_cos_vza[ri], g_relazi[ri] = hit
                else:
                    _trace_limb(
                        ri, rt, radii, earth_radius_m, cos_sza0, relazi,
                        *out_arrays, sun_od_fn=sun_od_fn,
                    )
            elif isinstance(
                ray, (GroundViewingSolar, SolarAnglesObserverLocation)
            ):
                muv = ray.cos_viewing_zenith
                down = isinstance(ray, GroundViewingSolar) or muv < 0.0
                if down:
                    ground_hit[ri] = True
                    g_cos_sza[ri] = ray.cos_sza
                    g_cos_vza[ri] = abs(muv)
                    g_relazi[ri] = ray.relative_azimuth
                nadir_fn = (
                    _trace_nadir_curved if los_refraction else _trace_nadir
                )
                extra = {"integ": integ} if los_refraction else {}
                nadir_fn(
                    ri, abs(muv), radii, earth_radius_m, ray.cos_sza,
                    ray.relative_azimuth, down,
                    *out_arrays, sun_od_fn=sun_od_fn, **extra,
                )
            else:
                msg = (
                    "Unsupported ray policy for spherical tracing: "
                    f"{type(ray)}"
                )
                raise NotImplementedError(msg)
    finally:
        _INTERP_METHOD = "linear"

    return TracedRays(
        od_weights=od_weights,
        sun_weights=sun_weights,
        interp_weights=interp_weights,
        lengths=lengths,
        mask=mask,
        cos_scatter=cos_scatter,
        cos_zenith=cos_zenith,
        cos_sza=cos_sza_b,
        ground_hit=ground_hit,
        ground_cos_sza=g_cos_sza,
        ground_cos_vza=g_cos_vza,
        ground_relazi=g_relazi,
        tangent_altitude=tangent_alt,
        seg_layer=seg_layer,
        seg_entrance_frac=seg_entrance_frac,
        seg_exit_frac=seg_exit_frac,
        boundary_relazi=boundary_relazi,
        cos2rot=cos2rot,
        sin2rot=sin2rot,
    )


def _stokes_rotation(d_hat, sun_vec):
    """(cos 2s, sin 2s) rotating Stokes (Q, U) from the scattering plane
    (containing the incident solar propagation and ``d_hat``) to the ray
    meridian plane (containing the frame z axis and ``d_hat``).

    The reference applies the equivalent rotation via its scattering-matrix
    rotation helpers (``upstream SASKTRAN2 cpp/include/sasktran2/math/
    scattering.h``); here it is two plane normals and a signed angle.
    Degenerate geometries (forward/backward scattering, vertical rays)
    return the identity — ``b1`` vanishes at those scattering angles.
    """
    u = -np.asarray(sun_vec)  # incident propagation direction
    n1 = np.cross(u, d_hat)
    n2 = np.cross(np.array([0.0, 0.0, 1.0]), d_hat)
    s1 = np.linalg.norm(n1)
    s2 = np.linalg.norm(n2)
    if s1 < 1e-10 or s2 < 1e-10:
        return 1.0, 0.0
    n1 = n1 / s1
    n2 = n2 / s2
    c = float(np.dot(n1, n2))
    s = float(np.dot(np.cross(n1, n2), d_hat))
    # The sign pins the U convention to the polarized DO solver's azimuth
    # synthesis (U ~ sin m(pi - azi), disco_vec.py), which is itself pinned
    # by the Coulson-table validation.
    return c * c - s * s, -2.0 * s * c


def _solar_frame(mu0_ref, relazi_ref, coszen_ref):
    """Unit sun vector in the ray frame (reference point up = z, ray
    horizontal projection = x). The relative-azimuth convention is the one
    pinned by the Coulson validation: cos(alpha) = cos(relazi)."""
    ss = np.sqrt(max(1.0 - mu0_ref**2, 0.0))
    alpha = relazi_ref
    return np.array([ss * np.cos(alpha), ss * np.sin(alpha), mu0_ref])


def _solar_at_point(s_dist, r_ref, coszen_ref, sun_vec):
    """(cos_sza, coszen, relazi, radius) at distance ``s_dist`` from the
    reference point along the propagation direction (positive toward the
    observer).

    The scattering angle is invariant along a straight ray; the local
    relative azimuth follows from cos(Theta) = -cz*cs - sz*ss*cos(relazi).
    """
    sz_ref = np.sqrt(max(1.0 - coszen_ref**2, 0.0))
    p_hat = np.array([sz_ref, 0.0, coszen_ref])
    r_vec = np.array([0.0, 0.0, r_ref]) + s_dist * p_hat
    r = np.linalg.norm(r_vec)
    r_hat = r_vec / r
    cs = float(np.dot(sun_vec, r_hat))
    cz = float(np.dot(p_hat, r_hat))
    sz = np.sqrt(max(1.0 - cz * cz, 0.0))
    ss = np.sqrt(max(1.0 - cs * cs, 0.0))
    if sz * ss < 1e-12:
        relazi = 0.0
    else:
        # signed relative azimuth: atan2 of the sun's horizontal components
        # along (h_hat, r_hat x h_hat). The sign only matters for the
        # polarized U component (everything scalar uses cos(relazi)).
        h_hat = (p_hat - cz * r_hat) / sz
        y_hat = np.cross(r_hat, h_hat)
        relazi = float(np.arctan2(np.dot(sun_vec, y_hat),
                                  np.dot(sun_vec, h_hat)))
    return cs, cz, relazi, r


def _scatter_cosine(cos_zen_los, cos_sza, relazi):
    """Cosine of the angle between the (propagation) LOS direction and the
    direction *toward* the sun photons travel (downward with cos -cos_sza),
    i.e. cos Theta = dir_los . dir_from_sun."""
    sin_zen = np.sqrt(max(1.0 - cos_zen_los**2, 0.0))
    sin_sza = np.sqrt(max(1.0 - cos_sza**2, 0.0))
    # incoming solar propagation direction has vertical component -cos_sza;
    # relative azimuth 0 = forward scattering plane (reference convention,
    # viewinggeo/wrappers.py:193): horizontal angle between LOS and solar
    # propagation is pi - relazi
    return -cos_zen_los * cos_sza - sin_zen * sin_sza * np.cos(relazi)


def _trace_limb(
    ri, rt, radii, re, cos_sza0, relazi,
    od_weights, sun_weights, interp_weights, lengths, mask,
    cos_scatter, cos_zenith, cos_sza_b,
    seg_layer, seg_entrance_frac, seg_exit_frac, boundary_relazi,
    cos2rot, sin2rot,
    sun_od_fn=None,
):
    """Limb ray: enters at TOA, descends to tangent point, ascends to TOA.

    Segments ordered from the far end (TOA on the sun-far side) toward the
    observer. Boundary b sits at the entrance of segment s (far side);
    boundary S is the observer-side TOA crossing.
    """
    A = len(radii)
    sun_vec = _solar_frame(cos_sza0, relazi, 0.0)
    # straight ray: the Stokes rotation is constant along the ray
    cos2rot[ri, :], sin2rot[ri, :] = _stokes_rotation(
        np.array([1.0, 0.0, 0.0]), sun_vec
    )
    # shells crossed: those with radius > rt
    jt = np.searchsorted(radii, rt)  # first level index above tangent
    # descending branch: shells A-1 -> jt ; ascending: jt -> A-1
    desc = list(range(A - 1, jt - 1, -1))  # level indices at boundaries
    path_levels = desc + list(reversed(desc))[1:]
    # boundary radii along the ray from far TOA to near TOA, with the
    # tangent point approximated by the deepest level crossing (plus exact
    # tangent radius inserted)
    bounds = [radii[j] for j in desc] + [rt] + [radii[j] for j in reversed(desc)]
    signs = [-1.0] * (len(desc)) + [+1.0] * (len(desc))  # direction: down then up
    nseg = len(bounds) - 1
    P = len(radii) - 1
    s_out = 0
    for s in range(nseg):
        r0, r1 = bounds[s], bounds[s + 1]
        lo, hi = min(r0, r1), max(r0, r1)
        l0 = np.sqrt(max(lo**2 - rt**2, 0.0))
        l1 = np.sqrt(max(hi**2 - rt**2, 0.0))
        ds = l1 - l0
        if ds <= 0.0:
            continue
        rm = 0.5 * (lo + hi)
        j = int(np.clip(np.searchsorted(radii, rm) - 1, 0, P - 1))
        # signed distances from the tangent for the exact shell quadrature
        l_lo = np.sqrt(max(lo**2 - rt**2, 0.0))
        l_hi = np.sqrt(max(hi**2 - rt**2, 0.0))
        w_lo, w_hi = _exact_shell_weights(l_lo, l_hi, rt, radii[j],
                                          radii[j + 1])
        od_weights[ri, s_out, j] = w_lo
        od_weights[ri, s_out, j + 1] = w_hi
        lengths[ri, s_out] = ds
        mask[ri, s_out] = 1.0
        seg_layer[ri, s_out] = P - 1 - j
        dz_l = radii[j + 1] - radii[j]
        seg_entrance_frac[ri, s_out] = np.clip(
            (radii[j + 1] - bounds[s]) / dz_l, 0.0, 1.0
        )
        seg_exit_frac[ri, s_out] = np.clip(
            (radii[j + 1] - bounds[s + 1]) / dz_l, 0.0, 1.0
        )
        # boundary s (entrance of this segment, far side)
        _fill_boundary(
            ri, s_out, bounds[s], signs[s], rt, radii, re, sun_vec, 0.0, rt,
            sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
            boundary_relazi, sun_od_fn=sun_od_fn,
        )
        s_out += 1
    # observer-side boundary
    _fill_boundary(
        ri, s_out, bounds[-1], +1.0, rt, radii, re, sun_vec, 0.0, rt,
        sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
        boundary_relazi, sun_od_fn=sun_od_fn,
    )


def _fill_boundary(
    ri, b, r, sign, rt, radii, re, sun_vec, coszen_ref, r_ref,
    sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
    boundary_relazi, sun_od_fn=None,
):
    """Per-boundary solar geometry from the full 3D straight-line
    construction (the reference computes per-quadrature-point solar angles
    from ECEF geometry, ``cpp/lib/raytracing/spherical_shell.cpp``)."""
    # distance from the reference point along propagation
    l_ref = np.sqrt(max(r_ref**2 - rt**2, 0.0))
    s_dist = sign * np.sqrt(max(r**2 - rt**2, 0.0)) - (
        np.sign(coszen_ref if coszen_ref != 0.0 else 1.0) * l_ref
    )
    cs, cz, relazi_loc, _ = _solar_at_point(s_dist, r_ref, coszen_ref, sun_vec)
    cos_zenith[ri, b] = cz
    cos_sza_b[ri, b] = cs
    cos_scatter[ri, b] = _scatter_cosine(cz, cs, relazi_loc)
    interp_weights[ri, b] = _interp_weights_at_radius(r, radii)
    if sun_od_fn is None:
        sun_weights[ri, b] = _sun_od_weights(r, cs, radii, re)
    else:
        sun_weights[ri, b] = sun_od_fn(r, cs)
    boundary_relazi[ri, b] = relazi_loc


def _trace_nadir(
    ri, mu_abs, radii, re, cos_sza, relazi, downward,
    od_weights, sun_weights, interp_weights, lengths, mask,
    cos_scatter, cos_zenith, cos_sza_b,
    seg_layer, seg_entrance_frac, seg_exit_frac, boundary_relazi,
    cos2rot, sin2rot,
    sun_od_fn=None,
):
    """Ground-viewing (downward) or upward-looking ray through all shells.

    For a downward-looking observer above the atmosphere the far end is the
    ground; segments run ground -> TOA... actually ordered from far end
    (ground) toward the observer (TOA). For upward-looking ground observer,
    far end is TOA.

    Straight-line spherical geometry: with observer zenith mu at the ground
    (or given reference location), the local zenith cosine varies with
    radius as mu(r) = sqrt(1 - (rt/r)^2), rt = r_ref sin(zen).
    """
    A = len(radii)
    r_ref = radii[0]  # angles defined at the ground point
    sin_v = np.sqrt(max(1.0 - mu_abs**2, 0.0))
    rt = r_ref * sin_v  # tangent radius of the extended line (below surface)
    coszen_ref = mu_abs if downward else -mu_abs
    sun_vec = _solar_frame(cos_sza, relazi, coszen_ref)
    cos2rot[ri, :], sin2rot[ri, :] = _stokes_rotation(
        np.array([sin_v, 0.0, coszen_ref]), sun_vec
    )
    l_ref = np.sqrt(max(r_ref**2 - rt**2, 0.0))

    def boundary_solar(r):
        l_r = np.sqrt(max(r**2 - rt**2, 0.0))
        s_dist = (l_r - l_ref) if downward else -(l_r - l_ref)
        return _solar_at_point(s_dist, r_ref, coszen_ref, sun_vec)

    # boundaries from ground (far, for downward) to TOA
    bounds = list(radii)
    nseg = A - 1
    for s in range(nseg):
        lo, hi = bounds[s], bounds[s + 1]
        l0 = np.sqrt(max(lo**2 - rt**2, 0.0))
        l1 = np.sqrt(max(hi**2 - rt**2, 0.0))
        ds = l1 - l0
        rm = 0.5 * (lo + hi)
        w_lo2, w_hi2 = _exact_shell_weights(l0, l1, rt, lo, hi)
        if downward:
            # far end = ground: segment order bottom-up
            sidx = s
            sgn = +1.0  # photons travel upward toward observer
        else:
            # far end = TOA: segment order top-down
            sidx = nseg - 1 - s
            sgn = -1.0  # photons travel downward toward ground observer
        od_weights[ri, sidx, s] = w_lo2
        od_weights[ri, sidx, s + 1] = w_hi2
        lengths[ri, sidx] = ds
        mask[ri, sidx] = 1.0
        # boundary[sidx] = far-side entrance of segment sidx
        boundary_r = lo if downward else hi
        bidx = sidx
        cs_b, cz_b, relazi_b, _ = boundary_solar(boundary_r)
        cos_zenith[ri, bidx] = cz_b
        cos_sza_b[ri, bidx] = cs_b
        cos_scatter[ri, bidx] = _scatter_cosine(cz_b, cs_b, relazi_b)
        interp_weights[ri, bidx] = _interp_weights_at_radius(boundary_r, radii)
        sun_weights[ri, bidx] = (
            _sun_od_weights(boundary_r, cs_b, radii, re)
            if sun_od_fn is None else sun_od_fn(boundary_r, cs_b)
        )
        # bottom-up layer s -> TOA-first; the photon enters at the layer
        # bottom when travelling upward (downward-looking observer)
        seg_layer[ri, sidx] = (nseg - 1) - s
        seg_entrance_frac[ri, sidx] = 1.0 if downward else 0.0
        seg_exit_frac[ri, sidx] = 0.0 if downward else 1.0
        boundary_relazi[ri, bidx] = relazi_b
    # the remaining boundary (observer side): TOA for downward-looking,
    # ground for upward-looking
    bidx = nseg
    boundary_r = radii[-1] if downward else radii[0]
    cs_b, cz_b, relazi_b, _ = boundary_solar(boundary_r)
    cos_zenith[ri, bidx] = cz_b
    cos_sza_b[ri, bidx] = cs_b
    cos_scatter[ri, bidx] = _scatter_cosine(cz_b, cs_b, relazi_b)
    interp_weights[ri, bidx] = _interp_weights_at_radius(boundary_r, radii)
    sun_weights[ri, bidx] = (
        _sun_od_weights(boundary_r, cs_b, radii, re)
        if sun_od_fn is None else sun_od_fn(boundary_r, cs_b)
    )
    boundary_relazi[ri, bidx] = relazi_b


def _curved_boundary(
    ri, b, r, phi, cos_prop, radii, sun_vec,
    sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
    boundary_relazi, sun_od_fn, cos2rot=None, sin2rot=None,
):
    """Boundary solar geometry for a refracted ray, evaluated in the ray
    plane: z = local up at the reference point, x = horizontal propagation
    direction there, phi = earth-center angle from the reference point
    (increasing along +x).  ``cos_prop`` is the radial cosine of the
    propagation direction at the boundary."""
    r_hat = np.array([np.sin(phi), 0.0, np.cos(phi)])
    phi_hat = np.array([np.cos(phi), 0.0, -np.sin(phi)])
    sin_prop = np.sqrt(max(1.0 - cos_prop * cos_prop, 0.0))
    d_hat = cos_prop * r_hat + sin_prop * phi_hat
    cs = float(np.dot(sun_vec, r_hat))
    cz = float(cos_prop)
    sz = np.sqrt(max(1.0 - cz * cz, 0.0))
    ss = np.sqrt(max(1.0 - cs * cs, 0.0))
    if sz * ss < 1e-12:
        relazi_loc = 0.0
    else:
        h_hat = (d_hat - cz * r_hat) / sz
        y_hat = np.cross(r_hat, h_hat)
        relazi_loc = float(
            np.arctan2(np.dot(sun_vec, y_hat), np.dot(sun_vec, h_hat))
        )
    cos_zenith[ri, b] = cz
    cos_sza_b[ri, b] = cs
    cos_scatter[ri, b] = _scatter_cosine(cz, cs, relazi_loc)
    interp_weights[ri, b] = _interp_weights_at_radius(r, radii)
    sun_weights[ri, b] = sun_od_fn(r, cs)
    boundary_relazi[ri, b] = relazi_loc
    if cos2rot is not None:
        cos2rot[ri, b], sin2rot[ri, b] = _stokes_rotation(d_hat, sun_vec)
    return cs, cz, relazi_loc


def _trace_limb_curved(
    ri, rt_straight, radii, re, cos_sza0, relazi, integ, sun_od_fn,
    od_weights, sun_weights, interp_weights, lengths, mask,
    cos_scatter, cos_zenith, cos_sza_b,
    seg_layer, seg_entrance_frac, seg_exit_frac, boundary_relazi,
    cos2rot, sin2rot,
):
    """Limb ray traced along the refracted (Bouguer) path.

    The straight-line tangent radius fixes the ray invariant (the observer
    sits in vacuum): n(rt) rt = rt_straight, so the refracted ray dips
    below the geometric tangent point (reference ``refraction.h:52-95``).
    Returns None, or (cos_sza, cos_vza, relazi) at the ground for rays bent
    into the surface.
    """
    A = len(radii)
    P = A - 1
    sun_vec = _solar_frame(cos_sza0, relazi, 0.0)
    rt = integ.tangent_radius(rt_straight)
    nt = integ.n_at(rt)
    hits_ground = rt < radii[0]

    if hits_ground:
        # observed branch: ground -> near TOA, ascending (photons leave the
        # surface upward toward the exo-atmospheric observer)
        bounds = list(radii)
        signs = [+1.0] * (len(bounds) - 1)
        phi0 = integ.shell_integral(rt, nt, rt, radii[0], rt, radii[0])[3]
    else:
        jt = np.searchsorted(radii, rt)
        desc = list(range(A - 1, jt - 1, -1))
        bounds = (
            [radii[j] for j in desc] + [rt] + [radii[j] for j in reversed(desc)]
        )
        signs = [-1.0] * len(desc) + [+1.0] * len(desc)
        phi0 = 0.0

    # phi at each boundary, accumulated along propagation from the far end
    nseg = len(bounds) - 1
    seg_data = []
    for s in range(nseg):
        r0, r1 = bounds[s], bounds[s + 1]
        lo, hi = min(r0, r1), max(r0, r1)
        if hi <= lo:
            seg_data.append(None)
            continue
        rm = 0.5 * (lo + hi)
        j = int(np.clip(np.searchsorted(radii, rm) - 1, 0, P - 1))
        seg_data.append(
            (j, *integ.shell_integral(rt, nt, lo, hi, radii[j], radii[j + 1]))
        )

    # phi of the far-end boundary: sum of swept angles from the tangent
    # (phi=0) out to the far end, negated (far side), plus the ground offset
    phi_far = phi0 if hits_ground else 0.0
    if not hits_ground:
        for s in range(nseg):
            if signs[s] < 0 and seg_data[s] is not None:
                phi_far += seg_data[s][4]
        phi_far = -phi_far
    ground_geo = None

    phi = phi_far
    s_out = 0
    for s in range(nseg):
        if seg_data[s] is None:
            continue
        j, length, w_lo, w_hi, dphi = seg_data[s]
        r_b = bounds[s]
        sinp = min(nt * rt / (integ.n_at(r_b) * r_b), 1.0) if r_b > 0 else 1.0
        cos_prop = signs[s] * np.sqrt(max(1.0 - sinp * sinp, 0.0))
        geo = _curved_boundary(
            ri, s_out, r_b, phi, cos_prop, radii, sun_vec,
            sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
            boundary_relazi, sun_od_fn, cos2rot, sin2rot,
        )
        if hits_ground and s == 0:
            ground_geo = (geo[0], abs(cos_prop), geo[2])
        od_weights[ri, s_out, j] = w_lo
        od_weights[ri, s_out, j + 1] = w_hi
        lengths[ri, s_out] = length
        mask[ri, s_out] = 1.0
        seg_layer[ri, s_out] = P - 1 - j
        dz_l = radii[j + 1] - radii[j]
        seg_entrance_frac[ri, s_out] = np.clip(
            (radii[j + 1] - bounds[s]) / dz_l, 0.0, 1.0
        )
        seg_exit_frac[ri, s_out] = np.clip(
            (radii[j + 1] - bounds[s + 1]) / dz_l, 0.0, 1.0
        )
        phi += dphi
        s_out += 1
    # observer-side boundary (TOA, ascending)
    r_b = bounds[-1]
    sinp = min(nt * rt / (integ.n_at(r_b) * r_b), 1.0)
    cos_prop = np.sqrt(max(1.0 - sinp * sinp, 0.0))
    _curved_boundary(
        ri, s_out, r_b, phi, cos_prop, radii, sun_vec,
        sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
        boundary_relazi, sun_od_fn, cos2rot, sin2rot,
    )
    return ground_geo


def _trace_nadir_curved(
    ri, mu_abs, radii, re, cos_sza, relazi, downward,
    od_weights, sun_weights, interp_weights, lengths, mask,
    cos_scatter, cos_zenith, cos_sza_b,
    seg_layer, seg_entrance_frac, seg_exit_frac, boundary_relazi,
    cos2rot, sin2rot,
    sun_od_fn=None, integ=None,
):
    """Refracted ground-viewing / upward-looking ray (angles defined at the
    ground reference point, as in the straight ``_trace_nadir``)."""
    A = len(radii)
    r_ref = radii[0]
    sin_v = np.sqrt(max(1.0 - mu_abs * mu_abs, 0.0))
    invariant = integ.n_at(r_ref) * r_ref * sin_v
    rt = integ.tangent_radius(invariant)
    rt = min(rt, r_ref)  # virtual tangent at/below the surface
    nt = integ.n_at(rt)
    coszen_ref = mu_abs if downward else -mu_abs
    sun_vec = _solar_frame(cos_sza, relazi, coszen_ref)

    nseg = A - 1
    # per-shell curved integrals, bottom-up, and cumulative phi from ground
    phi_lv = np.zeros(A)
    shell = []
    for s in range(nseg):
        j, (length, w_lo, w_hi, dphi) = s, integ.shell_integral(
            rt, nt, radii[s], radii[s + 1], radii[s], radii[s + 1]
        )
        shell.append((j, length, w_lo, w_hi))
        phi_lv[s + 1] = phi_lv[s] + dphi

    def boundary(b_out, r, lvl, ascending_prop):
        sinp = min(nt * rt / (integ.n_at(r) * r), 1.0)
        cos_prop = (1.0 if ascending_prop else -1.0) * np.sqrt(
            max(1.0 - sinp * sinp, 0.0)
        )
        phi = phi_lv[lvl] if downward else -phi_lv[lvl]
        _curved_boundary(
            ri, b_out, r, phi, cos_prop, radii, sun_vec,
            sun_weights, interp_weights, cos_scatter, cos_zenith, cos_sza_b,
            boundary_relazi, sun_od_fn, cos2rot, sin2rot,
        )

    for s in range(nseg):
        j, length, w_lo, w_hi = shell[s]
        if downward:
            sidx = s  # far end = ground, segments bottom-up
        else:
            sidx = nseg - 1 - s  # far end = TOA
        od_weights[ri, sidx, s] = w_lo
        od_weights[ri, sidx, s + 1] = w_hi
        lengths[ri, sidx] = length
        mask[ri, sidx] = 1.0
        seg_layer[ri, sidx] = (nseg - 1) - s
        seg_entrance_frac[ri, sidx] = 1.0 if downward else 0.0
        seg_exit_frac[ri, sidx] = 0.0 if downward else 1.0
        # far-side entrance boundary of segment sidx
        boundary(sidx, radii[s] if downward else radii[s + 1],
                 s if downward else s + 1, downward)
    # observer-side boundary
    boundary(nseg, radii[-1] if downward else radii[0],
             nseg if downward else 0, downward)


def _trace_native(radii, earth_radius_m, rays) -> TracedRays | None:
    """Dispatch to the C++ tracer when every ray type is supported."""
    from ..native import native_trace
    from ..viewinggeo import (
        GroundViewingSolar,
        SolarAnglesObserverLocation,
        TangentAltitudeSolar,
    )

    kinds = []
    params = []
    tangent_alt = []
    for ray in rays:
        if isinstance(ray, TangentAltitudeSolar):
            kinds.append(0)
            params.append([
                earth_radius_m + ray.tangent_altitude_m,
                ray.cos_sza, ray.relative_azimuth,
            ])
            tangent_alt.append(ray.tangent_altitude_m)
        elif isinstance(ray, (GroundViewingSolar, SolarAnglesObserverLocation)):
            down = isinstance(ray, GroundViewingSolar) or (
                ray.cos_viewing_zenith < 0.0
            )
            kinds.append(1 if down else 2)
            params.append([
                abs(ray.cos_viewing_zenith), ray.cos_sza,
                ray.relative_azimuth,
            ])
            tangent_alt.append(np.nan)
        else:
            return None
    out = native_trace(radii, earth_radius_m, kinds, params)
    if out is None:
        return None
    # straight rays: per-ray constant Stokes rotation from the ray spec
    nb = out["cos_scatter"].shape[1]
    cos2rot = np.ones((len(rays), nb))
    sin2rot = np.zeros((len(rays), nb))
    for ri, (kind, p) in enumerate(zip(kinds, params)):
        if kind == 0:
            d_hat = np.array([1.0, 0.0, 0.0])
            sun_vec = _solar_frame(p[1], p[2], 0.0)
        else:
            mu_abs = p[0]
            coszen_ref = mu_abs if kind == 1 else -mu_abs
            sin_v = np.sqrt(max(1.0 - mu_abs * mu_abs, 0.0))
            d_hat = np.array([sin_v, 0.0, coszen_ref])
            sun_vec = _solar_frame(p[1], p[2], coszen_ref)
        cos2rot[ri, :], sin2rot[ri, :] = _stokes_rotation(d_hat, sun_vec)
    return TracedRays(
        od_weights=out["od_weights"],
        sun_weights=out["sun_weights"],
        interp_weights=out["interp_weights"],
        lengths=out["lengths"],
        mask=out["mask"],
        cos_scatter=out["cos_scatter"],
        cos_zenith=out["cos_zenith"],
        cos_sza=out["cos_sza"],
        ground_hit=out["ground_hit"].astype(bool),
        ground_cos_sza=out["ground_cos_sza"],
        ground_cos_vza=out["ground_cos_vza"],
        ground_relazi=out["ground_relazi"],
        tangent_altitude=np.array(tangent_alt),
        seg_layer=out["seg_layer"],
        seg_entrance_frac=out["seg_entrance_frac"],
        seg_exit_frac=out["seg_exit_frac"],
        boundary_relazi=out["boundary_relazi"],
        cos2rot=cos2rot,
        sin2rot=sin2rot,
    )


def apply_solar_table(traced: TracedRays, altitudes_m, earth_radius_m,
                      n_sza: int = 100) -> TracedRays:
    """Replace the exact per-boundary solar OD weights with rows
    interpolated from a precomputed (altitude x cos_sza) table — the
    ``SingleScatterSource.Table`` mode (reference
    ``cpp/lib/solar/solartransmissiontable.cpp``: trace rays to the sun
    from every (level, SZA-grid) point once, then bilinearly interpolate
    OD at each ray boundary).

    Because both the table and the interpolation are static, the result is
    simply a recomposed ``sun_weights`` array — the jitted compute path is
    identical to the exact mode.
    """
    alts = np.asarray(altitudes_m, dtype=np.float64)
    radii = earth_radius_m + alts
    A = len(alts)

    # cos_sza grid spanning the rays' boundary values (reference
    # min_max_cos_sza_of_all_rays; 100-point grid)
    bmask = np.zeros_like(traced.cos_sza)
    bmask[:, :-1] += traced.mask
    bmask[:, 1:] += traced.mask
    valid = bmask > 0
    cs = traced.cos_sza[valid]
    lo, hi = float(cs.min()), float(cs.max())
    if hi - lo < 1e-9:
        hi = lo + 1e-9
    sza_grid = np.linspace(lo, hi, max(2, n_sza))
    G = sza_grid.size

    # table rows: OD-to-sun weight vectors at every (level, sza) node
    table = np.zeros((A, G, A))
    for a in range(A):
        for g in range(G):
            table[a, g] = _sun_od_weights(
                radii[a], float(sza_grid[g]), radii, earth_radius_m
            )

    # boundary coordinates: altitude from the interpolation weights,
    # cos_sza stored directly
    b_alt = traced.interp_weights @ alts            # [R, S+1]
    b_cs = np.clip(traced.cos_sza, sza_grid[0], sza_grid[-1])

    ja = np.clip(np.searchsorted(alts, b_alt) - 1, 0, A - 2)
    fa = np.clip(
        (b_alt - alts[ja]) / (alts[ja + 1] - alts[ja]), 0.0, 1.0
    )
    jg = np.clip(np.searchsorted(sza_grid, b_cs) - 1, 0, G - 2)
    fg = np.clip(
        (b_cs - sza_grid[jg]) / (sza_grid[jg + 1] - sza_grid[jg]),
        0.0, 1.0,
    )

    fa_, fg_ = fa[..., None], fg[..., None]
    sun_weights = (
        (1 - fa_) * ((1 - fg_) * table[ja, jg] + fg_ * table[ja, jg + 1])
        + fa_ * ((1 - fg_) * table[ja + 1, jg]
                 + fg_ * table[ja + 1, jg + 1])
    )
    # masked boundaries keep zero weights so padded segments stay inert
    sun_weights *= (valid > 0)[..., None]

    from dataclasses import replace

    return replace(traced, sun_weights=sun_weights)
