"""Straight limb rays through spherical shells, for the reference.

A frozen copy of the numpy tracer of ``sasktran2_tpu_torch/rt/raytrace.py``
(``trace_spherical`` with linear interpolation in radius, no refraction,
tangent-altitude rays only), kept under the benchmark so that the
reference reads none of the port's tables. For each ray: the segments
from the far top of the atmosphere through the tangent point to the near
one, each segment's optical-depth weights over the levels (extinction
linear in radius, integrated exactly), the solar slant path from every
segment boundary, and the local geometry there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Traced:
    """Padded per-ray tables, S segments and S + 1 boundaries a ray."""

    od_weights: np.ndarray        # [R, S, A]
    sun_weights: np.ndarray       # [R, S+1, A]
    interp_weights: np.ndarray    # [R, S+1, A]
    lengths: np.ndarray           # [R, S]
    mask: np.ndarray              # [R, S]
    cos_scatter: np.ndarray       # [R, S+1]
    cos_zenith: np.ndarray        # [R, S+1]
    cos_sza: np.ndarray           # [R, S+1]
    seg_layer: np.ndarray         # [R, S] TOA-first layer of each segment
    seg_entrance_frac: np.ndarray  # [R, S] depth fraction in the layer
    seg_exit_frac: np.ndarray     # [R, S]
    boundary_relazi: np.ndarray   # [R, S+1]


def _shell_weights(l0, l1, rt, r_lo, r_hi):
    """(w_lo, w_hi): the integral of extinction, linear in radius between
    r_lo and r_hi, over the signed distances [l0, l1] from the tangent
    point, as weights of the two level values."""
    dl = l1 - l0
    if dl <= 0:
        return 0.0, 0.0

    def F(l):
        r = np.hypot(rt, l)
        if rt > 0:
            return 0.5 * (l * r + rt * rt * np.arcsinh(l / rt))
        return 0.5 * l * abs(l)

    dr = r_hi - r_lo
    if dr <= 0:
        return dl, 0.0
    w_hi = min(max(((F(l1) - F(l0)) - r_lo * dl) / dr, 0.0), dl)
    return dl - w_hi, w_hi


def _interp_weights(r, radii):
    w = np.zeros(len(radii))
    if r <= radii[0]:
        w[0] = 1.0
    elif r >= radii[-1]:
        w[-1] = 1.0
    else:
        j = np.searchsorted(radii, r, side="right") - 1
        f = (r - radii[j]) / (radii[j + 1] - radii[j])
        w[j], w[j + 1] = 1.0 - f, f
    return w


def _sun_weights(r, cos_sza, radii, earth_radius):
    """Weights of the level extinctions in the optical depth from radius
    r to the top of the atmosphere toward the sun."""
    A = len(radii)
    w = np.zeros(A)
    rt = r * np.sqrt(max(1.0 - cos_sza**2, 0.0))
    if cos_sza < 0.0 and rt <= earth_radius:
        w[0] = 1e10
        return w

    def leg(r_from, r_to):
        jf = np.clip(np.searchsorted(radii, r_from, side="right") - 1, 0, A - 2)
        jt = np.clip(np.searchsorted(radii, r_to, side="right") - 1, 0, A - 2)
        r0 = r_from
        for j in range(jf, jt + 1):
            r1 = min(radii[j + 1], r_to)
            if r1 <= r0:
                continue
            l0 = np.sqrt(max(r0**2 - rt**2, 0.0))
            l1 = np.sqrt(max(r1**2 - rt**2, 0.0))
            a, b = _shell_weights(l0, l1, rt, radii[j], radii[j + 1])
            w[j] += a
            w[j + 1] += b
            r0 = r1

    if cos_sza >= 0.0:
        leg(r, radii[-1])
    else:
        leg(max(rt, radii[0]), r)
        leg(max(rt, radii[0]), radii[-1])
    return w


def _solar_at_point(s_dist, r_ref, sun_vec):
    """(cos_sza, cos_zenith, relative azimuth) at distance ``s_dist``
    along a horizontal ray from its tangent point at radius ``r_ref``."""
    p_hat = np.array([1.0, 0.0, 0.0])
    r_vec = np.array([0.0, 0.0, r_ref]) + s_dist * p_hat
    r_hat = r_vec / np.linalg.norm(r_vec)
    cs = float(np.dot(sun_vec, r_hat))
    cz = float(np.dot(p_hat, r_hat))
    sz = np.sqrt(max(1.0 - cz * cz, 0.0))
    ss = np.sqrt(max(1.0 - cs * cs, 0.0))
    if sz * ss < 1e-12:
        return cs, cz, 0.0
    h_hat = (p_hat - cz * r_hat) / sz
    y_hat = np.cross(r_hat, h_hat)
    return cs, cz, float(np.arctan2(np.dot(sun_vec, y_hat),
                                    np.dot(sun_vec, h_hat)))


def trace_limb(altitudes_m, earth_radius_m, rays):
    """Trace ``rays``, each (tangent altitude [m], cos_sza at the tangent
    point, relative azimuth [rad])."""
    radii = earth_radius_m + np.asarray(altitudes_m, dtype=np.float64)
    A = len(radii)
    P = A - 1
    R = len(rays)
    S = 2 * P
    z = lambda *shape: np.zeros(shape)  # noqa: E731
    t = Traced(z(R, S, A), z(R, S + 1, A), z(R, S + 1, A), z(R, S), z(R, S),
               z(R, S + 1), z(R, S + 1), z(R, S + 1),
               np.zeros((R, S), dtype=np.int64), z(R, S), z(R, S),
               z(R, S + 1))
    for ri, (talt, cos_sza, relazi) in enumerate(rays):
        rt = earth_radius_m + talt
        ss = np.sqrt(max(1.0 - cos_sza**2, 0.0))
        sun_vec = np.array([ss * np.cos(relazi), ss * np.sin(relazi), cos_sza])
        jt = np.searchsorted(radii, rt)
        desc = list(range(A - 1, jt - 1, -1))
        bounds = ([radii[j] for j in desc] + [rt]
                  + [radii[j] for j in reversed(desc)])
        signs = [-1.0] * len(desc) + [1.0] * len(desc)

        def boundary(b, r, sign):
            s_dist = sign * np.sqrt(max(r**2 - rt**2, 0.0))
            cs, cz, az = _solar_at_point(s_dist, rt, sun_vec)
            t.cos_zenith[ri, b] = cz
            t.cos_sza[ri, b] = cs
            sin_z = np.sqrt(max(1.0 - cz**2, 0.0))
            sin_s = np.sqrt(max(1.0 - cs**2, 0.0))
            t.cos_scatter[ri, b] = -cz * cs - sin_z * sin_s * np.cos(az)
            t.interp_weights[ri, b] = _interp_weights(r, radii)
            t.sun_weights[ri, b] = _sun_weights(r, cs, radii, earth_radius_m)
            t.boundary_relazi[ri, b] = az

        s_out = 0
        for s in range(len(bounds) - 1):
            lo, hi = sorted((bounds[s], bounds[s + 1]))
            l_lo = np.sqrt(max(lo**2 - rt**2, 0.0))
            l_hi = np.sqrt(max(hi**2 - rt**2, 0.0))
            if l_hi - l_lo <= 0.0:
                continue
            j = int(np.clip(np.searchsorted(radii, 0.5 * (lo + hi)) - 1, 0, P - 1))
            a, b = _shell_weights(l_lo, l_hi, rt, radii[j], radii[j + 1])
            t.od_weights[ri, s_out, j] = a
            t.od_weights[ri, s_out, j + 1] = b
            t.lengths[ri, s_out] = l_hi - l_lo
            t.mask[ri, s_out] = 1.0
            t.seg_layer[ri, s_out] = P - 1 - j
            dz = radii[j + 1] - radii[j]
            t.seg_entrance_frac[ri, s_out] = np.clip(
                (radii[j + 1] - bounds[s]) / dz, 0.0, 1.0)
            t.seg_exit_frac[ri, s_out] = np.clip(
                (radii[j + 1] - bounds[s + 1]) / dz, 0.0, 1.0)
            boundary(s_out, bounds[s], signs[s])
            s_out += 1
        boundary(s_out, bounds[-1], 1.0)
    return t
