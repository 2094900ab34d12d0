"""Refractive ray bending through spherical shells.

(Copy of ``sasktran2_tpu/rt/refraction.py`` for the PyTorch port.)

The reference implements refraction with a refractive-index profile on the
geometry altitude grid (log-linearly interpolated), an iteratively solved
refracted tangent radius, and Thompson (1982) path/deflection integrals
(``upstream SASKTRAN2 cpp/include/sasktran2/refraction.h:21-110``,
``cpp/lib/raytracing/refraction.cpp``).

Here the same physics is expressed through Bouguer's invariant for a
spherically symmetric refractive index:

    n(r) * r * sin(theta) = const = n(rt) * rt

so along the curved ray, with s = sqrt(r^2 - rt^2) the straight-line arc
variable (which removes the tangent-point square-root singularity),

    dl   = n(r) * s / sqrt(n(r)^2 r^2 - nt^2 rt^2) ds     (path length)
    dphi = nt * rt * s / (r^2 sqrt(n^2 r^2 - nt^2 rt^2)) ds (earth angle)

Each integral is evaluated with fixed-order Gauss-Legendre quadrature per
shell, yielding the same static weight-table form as the straight tracer
(``rt/raytrace.py``): seg_od = w_lo * k(r_lo) + w_hi * k(r_hi).  With
n == 1 every expression reduces exactly to the straight-line geometry.
"""

from __future__ import annotations

import numpy as np

_GAUSS_N = 8
_GX, _GW = np.polynomial.legendre.leggauss(_GAUSS_N)


class RefractiveShellIntegrator:
    """Per-geometry helper: refractive profile + curved-path shell integrals.

    Parameters
    ----------
    radii : [A] level radii in m (strictly increasing)
    n_levels : [A] refractive index at the levels (>= 1), or ``None`` for
        vacuum (straight rays)
    """

    def __init__(self, radii: np.ndarray, n_levels: np.ndarray | None):
        self.radii = np.asarray(radii, dtype=np.float64)
        if n_levels is None:
            n_levels = np.ones_like(self.radii)
        self.n_levels = np.asarray(n_levels, dtype=np.float64)
        if np.any(self.n_levels < 1.0 - 1e-12):
            msg = "refractive index must be >= 1"
            raise ValueError(msg)
        self._log_n = np.log(self.n_levels)

    def n_at(self, r):
        """Refractive index at radius r: log-linear interpolation, clamped
        (reference ``refraction.h:21-39`` interpolates log(n) in altitude)."""
        return np.exp(np.interp(r, self.radii, self._log_n))

    def tangent_radius(self, invariant: float) -> float:
        """Solve n(rt) * rt = invariant for rt (fixed point, mirrors the
        reference's iteration ``refraction.h:52-95``).

        ``invariant`` is n*r*sin(zenith) evaluated anywhere on the ray; for
        an exo-atmospheric observer it equals the straight-line tangent
        radius.
        """
        rt = invariant
        for _ in range(200):
            nxt = invariant / self.n_at(rt)
            if abs(nxt - rt) < 1e-9:
                return nxt
            rt = nxt
        return rt

    def shell_integral(self, rt, nt, r0, r1, r_lo, r_hi):
        """Curved-path integrals across the part [r0, r1] of shell
        [r_lo, r_hi].

        Returns (length, w_lo, w_hi, dphi):
          length : geometric path length in the sub-shell
          w_lo/w_hi : OD weights for extinction linear in radius between
              the shell's bounding levels
          dphi : earth-center angle swept
        """
        lo, hi = (r0, r1) if r1 >= r0 else (r1, r0)
        s0 = np.sqrt(max(lo * lo - rt * rt, 0.0))
        s1 = np.sqrt(max(hi * hi - rt * rt, 0.0))
        if s1 <= s0:
            return 0.0, 0.0, 0.0, 0.0
        half = 0.5 * (s1 - s0)
        mid = 0.5 * (s1 + s0)
        s = mid + half * _GX
        r = np.hypot(rt, s)
        n = self.n_at(r)
        nr = n * r
        ntrt = nt * rt
        # (nr - ntrt)(nr + ntrt), with the difference computed stably near
        # the tangent point via r - rt = s^2 / (r + rt)
        if rt > 0.0:
            # n*r - nt*rt = n*(r - rt) + rt*(n - nt); both factors -> 0 at
            # the tangent like s^2
            diff = n * (s * s / (r + rt)) + rt * (n - nt)
            det = np.sqrt(np.maximum(diff * (nr + ntrt), 1e-300))
        else:
            det = nr
        dl_ds = n * s / det
        dphi_ds = np.zeros_like(s) if rt == 0.0 else ntrt * s / (r * r * det)
        wq = _GW * half
        length = float(np.sum(wq * dl_ds))
        dphi = float(np.sum(wq * dphi_ds))
        dr_shell = r_hi - r_lo
        if dr_shell <= 0:
            return length, length, 0.0, dphi
        f_hi = np.clip((r - r_lo) / dr_shell, 0.0, 1.0)
        w_hi = float(np.sum(wq * dl_ds * f_hi))
        w_lo = length - w_hi
        return length, w_lo, w_hi, dphi

    def sun_od_weights(self, r, cos_sza_local, earth_radius):
        """OD-to-sun weight row from radius r with local cos SZA, along the
        *refracted* solar ray (refractive analog of the straight
        ``raytrace._sun_od_weights``).

        Returns [A] weights such that sun_od = weights . extinction_levels.
        """
        radii = self.radii
        A = len(radii)
        w = np.zeros(A)
        sin_sza = np.sqrt(max(1.0 - cos_sza_local**2, 0.0))
        invariant = self.n_at(r) * r * sin_sza
        rt = self.tangent_radius(invariant)
        nt = self.n_at(rt)
        if cos_sza_local < 0.0 and rt <= earth_radius:
            w[0] = 1e10  # sun below horizon: fully attenuated
            return w

        def leg(r_from, r_to):
            jf = np.clip(np.searchsorted(radii, r_from, side="right") - 1,
                         0, A - 2)
            jt = np.clip(np.searchsorted(radii, r_to, side="right") - 1,
                         0, A - 2)
            r0 = r_from
            for j in range(jf, jt + 1):
                r1 = min(radii[j + 1], r_to)
                if r1 <= r0:
                    continue
                _, w_lo, w_hi, _ = self.shell_integral(
                    rt, nt, r0, r1, radii[j], radii[j + 1]
                )
                w[j] += w_lo
                w[j + 1] += w_hi
                r0 = r1

        if cos_sza_local >= 0.0:
            leg(max(r, radii[0]), radii[-1])
        else:
            leg(max(rt, radii[0]), r)
            leg(max(rt, radii[0]), radii[-1])
        return w

    def chapman_row(self, r_b, cos_sza):
        """Refracted chapman factors: slant path length of the solar beam
        within each shell above radius ``r_b``, divided by the shell
        thickness.  Returns [A-1] bottom-up per-shell factors (zero below
        r_b's shell)."""
        radii = self.radii
        A = len(radii)
        out = np.zeros(A - 1)
        sin_sza = np.sqrt(max(1.0 - cos_sza**2, 0.0))
        invariant = self.n_at(r_b) * r_b * sin_sza
        rt = self.tangent_radius(invariant)
        nt = self.n_at(rt)
        j0 = int(np.clip(np.searchsorted(radii, r_b, side="right") - 1,
                         0, A - 2))
        r0 = r_b
        for j in range(j0, A - 1):
            r1 = radii[j + 1]
            if r1 <= r0:
                continue
            length, _, _, _ = self.shell_integral(
                rt, nt, r0, r1, radii[j], radii[j + 1]
            )
            out[j] = length / (radii[j + 1] - radii[j])
            r0 = r1
        return out
