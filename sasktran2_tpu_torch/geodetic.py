"""WGS84 geodetic calculations.

Role of the reference's ``cpp/lib/geometry/geodetic.cpp`` /
``src/sasktran2/geodetic.py:8-306``: oblate-spheroid coordinate transforms,
tangent points, and altitude intercepts for building viewing geometry from
real observer/look-vector data. Pure numpy (host-side geometry only).

(Copy of ``sasktran2_tpu/geodetic.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563


class Geodetic:
    """An oblate-spheroid earth model (defaults to WGS84)."""

    def __init__(self, equatorial_radius_m: float = WGS84_A,
                 flattening: float = WGS84_F):
        self.a = float(equatorial_radius_m)
        self.f = float(flattening)
        self.b = self.a * (1.0 - self.f)
        self.e2 = 1.0 - (self.b / self.a) ** 2
        self._lat = None
        self._lon = None
        self._alt = None
        self._location = None

    # --- state accessors (reference property surface) --------------------
    @property
    def latitude(self):
        return self._lat

    @property
    def longitude(self):
        return self._lon

    @property
    def altitude(self):
        return self._alt

    @property
    def location(self):
        return self._location

    @property
    def local_up(self):
        lat, lon = np.deg2rad(self._lat), np.deg2rad(self._lon)
        return np.array([
            np.cos(lat) * np.cos(lon),
            np.cos(lat) * np.sin(lon),
            np.sin(lat),
        ])

    @property
    def local_south(self):
        lat, lon = np.deg2rad(self._lat), np.deg2rad(self._lon)
        return np.array([
            np.sin(lat) * np.cos(lon),
            np.sin(lat) * np.sin(lon),
            -np.cos(lat),
        ])

    @property
    def local_west(self):
        lon = np.deg2rad(self._lon)
        return np.array([np.sin(lon), -np.cos(lon), 0.0])

    # --- transforms -------------------------------------------------------
    def from_lat_lon_alt(self, latitude, longitude, altitude):
        """Set state from geodetic coordinates (degrees, meters)."""
        self._lat = float(latitude)
        self._lon = float(longitude)
        self._alt = float(altitude)
        lat = np.deg2rad(self._lat)
        lon = np.deg2rad(self._lon)
        n = self.a / np.sqrt(1.0 - self.e2 * np.sin(lat) ** 2)
        x = (n + altitude) * np.cos(lat) * np.cos(lon)
        y = (n + altitude) * np.cos(lat) * np.sin(lon)
        z = (n * (1.0 - self.e2) + altitude) * np.sin(lat)
        self._location = np.array([x, y, z])
        return self

    def from_xyz(self, location):
        """Set state from an ECEF position [m] (iterative Bowring method)."""
        x, y, z = (float(v) for v in location)
        self._location = np.array([x, y, z])
        lon = np.arctan2(y, x)
        p = np.hypot(x, y)
        # Bowring's iteration
        beta = np.arctan2(z * self.a, p * self.b)
        for _ in range(5):
            lat = np.arctan2(
                z + self.e2 / (1 - self.e2) * self.b * np.sin(beta) ** 3,
                p - self.e2 * self.a * np.cos(beta) ** 3,
            )
            beta = np.arctan2((1 - self.f) * np.sin(lat), np.cos(lat))
        n = self.a / np.sqrt(1.0 - self.e2 * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        self._lat = float(np.rad2deg(lat))
        self._lon = float(np.rad2deg(lon))
        self._alt = float(alt)
        return self

    def from_tangent_point(self, observer, look_vector):
        """Set state to the tangent point of a look ray (the point of
        minimum geodetic altitude along the line)."""
        observer = np.asarray(observer, dtype=np.float64)
        look = np.asarray(look_vector, dtype=np.float64)
        look = look / np.linalg.norm(look)
        # scale z to sphere-ize the ellipsoid, then minimize |r(s)|
        scale = np.array([1.0, 1.0, self.a / self.b])
        o = observer * scale
        l_vec = look * scale
        s = -np.dot(o, l_vec) / np.dot(l_vec, l_vec)
        self.from_xyz(observer + s * look)
        return self

    def from_tangent_altitude(self, altitude, observer, boresight):
        """Find the look vector with the given tangent altitude. ``boresight``
        is an approximate look direction; the rotation happens in the
        (boresight, up) plane. Returns the look vector (unit)."""
        observer = np.asarray(observer, dtype=np.float64)
        bore = np.asarray(boresight, dtype=np.float64)
        bore = bore / np.linalg.norm(bore)
        up = observer / np.linalg.norm(observer)
        # component of boresight perpendicular to up, in-plane basis
        horiz = bore - np.dot(bore, up) * up
        horiz /= np.linalg.norm(horiz)

        def tangent_alt(theta):
            look = np.cos(theta) * horiz - np.sin(theta) * up
            g = Geodetic(self.a, self.f).from_tangent_point(observer, look)
            return g.altitude

        lo, hi = 0.0, np.pi / 2 - 1e-6
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if tangent_alt(mid) > altitude:
                lo = mid
            else:
                hi = mid
        theta = 0.5 * (lo + hi)
        look = np.cos(theta) * horiz - np.sin(theta) * up
        self.from_tangent_point(observer, look)
        return look

    def osculating_spheroid(self):
        """Best-fit sphere to the geoid at the current location (reference
        ``Geodetic.osculating_spheroid``, ``src/sasktran2/geodetic.py:259``
        and ``cpp/lib/geometry/geodetic.cpp:283``): the meridian-plane
        radius of curvature at the sub-point on the surface, and the offset
        of the sphere's center from the geocenter.

        Returns (radius_m, offset_xyz). This is the machinery behind
        ``GeometryType.Ellipsoidal``: build the 1D model with
        ``earth_radius_m = radius`` and altitudes referenced to the
        osculating sphere so limb rays bend around the locally-correct
        curvature instead of the mean sphere.
        """
        lat = np.deg2rad(self._lat)
        lon = np.deg2rad(self._lon)
        a, b = self.a, self.b
        # surface sub-point in the meridian plane (x horizontal, y = z axis)
        # geodetic-to-geocentric at altitude 0:
        n = a / np.sqrt(1.0 - self.e2 * np.sin(lat) ** 2)
        x0 = n * np.cos(lat)
        y0 = n * (1.0 - self.e2) * np.sin(lat)
        a2y0 = a * a * y0
        b2x0 = b * b * x0
        r = (a2y0 * y0 / (b * b) + b2x0 * x0 / (a * a)) ** 1.5 / (a * b)
        theta = np.arctan2(a2y0, b2x0)
        dx = r * np.cos(theta)
        dy = r * np.sin(theta)
        xunit = np.array([np.cos(lon), np.sin(lon), 0.0])
        yunit = np.array([0.0, 0.0, 1.0])
        offset = (x0 - dx) * xunit + (y0 - dy) * yunit
        return float(r), offset

    def altitude_intercepts(self, altitude, observer, look_vector):
        """(entrance, exit) ECEF intersections of the ray with the given
        altitude shell, or (None, None) if it misses."""
        observer = np.asarray(observer, dtype=np.float64)
        look = np.asarray(look_vector, dtype=np.float64)
        look = look / np.linalg.norm(look)

        def alt_at(s):
            return Geodetic(self.a, self.f).from_xyz(observer + s * look).altitude

        tan = Geodetic(self.a, self.f)
        tan.from_tangent_point(observer, look)
        s_tan = np.dot(tan.location - observer, look)
        if tan.altitude > altitude:
            return None, None

        def bisect(s_out, s_in):
            for _ in range(80):
                mid = 0.5 * (s_out + s_in)
                if alt_at(mid) > altitude:
                    s_out = mid
                else:
                    s_in = mid
            return 0.5 * (s_out + s_in)

        span = 2.0 * self.a
        s1 = bisect(min(0.0, s_tan - span), s_tan)
        s2 = bisect(s_tan + span, s_tan)
        return observer + s1 * look, observer + s2 * look
