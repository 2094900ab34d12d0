"""Solar position geometry (role of the reference's astropy-based solar
angles). Low-precision analytic ephemeris (Meeus) — sufficient for
radiative transfer solar zenith/azimuth (~0.01 deg).

(Copy of ``sasktran2_tpu/solar/geometry.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np


def solar_angles_from_times(mjd, latitude_deg, longitude_deg):
    """(cos_sza, solar_azimuth_rad) for modified Julian dates at a
    location. Azimuth measured east of north."""
    mjd = np.atleast_1d(np.asarray(mjd, dtype=np.float64))
    # julian centuries from J2000
    t = (mjd - 51544.5) / 36525.0
    # mean longitude / anomaly [deg]
    L0 = (280.46646 + 36000.76983 * t) % 360.0
    M = np.deg2rad((357.52911 + 35999.05029 * t) % 360.0)
    # equation of center
    C = (
        (1.914602 - 0.004817 * t) * np.sin(M)
        + (0.019993 - 0.000101 * t) * np.sin(2 * M)
        + 0.000289 * np.sin(3 * M)
    )
    true_lon = np.deg2rad(L0 + C)
    eps = np.deg2rad(23.439291 - 0.0130042 * t)
    # declination & right ascension
    dec = np.arcsin(np.sin(eps) * np.sin(true_lon))
    ra = np.arctan2(np.cos(eps) * np.sin(true_lon), np.cos(true_lon))
    # greenwich mean sidereal time [deg]
    gmst = (280.46061837 + 360.98564736629 * (mjd - 51544.5)) % 360.0
    ha = np.deg2rad(gmst) + np.deg2rad(longitude_deg) - ra
    lat = np.deg2rad(latitude_deg)
    cos_sza = np.sin(lat) * np.sin(dec) + np.cos(lat) * np.cos(dec) * np.cos(ha)
    az = np.arctan2(
        -np.sin(ha) * np.cos(dec),
        np.sin(dec) * np.cos(lat) - np.cos(dec) * np.sin(lat) * np.cos(ha),
    )
    return cos_sza, az % (2 * np.pi)


def to_mjd(time) -> float:
    """Modified Julian date from a pandas Timestamp / datetime64 / float."""
    if isinstance(time, (int, float)):
        return float(time)
    import pandas as pd

    ts = pd.Timestamp(time)
    return float((ts - pd.Timestamp("1858-11-17")) / pd.Timedelta(days=1))


class SolarGeometryHandlerBase:
    """Solar-angle lookup interface (reference
    ``src/sasktran2/solar/__init__.py:12-44``): given (lat [deg N],
    lon [deg E], alt [m], time), return (solar zenith, solar azimuth) in
    degrees, azimuth clockwise from north pointing toward the sun."""

    def target_solar_angles(self, latitude, longitude, altitude, time):
        raise NotImplementedError


class SolarGeometryHandlerForced(SolarGeometryHandlerBase):
    """Fixed solar angles for all locations/times (reference ``:46-70``)."""

    def __init__(self, solar_zenith: float, solar_azimuth: float):
        self.solar_zenith = float(solar_zenith)
        self.solar_azimuth = float(solar_azimuth)

    def target_solar_angles(self, latitude, longitude, altitude, time):
        return self.solar_zenith, self.solar_azimuth


class SolarGeometryHandlerEphemeris(SolarGeometryHandlerBase):
    """Analytic (Meeus) solar ephemeris — fills the role of the reference's
    astropy-based ``SolarGeometryHandlerAstropy`` without an astropy
    dependency (~0.01 deg accuracy)."""

    def target_solar_angles(self, latitude, longitude, altitude, time):
        cos_sza, az = solar_angles_from_times(
            to_mjd(time), latitude, longitude
        )
        return (
            float(np.rad2deg(np.arccos(np.clip(cos_sza, -1.0, 1.0))[0])),
            float(np.rad2deg(az[0])),
        )


# API-parity alias: the reference exposes the astropy-backed handler under
# this name; here it is the dependency-free ephemeris.
SolarGeometryHandlerAstropy = SolarGeometryHandlerEphemeris
