"""ECEF-based viewing-geometry containers.

Role of the reference's ``src/sasktran2/viewinggeo/{base,ecef,
limbverticalimage}.py``: build engine ray policies from real spacecraft
observer positions / look vectors (ECEF) and observation times, carry the
per-ray geometry metadata, and merge it into the output radiance dataset.
All host-side numpy — this layer only *constructs* the static ray set that
parameterizes the jitted TPU pipeline.

(Copy of ``sasktran2_tpu/viewinggeo/containers.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from ..config import GeometryType, InterpolationMethod
from ..dataset import Dataset
from ..geodetic import Geodetic
from ..geometry import Geometry1D
from . import GroundViewingSolar, TangentAltitudeSolar, ViewingGeometry


def _wgs84():
    return Geodetic()


class ViewingGeometryContainer:
    """Mixin carrying a per-ray geometry metadata dataset (reference
    ``viewinggeo/base.py:9-27``)."""

    def __init__(self, geometry_ds: Dataset | None = None):
        self._geometry_ds = geometry_ds

    @property
    def geometry_ds(self) -> Dataset:
        return self._geometry_ds

    def add_geometry_to_radiance(self, radiance: Dataset) -> Dataset:
        if self._geometry_ds is not None:
            for k, v in self._geometry_ds.items():
                radiance[k] = v
            for k, v in self._geometry_ds.coords.items():
                radiance.coords.setdefault(k, v)
        return radiance

    def recommended_earth_radius(self) -> float:
        return 6371000.0

    def recommended_cos_sza(self) -> float:
        raise NotImplementedError

    def model_geometry(self, altitude_grid_m: np.ndarray) -> Geometry1D:
        raise NotImplementedError


def ecef_to_sasktran2_ray(
    observer,
    look_vector,
    time,
    geoid: Geodetic | None = None,
    solar_handler=None,
    ground_elevation: float = 0.0,
):
    """ECEF observer + look vector + time -> engine ray policy
    (reference ``viewinggeo/ecef.py:9-113``): a limb
    :class:`TangentAltitudeSolar` when the ray's tangent point is above
    ``ground_elevation``, otherwise a :class:`GroundViewingSolar`."""
    from ..solar import SolarGeometryHandlerForced

    if solar_handler is None:
        solar_handler = SolarGeometryHandlerForced(0.0, 0.0)
    if geoid is None:
        geoid = _wgs84()

    observer = np.asarray(observer, dtype=np.float64)
    look = np.asarray(look_vector, dtype=np.float64)
    norm = np.linalg.norm(look)
    if not np.isfinite(norm) or norm == 0.0:
        msg = "look_vector must be finite and non-zero"
        raise ValueError(msg)
    look = look / norm

    geoid.from_xyz(observer)
    obs_alt = geoid.altitude

    geoid.from_tangent_point(observer, look)
    if geoid.altitude > ground_elevation:
        solar_zenith, solar_azimuth = solar_handler.target_solar_angles(
            geoid.latitude, geoid.longitude, geoid.altitude, time
        )
        viewing_azimuth = -np.rad2deg(
            np.arctan2(
                np.dot(look, geoid.local_west),
                -np.dot(look, geoid.local_south),
            )
        )
        return TangentAltitudeSolar(
            tangent_altitude_m=geoid.altitude,
            relative_azimuth=np.deg2rad(solar_azimuth - viewing_azimuth),
            observer_altitude_m=obs_alt,
            cos_sza=np.cos(np.deg2rad(solar_zenith)),
        )

    # ground viewing
    entrance, _ = geoid.altitude_intercepts(ground_elevation, observer, look)
    geoid.from_xyz(entrance)
    solar_zenith, solar_azimuth = solar_handler.target_solar_angles(
        geoid.latitude, geoid.longitude, geoid.altitude, time
    )
    cos_viewing_zenith = -np.dot(look, geoid.local_up)
    if abs(cos_viewing_zenith) > 1.0 - 1e-8:
        viewing_azimuth = 0.0
    else:
        viewing_azimuth = -np.rad2deg(
            np.arctan2(
                np.dot(look, geoid.local_west),
                -np.dot(look, geoid.local_south),
            )
        )
    return GroundViewingSolar(
        cos_sza=np.cos(np.deg2rad(solar_zenith)),
        relative_azimuth=np.deg2rad(solar_azimuth - viewing_azimuth),
        cos_viewing_zenith=cos_viewing_zenith,
        observer_altitude_m=obs_alt,
    )


class LimbVertical(ViewingGeometry, ViewingGeometryContainer):
    """A vertical limb image: one limb ray per tangent altitude from a
    single (or per-ray) observer (reference
    ``viewinggeo/limbverticalimage.py:16-180``)."""

    def __init__(
        self,
        solar_handler,
        tangent_altitudes: np.ndarray,
        tangent_latitude,
        tangent_longitude,
        time,
        observer_altitude,
        observer_latitude,
        observer_longitude,
        reference_altitude: float = 25000.0,
    ):
        self._tangent_altitudes = np.asarray(tangent_altitudes, dtype=np.float64)
        n = len(self._tangent_altitudes)

        def to_array(param):
            if np.ndim(param) == 0:
                return np.array([param] * n)
            param = np.asarray(param)
            if len(param) != n:
                msg = "Parameter length mismatch."
                raise ValueError(msg)
            return param

        tangent_latitude = to_array(tangent_latitude)
        tangent_longitude = to_array(tangent_longitude)
        times = to_array(time)
        observer_altitude = to_array(observer_altitude)
        observer_latitude = to_array(observer_latitude)
        observer_longitude = to_array(observer_longitude)
        self._reference_altitude = float(reference_altitude)

        ViewingGeometry.__init__(self)

        self._cos_sza = np.zeros(n)
        self._earth_radius = np.zeros(n)
        solar_az = np.zeros(n)
        observer_az = np.zeros(n)
        viewing_zenith = np.zeros(n)
        viewing_azimuth = np.zeros(n)

        for i in range(n):
            alt = float(self._tangent_altitudes[i])
            tangent_geo = _wgs84().from_lat_lon_alt(
                tangent_latitude[i], tangent_longitude[i], alt
            )
            observer_geo = _wgs84().from_lat_lon_alt(
                observer_latitude[i], observer_longitude[i],
                observer_altitude[i],
            )
            solar_zenith, solar_azimuth = solar_handler.target_solar_angles(
                tangent_latitude[i], tangent_longitude[i], alt, times[i]
            )
            lv = tangent_geo.location - observer_geo.location
            lv = lv / np.linalg.norm(lv)
            # azimuth of the look direction at the tangent point, clockwise
            # from north (pointing away from the observer).  NOTE: the
            # reference subtracts this radian angle from the degree-valued
            # solar azimuth before deg2rad (limbverticalimage.py:128); here
            # both terms are converted to radians first.
            obs_azi = -np.arctan2(
                np.dot(lv, tangent_geo.local_west),
                -np.dot(lv, tangent_geo.local_south),
            )
            self.add_ray(
                TangentAltitudeSolar(
                    tangent_altitude_m=alt,
                    relative_azimuth=float(
                        np.deg2rad(solar_azimuth) - obs_azi
                    ),
                    observer_altitude_m=float(observer_altitude[i]),
                    cos_sza=float(np.cos(np.deg2rad(solar_zenith))),
                )
            )
            self._cos_sza[i] = np.cos(np.deg2rad(solar_zenith))
            self._earth_radius[i] = np.linalg.norm(
                tangent_geo.location - alt * tangent_geo.local_up
            )
            solar_az[i] = solar_azimuth
            observer_az[i] = np.rad2deg(obs_azi)
            viewing_zenith[i] = np.rad2deg(
                np.arccos(np.clip(np.dot(lv, observer_geo.local_up), -1, 1))
            )
            viewing_azimuth[i] = np.rad2deg(-np.arctan2(
                np.dot(lv, observer_geo.local_west),
                -np.dot(lv, observer_geo.local_south),
            ))

        ds = Dataset()
        ds["tangent_altitude"] = (("los",), self._tangent_altitudes)
        ds["tangent_latitude"] = (("los",), tangent_latitude.astype(float))
        ds["tangent_longitude"] = (("los",), tangent_longitude.astype(float))
        ds["observer_altitude"] = (("los",), observer_altitude.astype(float))
        ds["observer_latitude"] = (("los",), observer_latitude.astype(float))
        ds["observer_longitude"] = (("los",), observer_longitude.astype(float))
        ds["tangent_cos_sza"] = (("los",), self._cos_sza)
        ds["tangent_solar_azimuth"] = (("los",), solar_az)
        ds["tangent_observer_azimuth"] = (("los",), observer_az)
        ds["viewing_zenith"] = (("los",), viewing_zenith)
        ds["viewing_azimuth"] = (("los",), viewing_azimuth)
        ViewingGeometryContainer.__init__(self, ds)

    def recommended_cos_sza(self) -> float:
        return float(np.interp(
            self._reference_altitude, self._tangent_altitudes, self._cos_sza
        ))

    def recommended_earth_radius(self) -> float:
        return float(np.interp(
            self._reference_altitude, self._tangent_altitudes,
            self._earth_radius,
        ))

    def model_geometry(self, altitude_grid_m: np.ndarray) -> Geometry1D:
        return Geometry1D(
            self.recommended_cos_sza(),
            0.0,
            self.recommended_earth_radius(),
            np.asarray(altitude_grid_m, dtype=np.float64),
            InterpolationMethod.LinearInterpolation,
            GeometryType.Spherical,
        )

    @classmethod
    def from_tangent_parameters(
        cls,
        solar_handler,
        tangent_altitudes: np.ndarray,
        tangent_latitude: float,
        tangent_longitude: float,
        time,
        observer_altitude: float,
        viewing_azimuth: float,
        reference_altitude: float = 25000.0,
        forced_constant_tangent: bool = False,
    ):
        """Construct from tangent-point parameters at a reference altitude
        and a viewing azimuth (degrees clockwise from north), solving for
        the single observer location (reference
        ``limbverticalimage.py:208-291``)."""
        tangent_geo = _wgs84().from_lat_lon_alt(
            tangent_latitude, tangent_longitude, reference_altitude
        )
        azi = np.deg2rad(viewing_azimuth)
        lv = (
            -tangent_geo.local_south * np.cos(azi)
            - tangent_geo.local_west * np.sin(azi)
        )
        observer_geo = _wgs84()
        entrance, _ = observer_geo.altitude_intercepts(
            observer_altitude, tangent_geo.location, lv
        )
        observer_geo.from_xyz(entrance)

        tangent_altitudes = np.asarray(tangent_altitudes, dtype=np.float64)
        if forced_constant_tangent:
            lat = np.full(len(tangent_altitudes), tangent_latitude)
            lon = np.full(len(tangent_altitudes), tangent_longitude)
        else:
            lat = np.zeros(len(tangent_altitudes))
            lon = np.zeros(len(tangent_altitudes))
            for i, alt in enumerate(tangent_altitudes):
                g = _wgs84()
                g.from_tangent_altitude(alt, observer_geo.location, lv)
                lat[i] = g.latitude
                lon[i] = g.longitude

        return cls(
            solar_handler,
            tangent_altitudes,
            lat,
            lon,
            time,
            observer_geo.altitude,
            observer_geo.latitude,
            observer_geo.longitude,
            reference_altitude,
        )
