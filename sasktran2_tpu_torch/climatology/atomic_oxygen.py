"""Atomic oxygen zonal-mean climatology.

Role of the reference's ``src/sasktran2/climatology/atomic_oxygen.py``:
monthly zonal-mean atomic oxygen number density tabulated on a
(month x altitude x latitude) grid, interpolated to a requested time,
latitude, and altitude grid.

Data source: tabulated zonal-mean reference data from NASA NTRS report
19910018329 (Tables 1 and 2; Adv. Space Res. 17(11), 1996), shipped as
package data (``data/atomic_oxygen_ntrs19910018329.npz``) with the table
in cm^-3 ordered [month, altitude (130 km down to 40 km), latitude].

(Copy of ``sasktran2_tpu/climatology/atomic_oxygen.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import calendar
import datetime as _dt
from pathlib import Path

import numpy as np

_DATA_PATH = (
    Path(__file__).parent / "data" / "atomic_oxygen_ntrs19910018329.npz"
)
_cache = None


def _load():
    global _cache
    if _cache is None:
        with np.load(_DATA_PATH) as d:
            _cache = (
                d["table_cm3"], d["altitudes_m"], d["latitudes_degrees"]
            )
    return _cache


def _month_coordinate(time) -> float:
    """Fractional month coordinate in [1, 13)."""
    if isinstance(time, np.datetime64):
        day = time.astype("datetime64[D]").astype(object)
        if isinstance(day, int):
            msg = "np.datetime64 values must include a calendar date"
            raise TypeError(msg)
        time = day
    if isinstance(time, (_dt.datetime, _dt.date)):
        days_in_month = calendar.monthrange(time.year, time.month)[1]
        return time.month + (time.day - 1) / days_in_month
    value = float(time)
    if 1.0 <= value < 13.0:
        return value
    msg = (
        "time must be a date/datetime/np.datetime64 or a fractional "
        "month in [1, 13)"
    )
    raise ValueError(msg)


def number_density(
    altitudes_m,
    time,
    latitude_degrees: float,
    lower_fill_value: float | None = 0.0,
    upper_fill_value: float | None = None,
) -> np.ndarray:
    """Atomic oxygen number density [m^-3] on an altitude grid.

    ``time`` is a date/datetime or a fractional month in [1, 13) (December
    wraps to January). ``latitude_degrees`` must be within the tabulated
    -80..80 range. Below 40 km / above 130 km the profile is filled with
    ``lower_fill_value`` / ``upper_fill_value`` (None = edge value).
    """
    table_cm3, table_alts, table_lats = _load()
    alts = np.asarray(altitudes_m, dtype=np.float64)
    lat = float(latitude_degrees)
    if lat < table_lats.min() or lat > table_lats.max():
        msg = (
            "latitude_degrees must be within the tabulated range "
            "-80 to 80 degrees"
        )
        raise ValueError(msg)

    # month interpolation with December -> January wraparound
    mc = _month_coordinate(time)
    lower = int(np.floor(mc))
    frac = mc - lower
    at_time = (
        (1.0 - frac) * table_cm3[(lower - 1) % 12]
        + frac * table_cm3[lower % 12]
    )  # [alt, lat]

    # latitude interpolation (vectorized across altitudes)
    j = np.clip(np.searchsorted(table_lats, lat) - 1, 0,
                table_lats.size - 2)
    w = (lat - table_lats[j]) / (table_lats[j + 1] - table_lats[j])
    profile_cm3 = (1.0 - w) * at_time[:, j] + w * at_time[:, j + 1]

    lower_fill = (
        profile_cm3[-1] if lower_fill_value is None
        else float(lower_fill_value) / 1.0e6
    )
    upper_fill = (
        profile_cm3[0] if upper_fill_value is None
        else float(upper_fill_value) / 1.0e6
    )
    density_cm3 = np.interp(
        alts, table_alts[::-1], profile_cm3[::-1],
        left=lower_fill, right=upper_fill,
    )
    return density_cm3 * 1.0e6
