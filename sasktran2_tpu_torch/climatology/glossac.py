"""GloSSAC stratospheric aerosol climatology loader.

Role of the reference's ``src/sasktran2/climatology/glossac.py``:
stratospheric background aerosol extinction profiles from the GloSSAC
NetCDF dataset. This environment has no network egress, so the file must
be present under ``database_root()/climatology/glossac/GloSSAC_V{ver}.nc``
(the reference falls back to NASA opendap when the local file is absent;
here that raises with the download location instead).

(Copy of ``sasktran2_tpu/climatology/glossac.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from ..database import database_root
from ..optical.database import _load_dataset

_OPENDAP = "https://opendap.larc.nasa.gov/opendap/GloSSAC"


def load_glossac_raw_data(version: str = "2.21", path=None):
    """Load the raw GloSSAC dataset as a
    ``{"coords": ..., "data_vars": ...}`` dict (npz / classic netCDF /
    HDF5 supported)."""
    if path is None:
        root = database_root()
        if root is None:
            msg = (
                "No database root configured; place the GloSSAC file at "
                "<database_root>/climatology/glossac/"
                f"GloSSAC_V{version}.nc (from {_OPENDAP}/"
                f"GloSSAC_{version}/GloSSAC_V{version}.nc)"
            )
            raise FileNotFoundError(msg)
        path = root / "climatology" / "glossac" / f"GloSSAC_V{version}.nc"
        if not path.exists():
            msg = (
                f"GloSSAC file {path} not found; download it from "
                f"{_OPENDAP}/GloSSAC_{version}/GloSSAC_V{version}.nc"
            )
            raise FileNotFoundError(msg)
    return _load_dataset(db_filepath=path)


def stratospheric_background(
    month: int, lat: float, alts, wavelength_nm: float,
    version: str = "2.21", dataset=None,
):
    """Stratospheric background aerosol extinction [m^-1] on ``alts`` [m]
    at the nearest tabulated latitude and the exact tabulated wavelength
    (reference ``glossac.py stratospheric_background``)."""
    ds = dataset if dataset is not None else load_glossac_raw_data(version)
    coords = ds["coords"]
    data_vars = ds["data_vars"]

    wavels = np.asarray(coords["wavelengths_glossac"], dtype=np.float64)
    lats = np.asarray(coords["lat"], dtype=np.float64)
    months = np.asarray(coords["month"], dtype=np.float64)
    table_alts_km = np.asarray(coords["alt"], dtype=np.float64)

    wavel_idx = int(np.argmin(np.abs(wavels - wavelength_nm)))
    if abs(wavels[wavel_idx] - wavelength_nm) > 1e-4:
        msg = (
            f"Could not find wavelength {wavelength_nm} in GloSSAC data. "
            f"Valid wavelengths are {wavels}"
        )
        raise ValueError(msg)
    lat_idx = int(np.argmin(np.abs(lats - lat)))
    month_idx = int(np.argmin(np.abs(months - month)))
    if months[month_idx] != month:
        msg = f"Month {month} not present in GloSSAC data"
        raise ValueError(msg)

    dims, table = data_vars["Stratospheric_Background"]
    table = np.asarray(table, dtype=np.float64)
    # index by named dims so any storage order works
    indexer = []
    for d in dims:
        if d == "month":
            indexer.append(month_idx)
        elif d == "lat":
            indexer.append(lat_idx)
        elif d == "wavelengths_glossac":
            indexer.append(wavel_idx)
        else:  # altitude axis stays
            indexer.append(slice(None))
    profile = table[tuple(indexer)]

    alts = np.asarray(alts, dtype=np.float64)
    out = np.interp(alts / 1000.0, table_alts_km, profile,
                    left=np.nan, right=np.nan)
    out[np.isnan(out)] = 0.0
    return out / 1.0e3  # per-km -> per-m
