"""Named standard-database optical properties.

Role of the reference's convenience classes in
``src/sasktran2/optical/__init__.py`` (O3DBM, O3Serdyuchenko,
O3BirkWagner, NO2Vandaele, HITRANUV, HITRANTabulated, HITRANCollision) —
each resolves a cross-section file from the standard database layout
``cross_sections/<species>/<file>.nc`` and wraps it in
:class:`~.database.OpticalDatabaseGenericAbsorber`.

Zero-egress build: files resolve from the local database cache
(``database.database_root()``); a clear error points at the expected path
when data is absent. Every class also accepts ``db_filepath=``/``db=``
overrides for user-supplied data.

(Copy of ``sasktran2_tpu/optical/named.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from pathlib import Path

from ..database import CachedDatabase
from .database import OpticalDatabaseGenericAbsorber


def _standard_file(rel: str) -> Path:
    db = CachedDatabase("cross_sections")
    # accept either .nc or .npz next to the canonical name
    p = db.path(rel)
    if p.exists():
        return p
    alt = p.with_suffix(".npz")
    if alt.exists():
        return alt
    msg = (
        f"Standard cross-section database file {p} is not present. This "
        "build has no network access: place the file (netCDF or the .npz "
        f"equivalent) under {db.path()}, or construct "
        "OpticalDatabaseGenericAbsorber directly with your own data."
    )
    raise FileNotFoundError(msg)


class _NamedAbsorber(OpticalDatabaseGenericAbsorber):
    _REL: str = ""

    def __init__(self, db_filepath=None, db=None):
        if db_filepath is None and db is None:
            db_filepath = _standard_file(self._REL)
        super().__init__(db_filepath=db_filepath, db=db)


class O3DBM(_NamedAbsorber):
    """Daumont-Brion-Malicet O3 cross sections (reference optical
    ``O3DBM``: 194.5-830 nm, 218-295 K, ``cross_sections/o3/dbm.nc``)."""

    _REL = "o3/dbm.nc"


class O3Serdyuchenko(_NamedAbsorber):
    """Serdyuchenko/Gorshelev O3 cross sections (213-1100 nm, 193-293 K,
    ``cross_sections/o3/serdyuchenko.nc``)."""

    _REL = "o3/serdyuchenko.nc"


class O3BirkWagner(_NamedAbsorber):
    """Birk & Wagner (2021) O3 cross sections
    (``cross_sections/o3/birkwagner.nc``)."""

    _REL = "o3/birkwagner.nc"


class NO2Vandaele(_NamedAbsorber):
    """Vandaele (1998) NO2 cross sections (238-1000 nm,
    ``cross_sections/no2/vandaele.nc``)."""

    _REL = "no2/vandaele.nc"


class HITRANUV(_NamedAbsorber):
    """HITRAN UV cross-section tables
    (``cross_sections/<name>/hitran<version>.nc``)."""

    def __init__(self, name: str, version: str = "2022",
                 db_filepath=None, db=None):
        self._REL = f"{name}/hitran{version}.nc"
        super().__init__(db_filepath=db_filepath, db=db)


class HITRANTabulated(_NamedAbsorber):
    """Pre-tabulated HITRAN line-by-line cross sections
    (``cross_sections/<name>/hitran_<res>_res.nc``); for full line-by-line
    evaluation use :class:`~.line_absorber.LineAbsorber`."""

    def __init__(self, name: str, res: str = "01nm",
                 db_filepath=None, db=None):
        self._REL = f"{name.lower()}/hitran_{res}_res.nc"
        super().__init__(db_filepath=db_filepath, db=db)


class HITRANCollision(_NamedAbsorber):
    """HITRAN collision-induced absorption tables
    (``cross_sections/<name>/hitran_cia.nc``)."""

    def __init__(self, name: str, db_filepath=None, db=None):
        self._REL = f"{name.lower()}/hitran_cia.nc"
        super().__init__(db_filepath=db_filepath, db=db)
