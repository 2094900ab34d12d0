"""MIPAS / FASCODE reference-atmosphere climatologies.

Role of the reference's ``src/sasktran2/climatology/mipas.py``: read RFM
``.atm`` reference-atmosphere files (http://eodg.atm.ox.ac.uk/RFM/atm/ —
fascode, mipas_1998, mipas_2001 datasets) and build VMR absorber
constituents plus pressure/temperature profiles from them.

This build runs zero-egress: the ``.atm`` files are looked up in the local
database cache (``database.CachedDatabase("climatology")``), or an explicit
file path / open-file content can be supplied. The file grammar is the RFM
convention: ``!`` comment lines, ``*NAME (units)`` profile headers, a
leading level count, whitespace/comma-separated values, ``*END`` sentinel.

(Copy of ``sasktran2_tpu/climatology/mipas.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..database import CachedDatabase

#: files holding the climatology-independent minor-species profiles
_MINOR_FILES = {
    "fascode": "minor.atm",
    "mipas_1998": "extra_imk.atm",
    "mipas_2001": "extra.atm",
}


def read_atm(source) -> dict:
    """Parse an RFM ``.atm`` file into ``{NAME: profile array}``.

    ``source`` is a path or a string of file content. Profile names are
    upper-cased; units follow the RFM convention (HGT in km, PRE in mb,
    TEM in K, species in ppmv).
    """
    if isinstance(source, (str, Path)) and "\n" not in str(source):
        text = Path(source).read_text()
    else:
        text = str(source)

    profiles: dict[str, list[float]] = {}
    current: list[float] | None = None
    seen_count = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("!"):
            continue
        if line.startswith("*"):
            name = line[1:].split()[0].split("(")[0].strip().upper()
            if name == "END":
                break
            current = profiles.setdefault(name, [])
            continue
        if not seen_count and current is None:
            # first uncommented line before any header: the level count
            seen_count = True
            continue
        if current is None:
            continue
        for tok in line.replace(",", " ").split():
            try:
                current.append(float(tok))
            except ValueError:
                pass
    return {k: np.asarray(v, dtype=np.float64) for k, v in profiles.items()}


def _atm_path(dataset: str, file_name: str) -> Path:
    db = CachedDatabase("climatology")
    p = db.path(f"{dataset}/{file_name}")
    if not p.exists():
        msg = (
            f"Reference-atmosphere file {p} is not present. This build has "
            "no network access: download the RFM .atm files "
            "(http://eodg.atm.ox.ac.uk/RFM/atm/) and place them under "
            f"{db.path()}/{dataset}/, or pass atm_data= with parsed "
            "profiles."
        )
        raise FileNotFoundError(msg)
    return p


def _load_profiles(dataset: str, climatology: str, atm_data=None) -> dict:
    if atm_data is not None:
        return atm_data
    atm_file = (
        climatology if climatology.endswith(".atm") else climatology + ".atm"
    )
    return read_atm(_atm_path(dataset, atm_file))


def constituent(
    species: str,
    optical_property,
    dataset: str = "fascode",
    climatology: str = "std",
    atm_data: dict | None = None,
    minor_data: dict | None = None,
):
    """A :class:`~..constituent.VMRAltitudeAbsorber` for one species from a
    reference-atmosphere climatology (reference mipas.py ``constituent``).

    Major species come from the climatology file (``std``, ``tro``, ``mls``,
    ... for fascode; ``day``, ``ngt``, ``win``, ``sum``, ``equ`` for
    mipas_2001); species absent there fall back to the dataset's shared
    minor-species file. ``atm_data``/``minor_data`` bypass file lookup with
    pre-parsed profile dicts (see :func:`read_atm`).
    """
    from ..constituent import VMRAltitudeAbsorber

    data = _load_profiles(dataset, climatology, atm_data)
    key = species.upper()
    if key not in data:
        if minor_data is not None:
            data = minor_data
        else:
            if dataset not in _MINOR_FILES:
                msg = f"{dataset!r} is not a valid dataset"
                raise ValueError(msg)
            data = read_atm(_atm_path(dataset, _MINOR_FILES[dataset]))
        if key not in data:
            msg = f"Species {species!r} not found in {dataset} profiles"
            raise KeyError(msg)
    vmr = data[key] / 1.0e6  # ppmv -> vmr
    heights_m = data["HGT"] * 1000.0
    return VMRAltitudeAbsorber(optical_property, heights_m, vmr)


def add_to_atmosphere(
    atmosphere,
    species: dict,
    dataset: str = "fascode",
    climatology: str = "std",
    set_pressure_temperature: bool = True,
    atm_data: dict | None = None,
    minor_data: dict | None = None,
):
    """Add several climatology species to an atmosphere and optionally set
    its pressure/temperature from the same profiles (reference mipas.py
    ``add_to_atmosphere``).

    ``species`` maps name -> optical property, e.g.
    ``{"O3": O3Absorber(...), "NO2": NO2Absorber(...)}``.
    """
    data = _load_profiles(dataset, climatology, atm_data)
    for name, optical_property in species.items():
        atmosphere[name] = constituent(
            name, optical_property, dataset, climatology,
            atm_data=data, minor_data=minor_data,
        )

    if set_pressure_temperature:
        altitudes_m = data["HGT"] * 1000.0
        grid = atmosphere.model_geometry.altitudes()
        atmosphere.temperature_k = np.interp(
            grid, altitudes_m, data["TEM"]
        )
        # pressure interpolates in log space (hydrostatic exponential)
        atmosphere.pressure_pa = np.exp(
            np.interp(grid, altitudes_m, np.log(data["PRE"] * 100.0))
        )
    return atmosphere
