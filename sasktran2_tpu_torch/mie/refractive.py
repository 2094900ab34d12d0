"""Refractive index datasets for Mie calculations.

Role of the reference's ``src/sasktran2/mie/refractive.py``: a generic
wavelength -> complex refractive index wrapper plus named species
(H2SO4, dust, ice, water) backed by the legacy OSIRIS data files. In this
zero-egress environment the OSIRIS files must be present under
``database_root()/refractive_index/`` (same filenames as the reference
StandardDatabase layout).

(Numpy copy of ``sasktran2_tpu/mie/refractive.py`` for the PyTorch
port, reading under the port's own database root.)
"""

from __future__ import annotations

import numpy as np

from ..database import database_root


class RefractiveIndex:
    """Light wrapper over a ``wavelength_nm -> complex`` function with a
    unique identifier."""

    def __init__(self, refractive_index_fn, identifier: str) -> None:
        self._fn = refractive_index_fn
        self._identifier = identifier

    def refractive_index(self, wavelength_nm):
        return self._fn(wavelength_nm)

    @property
    def refractive_index_fn(self):
        return self._fn

    @property
    def identifier(self) -> str:
        return self._identifier


def _from_osiris_file(path):
    """Interpolator over the legacy OSIRIS CSV format: columns
    (wavelength_nm, n_real, n_imag), refractive index n = n_real -
    i n_imag."""
    data = np.loadtxt(path, delimiter=",")
    wl, n_r, n_i = data[:, 0], data[:, 1], data[:, 2]

    def fn(wavelength_nm):
        return (
            np.interp(wavelength_nm, wl, n_r)
            - 1j * np.interp(wavelength_nm, wl, n_i)
        )

    return fn


def _osiris_species(name: str, filename: str) -> RefractiveIndex:
    root = database_root()
    path = None if root is None else (
        root / "refractive_index" / filename
    )
    if path is None or not path.exists():
        msg = (
            f"OSIRIS refractive index file for {name} not found; place "
            f"it at <database_root>/refractive_index/{filename}"
        )
        raise FileNotFoundError(msg)
    return RefractiveIndex(_from_osiris_file(path), f"{name}_osiris")


class H2SO4(RefractiveIndex):
    def __init__(self, source: str = "osiris") -> None:
        if source.lower() != "osiris":
            msg = "Only osiris source is supported for H2SO4"
            raise ValueError(msg)
        base = _osiris_species("H2SO4", "refrac_h2so4_osiris.txt")
        super().__init__(base.refractive_index_fn, base.identifier)


class Dust(RefractiveIndex):
    def __init__(self, source: str = "osiris") -> None:
        if source.lower() != "osiris":
            msg = "Only osiris source is supported for dust"
            raise ValueError(msg)
        base = _osiris_species("dust", "refrac_dust_osiris.txt")
        super().__init__(base.refractive_index_fn, base.identifier)


class Ice(RefractiveIndex):
    def __init__(self, source: str = "osiris") -> None:
        if source.lower() != "osiris":
            msg = "Only osiris source is supported for ice"
            raise ValueError(msg)
        base = _osiris_species("ice", "refrac_ice_osiris.txt")
        super().__init__(base.refractive_index_fn, base.identifier)


class Water(RefractiveIndex):
    def __init__(self, source: str = "osiris") -> None:
        if source.lower() != "osiris":
            msg = "Only osiris source is supported for water"
            raise ValueError(msg)
        base = _osiris_species("water", "refrac_water_osiris.txt")
        super().__init__(base.refractive_index_fn, base.identifier)
