"""Locally-generated, cached Mie scattering databases.

Counterpart of ``sasktran2_tpu/database/mie.py``: given a particle size
distribution, a refractive index, and a wavelength grid, generate the
ensemble-averaged Mie table (cross sections + greek coefficients over any
grid of distribution parameters), with the Mie on the device, cache it on
disk, and expose it as an :class:`~..optical.database.
OpticalDatabaseGenericScatterer` usable by scatterer constituents.

The cache key hashes the full generation recipe, as the reference's does
(the same key for the same recipe), so changing any input regenerates;
tables are stored as ``.npz`` with the reference's layout under the
port's own database root (``appconfig``).
"""

from __future__ import annotations

import hashlib
import json
from itertools import product
from pathlib import Path

import numpy as np

from ..mie.distribution import ParticleSizeDistribution, integrate_mie
from ..mie.refractive import RefractiveIndex
from ..optical.database import OpticalDatabaseGenericScatterer


class MieDatabase(OpticalDatabaseGenericScatterer):
    """Cached ensemble Mie table.

    ``device`` is where the Mie runs (None: the GPU). Parameters beyond the
    distribution/refractive-index/wavelengths:
    ``**kwargs`` supplies a 1-D grid of values for each free distribution
    parameter (e.g. ``median_radius=[50, 100, 200]``); the generated table
    is the outer product over those grids, and the resulting optical
    property interpolates over them per altitude (at most 2 parameter
    axes, matching the scatterer-database backend).
    """

    def __init__(
        self,
        psize_distribution: ParticleSizeDistribution,
        refractive_index: RefractiveIndex,
        wavelengths_nm,
        db_root: Path | None = None,
        max_legendre_moments: int = 64,
        num_size_quadrature: int = 1000,
        num_angles: int = 481,
        device=None,
        **kwargs,
    ) -> None:
        self._device = device
        self._psize_dist = psize_distribution
        self._refractive_index = refractive_index
        self._wavelengths_nm = np.atleast_1d(
            np.asarray(wavelengths_nm, dtype=np.float64)
        )
        self._max_moments = int(max_legendre_moments)
        self._num_quad = int(num_size_quadrature)
        self._num_angles = int(num_angles)
        self._kwargs = {
            k: np.atleast_1d(np.asarray(v, dtype=np.float64))
            for k, v in kwargs.items()
        }
        missing = [
            a for a in psize_distribution.args() if a not in self._kwargs
        ]
        if missing:
            msg = (
                f"Missing distribution parameter grids for {missing}; "
                f"pass them as keyword arguments"
            )
            raise ValueError(msg)

        if db_root is None:
            from . import database_root

            db_root = database_root() / "mie"
        db_root = Path(db_root)
        db_root.mkdir(parents=True, exist_ok=True)
        self._data_file = db_root / f"mie_{self._cache_key()}.npz"
        if not self._data_file.exists():
            self.generate()
        super().__init__(db_filepath=self._data_file)

    def _cache_key(self) -> str:
        recipe = {
            "distribution": self._psize_dist.identifier,
            "refractive": self._refractive_index.identifier,
            "wavelengths": self._wavelengths_nm.tolist(),
            "moments": self._max_moments,
            "quad": self._num_quad,
            "angles": self._num_angles,
            "params": {k: v.tolist() for k, v in self._kwargs.items()},
        }
        blob = json.dumps(recipe, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @property
    def data_file(self) -> Path:
        return self._data_file

    def generate(self):
        """Compute the table and write the npz artifact."""
        names = list(self._kwargs)
        grids = [self._kwargs[n] for n in names]
        shape = tuple(g.size for g in grids)
        W = self._wavelengths_nm.size
        L = self._max_moments

        xs_total = np.zeros(shape + (W,))
        xs_scattering = np.zeros(shape + (W,))
        lm = {
            k: np.zeros((L,) + shape + (W,))
            for k in ("lm_a1", "lm_a2", "lm_a3", "lm_a4", "lm_b1", "lm_b2")
        }
        for flat_idx, vals in enumerate(product(*grids)):
            idx = np.unravel_index(flat_idx, shape) if shape else ()
            dist = self._psize_dist.distribution(
                **dict(zip(names, (float(v) for v in vals)))
            )
            out = integrate_mie(
                dist,
                self._refractive_index.refractive_index_fn,
                self._wavelengths_nm,
                num_angles=self._num_angles,
                num_quad=self._num_quad,
                maxintquantile=0.999999,
                compute_coeffs=True,
                num_coeffs=L,
                device=self._device,
            )
            # nm^2 -> m^2
            xs_total[idx] = out["xs_total"] * 1e-18
            xs_scattering[idx] = out["xs_scattering"] * 1e-18
            for k in lm:
                lm[k][(slice(None), *idx)] = out[k].T

        dims = tuple(names) + ("wavelength_nm",)
        arrays = {
            "coord_wavelength_nm": self._wavelengths_nm,
            "coord_legendre": np.arange(L),
            "xs_total": xs_total,
            "dims_xs_total": np.array(dims),
            "xs_scattering": xs_scattering,
            "dims_xs_scattering": np.array(dims),
        }
        for n, g in zip(names, grids):
            arrays[f"coord_{n}"] = g
        for k, v in lm.items():
            arrays[k] = v
            arrays[f"dims_{k}"] = np.array(("legendre",) + dims)
        np.savez_compressed(self._data_file, **arrays)

    def clear(self):
        if self._data_file.exists():
            self._data_file.unlink()
