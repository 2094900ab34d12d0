"""Baum V3.6 ice-crystal optical property.

Role of the reference's ``src/sasktran2/optical/baum.py``: severely rough
ice-crystal extinction / single-scatter albedo / polarized phase expansion
tabulated over (wavelength x effective diameter) for three habit models.
The table stores extinction per ice-water content (m^2 g^-1); use it with
an extinction-normalized scatterer constituent. In this zero-egress
environment the NetCDF/npz database must be a local file (``db_filepath``
or ``<database_root>/cross_sections/ice/baum_ice_crystals_v3_6.nc``).

(Copy of ``sasktran2_tpu/optical/baum.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..database import database_root
from .database import OpticalDatabaseGenericScatterer, _load_dataset

_PARTICLE_MODELS = (
    "general_habit_mixture",
    "aggregate_solid_columns",
    "solid_columns",
)
_DEFAULT_DATABASE_MOMENTS = 256
_STANDARD_KEY = "cross_sections/ice/baum_ice_crystals_v3_6.nc"
_FULL_STANDARD_KEY = "cross_sections/ice/baum_ice_crystals_v3_6_full.nc"
_RUNTIME_VARIABLES = (
    "xs_total", "xs_scattering",
    "lm_a1", "lm_a2", "lm_a3", "lm_a4", "lm_b1", "lm_b2",
)


class BaumIceCrystal(OpticalDatabaseGenericScatterer):
    """Baum V3.6 ice crystals for one habit model with a Legendre-moment
    cap (see the reference docstring for the table layout: 445 wavelengths
    199-99000 nm, 23 effective diameters 10-120 um)."""

    def __init__(self, particle_model="general_habit_mixture",
                 max_moments: int | None = 256, db_filepath=None):
        if particle_model not in _PARTICLE_MODELS:
            valid = ", ".join(_PARTICLE_MODELS)
            msg = (
                f"Unknown Baum particle model {particle_model!r}; "
                f"expected one of {valid}"
            )
            raise ValueError(msg)
        if max_moments is not None:
            if isinstance(max_moments, (bool, np.bool_)) or not isinstance(
                max_moments, (int, np.integer)
            ):
                msg = "max_moments must be an integer or None"
                raise TypeError(msg)
            if max_moments <= 0:
                msg = "max_moments must be positive or None"
                raise ValueError(msg)
            max_moments = int(max_moments)

        if db_filepath is None:
            key = (
                _FULL_STANDARD_KEY
                if max_moments is None
                or max_moments > _DEFAULT_DATABASE_MOMENTS
                else _STANDARD_KEY
            )
            root = database_root()
            db_filepath = None if root is None else root / key
            if db_filepath is None or not Path(db_filepath).exists():
                msg = (
                    "Baum ice-crystal database not found; place it at "
                    f"<database_root>/{key}"
                )
                raise OSError(msg)
        db_filepath = Path(db_filepath)
        if not db_filepath.exists():
            msg = f"Baum ice-crystal database does not exist: {db_filepath}"
            raise OSError(msg)

        ds = _load_dataset(db_filepath=db_filepath)
        missing = [
            v for v in _RUNTIME_VARIABLES if v not in ds["data_vars"]
        ]
        if missing:
            msg = f"Baum database is missing required variables: {missing}"
            raise ValueError(msg)
        if "particle_model" not in ds["coords"]:
            msg = "Baum database is missing the particle_model coordinate"
            raise ValueError(msg)
        models = tuple(str(v) for v in np.asarray(ds["coords"]["particle_model"]))
        if particle_model not in models:
            msg = (
                f"Particle model {particle_model!r} is not present in "
                f"{db_filepath}; available models are {models}"
            )
            raise ValueError(msg)
        model_idx = models.index(particle_model)

        # count of stored moments from lm_a1's legendre axis
        dims_a1, a1 = ds["data_vars"]["lm_a1"]
        nleg = np.asarray(a1).shape[dims_a1.index("legendre")]
        if nleg == 0:
            msg = "Baum database contains no Legendre moments"
            raise ValueError(msg)
        if max_moments is None:
            loaded = nleg
        elif max_moments > nleg:
            msg = (
                f"Requested {max_moments} moments, but the Baum database "
                f"only contains {nleg}"
            )
            raise ValueError(msg)
        else:
            loaded = max_moments

        # slice the habit model out and cap the moments, then hand the
        # reduced in-memory dataset to the generic scatterer loader
        out_vars = {}
        for name, (dims, arr) in ds["data_vars"].items():
            if name not in _RUNTIME_VARIABLES:
                continue
            arr = np.asarray(arr)
            new_dims = list(dims)
            if "particle_model" in dims:
                arr = np.take(arr, model_idx,
                              axis=dims.index("particle_model"))
                new_dims.remove("particle_model")
            if "legendre" in new_dims:
                arr = np.take(arr, np.arange(loaded),
                              axis=new_dims.index("legendre"))
            out_vars[name] = (tuple(new_dims), arr)
        coords = {
            k: v for k, v in ds["coords"].items() if k != "particle_model"
        }
        if "legendre" in coords:
            coords["legendre"] = np.arange(loaded)
        self.particle_model = particle_model
        self.loaded_moments = loaded
        super().__init__(db={"coords": coords, "data_vars": out_vars})
