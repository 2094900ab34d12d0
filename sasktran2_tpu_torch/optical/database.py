"""Database-backed optical properties (N-dimensional tabulated).

Role of the reference's absorber/scatterer database stack
(``rust/sasktran2-rs/src/optical/types/xsec_dbase.rs`` —
``AbsorberDatabaseDim1/2/3``; ``scat_dbase.rs`` — scattering databases
Dim1-4; Python front-end ``src/sasktran2/optical/database.py``):

* :class:`AbsorberDatabase` — absorption cross sections on a spectral grid
  plus up to two named atmosphere parameters (temperature_k, pressure_pa,
  ...), multilinearly interpolated per altitude, with analytic
  ``d xs / d param`` for pressure/temperature weighting functions.
* :class:`ScattererDatabase` — total/scattering cross sections and
  Legendre (a1, and a2/a3/b1 when polarized) expansions on a spectral grid
  plus optional particle parameters interpolated per altitude.
* :class:`OpticalDatabaseGenericAbsorber` /
  :class:`OpticalDatabaseGenericScatterer` — file front-ends accepting
  netCDF (classic via scipy, netCDF4/HDF5 via h5py), ``.npz``, or an
  in-memory dict ``{"coords": {...}, "data_vars": {name: (dims, array)}}``.

The interpolation is host-side numpy (cross sections feed the atmosphere
construction pipeline, not the jitted RT solve — same split as the
reference, where databases are evaluated in Rust before the engine call).

(Numpy copy of ``sasktran2_tpu/optical/database.py`` for the PyTorch
port; a test pins it to the original.)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from .base import OpticalProperty

_SPECTRAL_COORDS = ("wavelength_nm", "wavenumber_cminv")


def _interp_weights_1d(grid, x):
    """(idx_lo, idx_hi, w_hi) for clamped linear interpolation of scalar or
    array x onto a sorted 1-D grid."""
    x = np.asarray(x, dtype=np.float64)
    i = np.clip(np.searchsorted(grid, x) - 1, 0, len(grid) - 2)
    denom = grid[i + 1] - grid[i]
    f = np.clip((x - grid[i]) / denom, 0.0, 1.0)
    return i, i + 1, f


class AbsorberDatabase(OpticalProperty):
    """Tabulated absorption cross sections ``xs[param0, param1, spectral]``.

    Parameters
    ----------
    wavelengths_nm : [n_w] spectral grid (sorted)
    cross_section_m2 : [*param_shape, n_w]
    params : ordered dict of name -> grid matching the leading axes;
        names are looked up per-altitude from the atmosphere state
        (``temperature_k``, ``pressure_pa``) or from ``**kwargs``.
    """

    def __init__(self, wavelengths_nm, cross_section_m2, params=None):
        self.wavelengths_nm = np.asarray(wavelengths_nm, dtype=np.float64)
        self.xs = np.asarray(cross_section_m2, dtype=np.float64)
        self.params = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in (params or {}).items()
        }
        if len(self.params) > 2:
            msg = "AbsorberDatabase supports at most 2 parameter axes"
            raise ValueError(msg)
        expected = tuple(len(v) for v in self.params.values()) + (
            len(self.wavelengths_nm),
        )
        if self.xs.shape != expected:
            msg = f"xs shape {self.xs.shape} != (params..., wavel) {expected}"
            raise ValueError(msg)

    def _param_values(self, name, altitudes_m, kwargs):
        v = kwargs.get(name)
        if v is None:
            msg = (
                f"AbsorberDatabase requires '{name}' values per altitude "
                "(pass pressure_pa/temperature_k through the atmosphere)"
            )
            raise ValueError(msg)
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == 0:
            nalt = len(altitudes_m) if altitudes_m is not None else 1
            v = np.full(nalt, float(v))
        return v

    def _xs_on_wavel(self, wavelengths_nm):
        wmat = linear_interpolating_matrix(
            self.wavelengths_nm, np.atleast_1d(wavelengths_nm), "extend"
        )
        return self.xs @ wmat.T  # [*params, W]

    def cross_sections(
        self, wavelengths_nm, altitudes_m=None, **kwargs,
    ):
        """[A, W] cross sections with the parameters evaluated per level."""
        return self._eval(wavelengths_nm, altitudes_m, kwargs, deriv=None)

    def cross_section_derivatives(
        self, wavelengths_nm, altitudes_m=None, **kwargs,
    ):
        """dict name -> [A, W] of d xs / d param at the evaluation points
        (reference ``xsec_dbase.rs`` derivative propagation)."""
        return {
            name: self._eval(wavelengths_nm, altitudes_m, kwargs, deriv=name)
            for name in self.params
        }

    def _eval(self, wavelengths_nm, altitudes_m, kwargs, deriv):
        xs_w = self._xs_on_wavel(wavelengths_nm)  # [*params, W]
        nw = xs_w.shape[-1]
        names = list(self.params)
        if not names:
            nalt = len(altitudes_m) if altitudes_m is not None else 1
            out = np.broadcast_to(xs_w, (nalt, nw)).copy()
            return out
        vals = [
            self._param_values(n, altitudes_m, kwargs) for n in names
        ]
        nalt = len(vals[0])
        if len(names) == 1:
            g = self.params[names[0]]
            lo, hi, f = _interp_weights_1d(g, vals[0])
            if deriv == names[0]:
                return (xs_w[hi] - xs_w[lo]) / (g[hi] - g[lo])[:, None]
            return (1 - f)[:, None] * xs_w[lo] + f[:, None] * xs_w[hi]
        g0, g1 = self.params[names[0]], self.params[names[1]]
        l0, h0, f0 = _interp_weights_1d(g0, vals[0])
        l1, h1, f1 = _interp_weights_1d(g1, vals[1])
        c00 = xs_w[l0, l1]
        c01 = xs_w[l0, h1]
        c10 = xs_w[h0, l1]
        c11 = xs_w[h0, h1]
        if deriv == names[0]:
            d = ((1 - f1)[:, None] * (c10 - c00) + f1[:, None] * (c11 - c01))
            return d / (g0[h0] - g0[l0])[:, None]
        if deriv == names[1]:
            d = ((1 - f0)[:, None] * (c01 - c00) + f0[:, None] * (c11 - c10))
            return d / (g1[h1] - g1[l1])[:, None]
        return (
            (1 - f0)[:, None] * ((1 - f1)[:, None] * c00 + f1[:, None] * c01)
            + f0[:, None] * ((1 - f1)[:, None] * c10 + f1[:, None] * c11)
        )


class ScattererDatabase:
    """Tabulated scattering properties vs spectral grid + up to 2 particle
    parameters (reference ``scat_dbase.rs`` Dim1-4).

    Arrays: ``xs_total`` / ``xs_scattering`` with shape [*params, n_w];
    ``lm_a1`` (and optional ``lm_a2``/``lm_a3``/``lm_b1``) with shape
    [n_legendre, *params, n_w].  ``scattering_properties`` evaluates at the
    atmosphere wavelengths and per-altitude parameter values.
    """

    def __init__(self, wavelengths_nm, xs_total, xs_scattering, lm_a1,
                 params=None, lm_a2=None, lm_a3=None, lm_b1=None):
        self.wavelengths_nm = np.asarray(wavelengths_nm, dtype=np.float64)
        self.params = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in (params or {}).items()
        }
        if len(self.params) > 2:
            msg = "ScattererDatabase supports at most 2 parameter axes"
            raise ValueError(msg)
        self.xs_total = np.asarray(xs_total, dtype=np.float64)
        self.xs_scattering = np.asarray(xs_scattering, dtype=np.float64)
        lm_a1 = np.asarray(lm_a1, dtype=np.float64)
        # normalize so the l=0 coefficient is exactly 1 (reference
        # database.py _validate_db)
        self.lm = {"a1": lm_a1 / lm_a1[:1]}
        for nm, v in (("a2", lm_a2), ("a3", lm_a3), ("b1", lm_b1)):
            if v is not None:
                self.lm[nm] = np.asarray(v, dtype=np.float64) / lm_a1[:1]

    def _interp(self, arr, wavelengths_nm, altitudes_m, kwargs):
        """arr [..., *params, n_w] -> [..., A, W]."""
        wmat = linear_interpolating_matrix(
            self.wavelengths_nm, np.atleast_1d(wavelengths_nm), "extend"
        )
        a = arr @ wmat.T
        names = list(self.params)
        if not names:
            nalt = len(altitudes_m) if altitudes_m is not None else 1
            return np.broadcast_to(
                a[..., None, :], a.shape[:-1] + (nalt, a.shape[-1])
            ).copy()
        vals = []
        for n in names:
            v = kwargs.get(n)
            if v is None:
                msg = f"ScattererDatabase requires '{n}' per altitude"
                raise ValueError(msg)
            vals.append(np.asarray(v, dtype=np.float64))
        if len(names) == 1:
            lo, hi, f = _interp_weights_1d(self.params[names[0]], vals[0])
            fc = f[:, None]
            return (1 - fc) * a[..., lo, :] + fc * a[..., hi, :]
        l0, h0, f0 = _interp_weights_1d(self.params[names[0]], vals[0])
        l1, h1, f1 = _interp_weights_1d(self.params[names[1]], vals[1])
        f0c, f1c = f0[:, None], f1[:, None]
        return (
            (1 - f0c) * (
                (1 - f1c) * a[..., l0, l1, :] + f1c * a[..., l0, h1, :]
            )
            + f0c * (
                (1 - f1c) * a[..., h0, l1, :] + f1c * a[..., h0, h1, :]
            )
        )

    def scattering_properties(self, wavelengths_nm, altitudes_m=None,
                              **kwargs):
        """dict with xs_total [A, W], ssa [A, W], legendre [L, A, W]
        (+ legendre_a2/a3/b1 when present)."""
        xt = self._interp(self.xs_total, wavelengths_nm, altitudes_m, kwargs)
        xsc = self._interp(
            self.xs_scattering, wavelengths_nm, altitudes_m, kwargs
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            ssa = np.where(xt > 0, xsc / np.where(xt > 0, xt, 1.0), 0.0)
        out = {
            "xs_total": xt,
            "ssa": ssa,
            "legendre": self._interp(
                self.lm["a1"], wavelengths_nm, altitudes_m, kwargs
            ),
        }
        for nm in ("a2", "a3", "b1"):
            if nm in self.lm:
                out[f"legendre_{nm}"] = self._interp(
                    self.lm[nm], wavelengths_nm, altitudes_m, kwargs
                )
        return out


# ---------------------------------------------------------------------------
# file loading


def _load_dataset(db_filepath=None, db=None):
    """Read a dataset into {"coords": {...}, "data_vars": {name: (dims,
    array)}} from an in-memory dict, .npz, classic netCDF (scipy), or
    netCDF4/HDF5 (h5py)."""
    if (db_filepath is None) == (db is None):
        msg = "exactly one of db_filepath or db must be provided"
        raise ValueError(msg)
    if db is not None:
        return db
    path = Path(db_filepath)
    if path.suffix == ".npz":
        raw = dict(np.load(path))
        coords = {
            k[len("coord_"):]: v for k, v in raw.items()
            if k.startswith("coord_")
        }
        dims = {}
        for k, v in raw.items():
            if k.startswith("dims_"):
                dims[k[len("dims_"):]] = tuple(str(s) for s in v)
        data = {
            k: (dims[k], raw[k]) for k in raw
            if not k.startswith(("coord_", "dims_"))
        }
        return {"coords": coords, "data_vars": data}
    try:
        from scipy.io import netcdf_file

        with netcdf_file(str(path), mmap=False) as f:
            coords = {}
            data = {}
            for name, var in f.variables.items():
                arr = np.array(var[...])
                if name in f.dimensions or (
                    arr.ndim == 1 and var.dimensions == (name,)
                ):
                    coords[name] = arr
                else:
                    data[name] = (tuple(var.dimensions), arr)
            return {"coords": coords, "data_vars": data}
    except Exception:  # noqa: BLE001 - netCDF4/HDF5 files fall through
        pass
    import h5py

    with h5py.File(path, "r") as f:
        coords = {}
        data = {}
        for name, ds in f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            arr = ds[...]
            is_coord = ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE" or (
                arr.ndim == 1 and name in _SPECTRAL_COORDS
            )
            if is_coord:
                coords[name] = np.asarray(arr, dtype=np.float64)
            else:
                dims = []
                if "DIMENSION_LIST" in ds.attrs:
                    for refs in ds.attrs["DIMENSION_LIST"]:
                        dims.append(f[refs[0]].name.lstrip("/"))
                data[name] = (tuple(dims), np.asarray(arr))
        return {"coords": coords, "data_vars": data}


def _spectral_to_wavelength(coords, dims):
    """Return (wavelength grid [nm], sort order, spectral dim name)."""
    if "wavelength_nm" in dims:
        wl = np.asarray(coords["wavelength_nm"], dtype=np.float64)
        name = "wavelength_nm"
    elif "wavenumber_cminv" in dims:
        wl = 1e7 / np.asarray(coords["wavenumber_cminv"], dtype=np.float64)
        name = "wavenumber_cminv"
    else:
        msg = "database must have a wavelength_nm or wavenumber_cminv dim"
        raise ValueError(msg)
    order = np.argsort(wl)
    return wl[order], order, name


class OpticalDatabaseGenericAbsorber(AbsorberDatabase):
    """File/dataset front-end for absorber databases (reference
    ``OpticalDatabaseGenericAbsorber``, ``optical/database.py:62-152``):
    variable ``xs`` [m^2] over (param..., wavelength_nm|wavenumber_cminv);
    legacy 'temperature'/'pressure' dim names are normalized."""

    _RENAMES = {"temperature": "temperature_k", "pressure": "pressure_pa"}

    def __init__(self, db_filepath=None, db=None):
        ds = _load_dataset(db_filepath, db)
        coords = {
            self._RENAMES.get(k, k): np.asarray(v, dtype=np.float64)
            for k, v in ds["coords"].items()
        }
        if "xs" not in ds["data_vars"]:
            msg = "xs must be defined in the optical database"
            raise ValueError(msg)
        dims, xs = ds["data_vars"]["xs"]
        dims = tuple(self._RENAMES.get(d, d) for d in dims)
        wl, worder, spectral = _spectral_to_wavelength(
            coords, dims
        )
        if dims[-1] not in _SPECTRAL_COORDS:
            msg = f"xs must have the spectral dim last, got {dims}"
            raise ValueError(msg)
        params = {}
        xs = np.asarray(xs, dtype=np.float64)
        for ax, d in enumerate(dims[:-1]):
            g = coords[d]
            order = np.argsort(g)
            params[d] = g[order]
            xs = np.take(xs, order, axis=ax)
        xs = np.take(xs, worder, axis=-1)
        super().__init__(wl, xs, params)


class OpticalDatabaseGenericScatterer(ScattererDatabase):
    """File/dataset front-end for scatterer databases (reference
    ``OpticalDatabaseGenericScatterer``, ``optical/database.py:287-560``):
    variables ``xs_total``, ``xs_scattering`` over (param..., spectral) and
    ``lm_a1`` (optional ``lm_a2``/``lm_a3``/``lm_b1``) with an additional
    leading ``legendre`` dim."""

    def __init__(self, db_filepath=None, db=None):
        ds = _load_dataset(db_filepath, db)
        coords = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in ds["coords"].items()
        }
        dims_xt, xt = ds["data_vars"]["xs_total"]
        wl, worder, spectral = _spectral_to_wavelength(coords, dims_xt)
        param_dims = [d for d in dims_xt if d not in _SPECTRAL_COORDS]
        params = {d: coords[d] for d in param_dims}

        def prep(name, extra_leg):
            dims, arr = ds["data_vars"][name]
            arr = np.asarray(arr, dtype=np.float64)
            want = (
                (("legendre",) if extra_leg else ())
                + tuple(param_dims) + (spectral,)
            )
            perm = [dims.index(d) for d in want]
            arr = np.transpose(arr, perm)
            return np.take(arr, worder, axis=-1)

        lm = {}
        for nm in ("lm_a2", "lm_a3", "lm_b1"):
            if nm in ds["data_vars"]:
                lm[nm] = prep(nm, True)
        super().__init__(
            wl,
            prep("xs_total", False),
            prep("xs_scattering", False),
            prep("lm_a1", True),
            params=params,
            lm_a2=lm.get("lm_a2"),
            lm_a3=lm.get("lm_a3"),
            lm_b1=lm.get("lm_b1"),
        )
