"""A tiny xarray-like container for engine output.

The reference returns ``xarray.Dataset`` objects
(``upstream SASKTRAN2 src/sasktran2/engine.py:117-263``). xarray is not part of
this image's baked-in dependency set, so this module provides a minimal,
dependency-free stand-in with the subset of behavior the reference's tests
and user workflows rely on: named variables with dims, coords, numpy
conversion, arithmetic between aligned DataArrays, ``sel``/``isel`` by
dimension name, and ``max``/``abs`` reductions over named dims.

(Copy of ``sasktran2_tpu/dataset.py`` for the PyTorch port.)
"""

from __future__ import annotations

import numpy as np


class DataArray:
    __slots__ = ("values", "dims")

    def __init__(self, values, dims):
        self.values = np.asarray(values)
        dims = tuple(dims)
        if len(dims) != self.values.ndim:
            msg = f"dims {dims} do not match array of ndim {self.values.ndim}"
            raise ValueError(msg)
        self.dims = dims

    # --- conversion -------------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.values

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    @property
    def shape(self):
        return self.values.shape

    # --- selection --------------------------------------------------------
    def isel(self, **indexers) -> "DataArray":
        idx = [slice(None)] * self.values.ndim
        new_dims = list(self.dims)
        drop = []
        for dim, i in indexers.items():
            if dim not in self.dims:
                msg = f"dimension {dim} not in {self.dims}"
                raise KeyError(msg)
            ax = self.dims.index(dim)
            idx[ax] = i
            if np.isscalar(i) or (isinstance(i, np.ndarray) and i.ndim == 0):
                drop.append(dim)
        out = self.values[tuple(idx)]
        for d in drop:
            new_dims.remove(d)
        return DataArray(out, new_dims)

    # --- reductions -------------------------------------------------------
    def max(self, dim=None):
        if dim is None:
            return DataArray(np.max(self.values), ())
        ax = self.dims.index(dim)
        return DataArray(np.max(self.values, axis=ax),
                         [d for d in self.dims if d != dim])

    def mean(self, dim=None):
        if dim is None:
            return DataArray(np.mean(self.values), ())
        ax = self.dims.index(dim)
        return DataArray(np.mean(self.values, axis=ax),
                         [d for d in self.dims if d != dim])

    # --- arithmetic (aligned by broadcasting trailing-consistent dims) ----
    def _binop(self, other, op):
        if isinstance(other, DataArray):
            a, b, dims = _broadcast(self, other)
            return DataArray(op(a, b), dims)
        return DataArray(op(self.values, other), self.dims)

    def __add__(self, o):
        return self._binop(o, np.add)

    def __radd__(self, o):
        return self._binop(o, np.add)

    def __sub__(self, o):
        return self._binop(o, np.subtract)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, np.multiply)

    def __rmul__(self, o):
        return self._binop(o, np.multiply)

    def __truediv__(self, o):
        return self._binop(o, np.divide)

    def __neg__(self):
        return DataArray(-self.values, self.dims)

    def __abs__(self):
        return DataArray(np.abs(self.values), self.dims)

    def __repr__(self):
        return f"<DataArray {dict(zip(self.dims, self.shape))}>\n{self.values!r}"


def _broadcast(a: DataArray, b: DataArray):
    """Align two DataArrays on the union of their dims (xarray-style outer
    alignment by dimension *name*, sizes must agree)."""
    dims = list(a.dims)
    for d in b.dims:
        if d not in dims:
            dims.append(d)
    av = _expand(a, dims)
    bv = _expand(b, dims)
    return av, bv, dims


def _expand(x: DataArray, dims):
    """Axes of ``x`` permuted into the order they appear in ``dims``, with
    size-1 axes inserted for dims not present (numpy broadcasting finishes
    the alignment)."""
    present = [d for d in dims if d in x.dims]
    v = np.transpose(x.values, [x.dims.index(d) for d in present])
    shape = []
    j = 0
    for d in dims:
        if d in x.dims:
            shape.append(v.shape[j])
            j += 1
        else:
            shape.append(1)
    return v.reshape(shape)


class Dataset:
    """Dict-of-DataArray with coords. Supports ``ds["name"]``,
    ``ds.coords["wavelength"]``, membership tests, and attribute access for
    variable names (``ds.radiance``)."""

    def __init__(self):
        self._vars: dict[str, DataArray] = {}
        self.coords: dict[str, np.ndarray] = {}

    def __setitem__(self, name, value):
        if isinstance(value, tuple) and len(value) == 2:
            dims, arr = value
            value = DataArray(arr, dims)
        if not isinstance(value, DataArray):
            msg = "Dataset values must be DataArray or (dims, array) tuples"
            raise TypeError(msg)
        self._vars[name] = value

    def __getitem__(self, name) -> DataArray:
        return self._vars[name]

    def __contains__(self, name) -> bool:
        return name in self._vars

    def __getattr__(self, name):
        try:
            return self._vars[name]
        except KeyError:
            raise AttributeError(name) from None

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    @property
    def data_vars(self):
        return self._vars

    def dims_of(self, name):
        return self._vars[name].dims

    def __repr__(self):
        lines = ["<Dataset>"]
        for k, v in self._vars.items():
            lines.append(f"  {k}: dims={v.dims} shape={v.shape}")
        for k, v in self.coords.items():
            lines.append(f"  coord {k}: len={np.size(v)}")
        return "\n".join(lines)

