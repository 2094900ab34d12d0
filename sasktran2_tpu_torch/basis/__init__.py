"""Spectral basis functions and grid resampling.

Role of the reference's ``rebasis`` crate
(upstream SASKTRAN2 ``rust/rebasis/src/{basis,grid}.rs``): basis functions
(Delta / Rectangle / Triangle / Gaussian) attached to spectral grid points,
with overlap integrals producing a ``mapping_matrix`` that resamples
quantities between spectral grids (the machinery behind
``SpectralGridMode.AtmosphereIntegratedLineShape``).

(Numpy copy of ``sasktran2_tpu/basis/__init__.py`` for the PyTorch
port; a test pins it to the original.)
"""

from __future__ import annotations

import numpy as np


class Basis:
    def integral(self):  # integral of the basis function
        raise NotImplementedError

    def evaluate(self, x):
        raise NotImplementedError


class Delta(Basis):
    def __init__(self, center):
        self.center = float(center)

    def integral(self):
        return 1.0


class Rectangle(Basis):
    def __init__(self, center, width):
        self.center = float(center)
        self.width = float(width)

    def evaluate(self, x):
        return np.where(
            np.abs(np.asarray(x) - self.center) <= self.width / 2,
            1.0 / self.width, 0.0,
        )

    def integral(self):
        return 1.0


class Triangle(Basis):
    def __init__(self, center, left_width, right_width=None):
        self.center = float(center)
        self.lw = float(left_width)
        self.rw = float(right_width if right_width is not None else left_width)

    def evaluate(self, x):
        x = np.asarray(x)
        h = 2.0 / (self.lw + self.rw)
        left = (x >= self.center - self.lw) & (x < self.center)
        right = (x >= self.center) & (x <= self.center + self.rw)
        out = np.zeros_like(x, dtype=np.float64)
        out[left] = h * (1.0 - (self.center - x[left]) / self.lw)
        out[right] = h * (1.0 - (x[right] - self.center) / self.rw)
        return out

    def integral(self):
        return 1.0


class Gaussian(Basis):
    def __init__(self, center, fwhm):
        self.center = float(center)
        self.sigma = float(fwhm) / (2.0 * np.sqrt(2.0 * np.log(2.0)))

    def evaluate(self, x):
        x = np.asarray(x)
        return np.exp(-0.5 * ((x - self.center) / self.sigma) ** 2) / (
            self.sigma * np.sqrt(2.0 * np.pi)
        )

    def integral(self):
        return 1.0


class Grid:
    """A spectral grid: sample points each carrying a basis function."""

    def __init__(self, bases):
        self.bases = list(bases)

    @classmethod
    def from_deltas(cls, centers):
        return cls([Delta(c) for c in np.asarray(centers, dtype=np.float64)])

    @classmethod
    def from_rectangles(cls, centers, widths):
        centers = np.asarray(centers, dtype=np.float64)
        widths = np.broadcast_to(np.asarray(widths, dtype=np.float64),
                                 centers.shape)
        return cls([Rectangle(c, w) for c, w in zip(centers, widths)])

    @classmethod
    def from_triangles(cls, centers, widths):
        centers = np.asarray(centers, dtype=np.float64)
        widths = np.broadcast_to(np.asarray(widths, dtype=np.float64),
                                 centers.shape)
        return cls([Triangle(c, w) for c, w in zip(centers, widths)])

    @classmethod
    def from_gaussians(cls, centers, fwhms):
        centers = np.asarray(centers, dtype=np.float64)
        fwhms = np.broadcast_to(np.asarray(fwhms, dtype=np.float64),
                                centers.shape)
        return cls([Gaussian(c, f) for c, f in zip(centers, fwhms)])

    @property
    def centers(self):
        return np.array([b.center for b in self.bases])

    def __len__(self):
        return len(self.bases)


def mapping_matrix(from_grid: Grid, to_grid: Grid, nquad: int = 129):
    """M such that ``f_to = M @ f_from``: each destination basis integrates
    the (linearly-interpolated) source samples against its response
    (reference ``rebasis::grid::mapping_matrix``)."""
    src_centers = from_grid.centers
    M = np.zeros((len(to_grid), len(from_grid)))
    for i, b in enumerate(to_grid.bases):
        if isinstance(b, Delta):
            row = _interp_row(src_centers, b.center)
        else:
            # quadrature over the basis support
            lo, hi = _support(b)
            xq = np.linspace(lo, hi, nquad)
            wq = np.gradient(xq)
            resp = b.evaluate(xq)
            row = np.zeros(len(from_grid))
            for x, w, r in zip(xq, wq, resp):
                row += w * r * _interp_row(src_centers, x)
            row /= row.sum() if row.sum() > 0 else 1.0
        M[i] = row
    return M


def _support(b):
    if isinstance(b, Rectangle):
        return b.center - b.width / 2, b.center + b.width / 2
    if isinstance(b, Triangle):
        return b.center - b.lw, b.center + b.rw
    if isinstance(b, Gaussian):
        return b.center - 4 * b.sigma, b.center + 4 * b.sigma
    msg = f"unsupported basis {type(b)}"
    raise TypeError(msg)


def _interp_row(centers, x):
    row = np.zeros(len(centers))
    if x <= centers[0]:
        row[0] = 1.0
    elif x >= centers[-1]:
        row[-1] = 1.0
    else:
        j = np.searchsorted(centers, x) - 1
        f = (x - centers[j]) / (centers[j + 1] - centers[j])
        row[j] = 1 - f
        row[j + 1] = f
    return row
