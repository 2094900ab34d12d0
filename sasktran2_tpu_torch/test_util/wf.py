"""Numeric-vs-analytic weighting function validation harness.

Counterpart of ``sasktran2_tpu/test_util/wf.py`` (upstream
``src/sasktran2/test_util/wf.py:10-60``): perturb each element of an input
array with central finite differences, recompute the radiance with the
port's ``Engine``, and compare against the engine's analytic ``wf_*``
output with a per-altitude-normalized relative tolerance.
"""

from __future__ import annotations

import numpy as np

from ..dataset import DataArray


def numeric_wf(
    input_var: np.ndarray,
    fractional_change: float,
    engine,
    atmosphere,
    analytic_wf_name: str,
):
    """Adds ``<analytic_wf_name>_numeric`` to the base radiance Dataset.

    ``input_var`` is a view of the atmosphere's storage (e.g.
    ``atmosphere.storage.total_extinction[:, 0]``), changed in place and
    restored after each step. The base call computes the analytic
    weighting functions; the perturbed calls read only the radiance, so
    they run with ``atmosphere.calculate_derivatives`` off (restored at
    the end). A step that cannot go below the input (a negative element)
    is one-sided, against the base radiance."""
    base = engine.calculate_radiance(atmosphere)
    analytic = base[analytic_wf_name]
    central = np.zeros_like(analytic.to_numpy())

    def radiance():
        return engine.calculate_radiance(atmosphere)["radiance"].to_numpy()

    derivatives = atmosphere.calculate_derivatives
    atmosphere.calculate_derivatives = False
    try:
        for i in range(len(input_var)):
            dx = input_var[i] * fractional_change
            if dx == 0:
                dx = np.nanmean(input_var) * fractional_change
            input_var[i] += dx
            above = radiance()
            if input_var[i] >= dx:
                input_var[i] -= 2 * dx
                below = radiance()
                input_var[i] += dx
                central[i] = (above - below) / (2 * dx)
            else:
                central[i] = (above - base["radiance"].to_numpy()) / dx
                input_var[i] -= dx
    finally:
        atmosphere.calculate_derivatives = derivatives

    base[analytic_wf_name + "_numeric"] = DataArray(central, analytic.dims)
    return base


def validate_wf(analytic, numeric, wf_dim="altitude", decimal=6):
    """Normalized comparison (upstream ``wf.py:10-24``): each difference
    over the largest analytic magnitude along ``wf_dim``; elements where
    either side is at most 1e-99 are skipped."""
    a = analytic.to_numpy()
    n = numeric.to_numpy()
    ax = analytic.dims.index(wf_dim)
    max_by = np.abs(a).max(axis=ax, keepdims=True)
    max_by[max_by == 0] = 1e99
    rel = (a - n) / max_by
    sel = (np.abs(a) > 1e-99) & (np.abs(n) > 1e-99)
    np.testing.assert_array_almost_equal(rel[sel], 0, decimal=decimal)
