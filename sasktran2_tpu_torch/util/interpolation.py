"""Grid interpolation helpers (reference ``src/sasktran2/util/interpolation.py:6``).

(Copy of ``sasktran2_tpu/util/interpolation.py`` for the PyTorch port.)
"""

from __future__ import annotations

import numpy as np


def linear_interpolating_matrix(
    from_grid: np.ndarray, to_grid: np.ndarray, out_of_bounds_mode: str = "zero"
) -> np.ndarray:
    """Matrix M with ``f(to_grid) = M @ f(from_grid)`` by linear interpolation.

    out_of_bounds_mode: "zero" (rows outside the grid are zero) or "extend"
    (clamp to the boundary value).
    """
    from_grid = np.asarray(from_grid, dtype=np.float64)
    to_grid = np.asarray(to_grid, dtype=np.float64)
    M = np.zeros((len(to_grid), len(from_grid)))
    if len(from_grid) == 1:
        if out_of_bounds_mode == "extend":
            M[:, 0] = 1.0
        else:
            M[np.isclose(to_grid, from_grid[0]), 0] = 1.0
        return M
    for i, x in enumerate(to_grid):
        if x < from_grid[0]:
            if out_of_bounds_mode == "extend":
                M[i, 0] = 1.0
            continue
        if x > from_grid[-1]:
            if out_of_bounds_mode == "extend":
                M[i, -1] = 1.0
            continue
        j = min(np.searchsorted(from_grid, x, side="right") - 1, len(from_grid) - 2)
        f = (x - from_grid[j]) / (from_grid[j + 1] - from_grid[j])
        M[i, j] = 1.0 - f
        M[i, j + 1] = f
    return M
