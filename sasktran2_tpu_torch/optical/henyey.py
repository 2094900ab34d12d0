"""Henyey-Greenstein scattering phase/extinction helper (reference
``src/sasktran2/optical/henyey.py``).

Legendre expansion of the HG phase function: beta_l = (2l+1) g^l.

(Numpy copy of ``sasktran2_tpu/optical/henyey.py`` for the PyTorch
port; a test pins it to the original.)
"""

from __future__ import annotations

import numpy as np


class HenyeyGreenstein:
    def __init__(self, g: float):
        self.g = float(g)

    def legendre_coefficients(self, nleg: int) -> np.ndarray:
        ls = np.arange(nleg)
        return (2 * ls + 1) * self.g**ls
