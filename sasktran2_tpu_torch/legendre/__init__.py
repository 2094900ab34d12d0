"""Greek-coefficient expansion of phase-matrix elements.

Role of the reference's ``src/sasktran2/legendre/__init__.py``: project
tabulated phase-function elements P11/P12/P22/P33/P34/P44(theta) onto
generalized spherical functions (Wigner d) to obtain the greek
coefficients a1, a2, a3, a4, b1, b2 used by the polarized solver.

(Numpy copy of ``sasktran2_tpu/legendre/__init__.py`` for the PyTorch
port; a test pins it to the original.)
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate

from ..ops.quadrature import gauss_legendre
from ..ops.wigner import wigner_d


def compute_greek_coefficients(
    p11, p12, p22, p33, p34, p44, angle_grid, num_coeff: int
):
    """Greek coefficients from phase-matrix elements tabulated on an
    ``angle_grid`` [degrees, spanning 0..180], each with shape
    [wavelength, angle]. Returns six [wavelength, num_coeff] arrays
    (a1, a2, a3, a4, b1, b2).

    The projection integral uses Gauss-Legendre nodes split at
    cos(theta) = 0.995 so the forward-peak region is resolved, matching
    the reference's scheme; phase elements are resampled onto the nodes
    with monotone (PCHIP) interpolation.
    """
    p11, p12, p22, p33, p34, p44 = (
        np.atleast_2d(np.asarray(p, dtype=np.float64))
        for p in (p11, p12, p22, p33, p34, p44)
    )
    cos_theta = np.cos(np.deg2rad(np.asarray(angle_grid)))[::-1]

    # split Gauss-Legendre quadrature: [-1, c] + [c, 1], c = 0.995
    c = 0.995
    nodes, weights = gauss_legendre(num_coeff)
    nodes_left = (c + 1.0) / 2.0 * nodes + (c - 1.0) / 2.0
    weights_left = (c + 1.0) / 2.0 * weights
    nodes_right = (1.0 - c) / 2.0 * nodes + (1.0 + c) / 2.0
    weights_right = (1.0 - c) / 2.0 * weights
    mu = np.concatenate([nodes_left, nodes_right])
    w = np.concatenate([weights_left, weights_right])

    theta = np.arccos(mu)
    ls = np.arange(num_coeff)
    norm = (2.0 * ls + 1.0) / 2.0  # 1 / (2 / (2l+1))
    # [L, nodes] projection kernels: d^l_{mn}(theta) * w * (2l+1)/2
    d00 = wigner_d(theta, 0, 0, num_coeff) * w * norm[:, None]
    d22 = wigner_d(theta, 2, 2, num_coeff) * w * norm[:, None]
    d2m2 = wigner_d(theta, 2, -2, num_coeff) * w * norm[:, None]
    d02 = wigner_d(theta, 0, 2, num_coeff) * w * norm[:, None]

    def resample(p):
        # [nodes, wavelength]
        return interpolate.PchipInterpolator(
            cos_theta, np.transpose(np.flip(p, axis=1))
        )(mu)

    p11_i, p12_i, p22_i = resample(p11), resample(p12), resample(p22)
    p33_i, p34_i, p44_i = resample(p33), resample(p34), resample(p44)

    lm_a1 = d00 @ p11_i
    lm_a4 = d00 @ p44_i
    lm_b1 = d02 @ p12_i
    lm_b2 = -(d02 @ p34_i)
    t1 = d22 @ (p22_i + p33_i)
    t2 = d2m2 @ (p22_i - p33_i)
    lm_a2 = (t1 + t2) / 2.0
    lm_a3 = (t1 - t2) / 2.0

    return tuple(
        np.transpose(x) for x in (lm_a1, lm_a2, lm_a3, lm_a4, lm_b1, lm_b2)
    )


__all__ = ["compute_greek_coefficients"]
