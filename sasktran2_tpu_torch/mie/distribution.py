"""Particle size distributions + Mie ensemble integration.

Counterpart of ``sasktran2_tpu/mie/distribution.py``: scipy.stats
distribution wrappers with named parameters (numpy copies, pinned to the
originals by a test), and ``integrate_mie``, which averages Mie cross
sections and phase-matrix elements over a particle size distribution.
The Mie solution of each wavelength runs on the device
(``optical.mie``, the multipole coefficients computed once and shared by
the efficiencies and the amplitudes, each radius at its own nmax: see
``optical/mie.py``); the ensemble sums and the greek coefficients run on
the host as the reference runs them.
"""

from __future__ import annotations

import abc

import numpy as np
from scipy import integrate
from scipy.stats import gamma, lognorm, triang, uniform

from ..ops.quadrature import gauss_legendre


class ParticleSizeDistribution(abc.ABC):
    """Named-parameter particle size distribution."""

    def __init__(self, identifier: str) -> None:
        self._identifier = identifier

    @abc.abstractmethod
    def distribution(self, **kwargs):
        """scipy.stats rv_continuous for the given named parameters."""

    @property
    def identifier(self) -> str:
        return self._identifier

    @abc.abstractmethod
    def args(self) -> list[str]:
        """Names of the free parameters."""

    def freeze(self, **kwargs) -> "FrozenDistribution":
        return FrozenDistribution(self, kwargs)


class LogNormalDistribution(ParticleSizeDistribution):
    """Lognormal distribution with ``median_radius`` and ``mode_width``."""

    def __init__(self) -> None:
        super().__init__("lognormal")

    def distribution(self, **kwargs):
        return lognorm(np.log(kwargs["mode_width"]),
                       scale=kwargs["median_radius"])

    def args(self):
        return ["median_radius", "mode_width"]


class UniformDistribution(ParticleSizeDistribution):
    """Uniform distribution between ``min_radius`` and ``max_radius``."""

    def __init__(self) -> None:
        super().__init__("uniform")

    def distribution(self, **kwargs):
        left, right = kwargs["min_radius"], kwargs["max_radius"]
        if left >= right:
            msg = f"Left bound {left} must be less than right bound {right}"
            raise ValueError(msg)
        return uniform(left, right - left)

    def args(self):
        return ["min_radius", "max_radius"]


class GammaDistribution(ParticleSizeDistribution):
    """Gamma distribution with shape ``alpha`` and rate ``beta``."""

    def __init__(self) -> None:
        super().__init__("gamma")

    def distribution(self, **kwargs):
        return gamma(a=kwargs["alpha"], scale=1.0 / kwargs["beta"])

    def args(self):
        return ["alpha", "beta"]


class TriangularDistribution(ParticleSizeDistribution):
    """Triangular distribution: 0 at ``min_radius``, peak at
    ``center_radius``, back to 0 at ``max_radius``."""

    def __init__(self) -> None:
        super().__init__("triangular")

    def distribution(self, **kwargs):
        left, right = kwargs["min_radius"], kwargs["max_radius"]
        mode = kwargs["center_radius"]
        if left >= right:
            msg = f"Left bound {left} must be less than right bound {right}"
            raise ValueError(msg)
        return triang(loc=left, scale=right - left,
                      c=(mode - left) / (right - left))

    def args(self):
        return ["min_radius", "max_radius", "center_radius"]


class FrozenDistribution(ParticleSizeDistribution):
    """A distribution with some parameters pinned."""

    def __init__(self, base_distribution: ParticleSizeDistribution,
                 frozen_parameters: dict) -> None:
        identifier = f"frozen_{base_distribution.identifier}"
        for key, value in frozen_parameters.items():
            identifier += f"_{key}_{value}"
            if key not in base_distribution.args():
                msg = f"Frozen key {key} not in base distribution args"
                raise ValueError(msg)
        super().__init__(identifier)
        self._distribution = base_distribution
        self._frozen_parameters = frozen_parameters
        self._args = [a for a in base_distribution.args()
                      if a not in frozen_parameters]

    def distribution(self, **kwargs):
        return self._distribution.distribution(
            **{**self._frozen_parameters, **kwargs}
        )

    def args(self):
        return self._args


def _integration_grid(prob_dist, num_quad, maxintquantile):
    """Gauss-Legendre radius grid covering the mass of pdf(r) r^2."""
    norm = integrate.quad(
        lambda r: prob_dist.pdf(r) * r**2, 0, 1e25,
        points=(prob_dist.mean(),),
    )[0]

    def pdf_r2(r):
        return prob_dist.pdf(r) * r**2 / norm

    max_r = prob_dist.mean()
    while (
        integrate.quad(pdf_r2, 0, max_r * 2, points=(prob_dist.mean(),))[0]
        - integrate.quad(pdf_r2, 0, max_r, points=(prob_dist.mean(),))[0]
    ) > (1.0 - maxintquantile):
        max_r *= 2

    x, w = gauss_legendre(num_quad)
    r = 0.5 * (x + 1.0) * max_r
    w = w * max_r / 2.0
    return r, w


def integrate_mie(
    prob_dist,
    refrac_index_fn,
    wavelengths,
    num_angles=1801,
    num_quad=1024,
    maxintquantile=0.99999,
    compute_coeffs=False,
    num_coeffs=64,
    device=None,
):
    """Average Mie properties over a particle size distribution.

    ``prob_dist`` is a frozen scipy.stats distribution in the same length
    unit as ``wavelengths``; ``refrac_index_fn(wavelength) -> complex``.
    Returns a dict with ``angle`` [deg], ``wavelength``, phase elements
    ``p11/p12/p33/p34`` [wavelength, angle] normalized so
    ``integral p11 dOmega = 4 pi``, and cross sections ``xs_total /
    xs_scattering / xs_absorption`` in wavelength-unit^2 (phase
    conventions P22 = P11, P44 = P33, p12 = |S1|^2 - |S2|^2).

    With ``compute_coeffs``, adds greek coefficients ``lm_a1..lm_b2``
    [wavelength, num_coeffs] from :func:`~..legendre.
    compute_greek_coefficients`. The Mie runs on ``device`` (None: the
    GPU, which must exist).
    """
    import torch

    from ..device import resolve_device
    from ..optical.mie import (
        amplitudes_from_coefficients,
        efficiencies_from_coefficients,
        mie_coefficients,
    )

    dev = resolve_device(device)
    wavelengths = np.atleast_1d(np.asarray(wavelengths, dtype=np.float64))
    angles = np.linspace(0.0, 180.0, num_angles)
    mu = np.cos(np.deg2rad(angles))

    r, w = _integration_grid(prob_dist, num_quad, maxintquantile)
    pdf = prob_dist.pdf(r)
    area = np.pi * r**2

    out = {
        "angle": angles,
        "wavelength": wavelengths,
        "p11": np.zeros((wavelengths.size, num_angles)),
        "p12": np.zeros((wavelengths.size, num_angles)),
        "p33": np.zeros((wavelengths.size, num_angles)),
        "p34": np.zeros((wavelengths.size, num_angles)),
        "xs_total": np.zeros(wavelengths.size),
        "xs_scattering": np.zeros(wavelengths.size),
        "xs_absorption": np.zeros(wavelengths.size),
    }

    mu_t = torch.as_tensor(mu, device=dev)
    for idx, wl in enumerate(wavelengths):
        m = complex(refrac_index_fn(wl))
        x = torch.as_tensor(2.0 * np.pi * r / wl, device=dev)
        an, bn = mie_coefficients(x, m, own_nmax=True)
        qext, qsca = efficiencies_from_coefficients(x, an, bn)
        s1, s2 = amplitudes_from_coefficients(x, an, bn, mu_t)
        s1, s2 = s1.cpu().numpy(), s2.cpu().numpy()
        qext, qsca = qext.cpu().numpy(), qsca.cpu().numpy()

        wpdf = w * pdf
        cext = float(np.dot(wpdf, qext * area))
        csca = float(np.dot(wpdf, qsca * area))
        out["xs_total"][idx] = cext
        out["xs_scattering"][idx] = csca
        out["xs_absorption"][idx] = cext - csca

        p11 = np.einsum("b,bt->t", wpdf, np.abs(s1) ** 2 + np.abs(s2) ** 2)
        p12 = np.einsum("b,bt->t", wpdf, np.abs(s1) ** 2 - np.abs(s2) ** 2)
        cross = s1 * np.conj(s2)
        p33 = np.einsum("b,bt->t", wpdf, 2.0 * np.real(cross))
        p34 = np.einsum("b,bt->t", wpdf, 2.0 * np.imag(cross))

        k = 2.0 * np.pi / wl
        c = 4.0 * np.pi / (2.0 * k**2 * csca)
        out["p11"][idx] = p11 * c
        out["p12"][idx] = p12 * c
        out["p33"][idx] = p33 * c
        out["p34"][idx] = p34 * c

    if compute_coeffs:
        from ..legendre import compute_greek_coefficients

        a1, a2, a3, a4, b1, b2 = compute_greek_coefficients(
            p11=out["p11"], p12=out["p12"], p22=out["p11"],
            p33=out["p33"], p34=out["p34"], p44=out["p33"],
            angle_grid=angles, num_coeff=num_coeffs,
        )
        out.update({"lm_a1": a1, "lm_a2": a2, "lm_a3": a3, "lm_a4": a4,
                    "lm_b1": b1, "lm_b2": b2})
    return out
