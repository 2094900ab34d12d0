"""Single-scatter-albedo clamp, solar-beam attenuation and per-azimuth-mode
angular tables of the discrete-ordinates solvers (counterpart of
``sasktran2_tpu/rt/disco.py:61-151``).

The tables are host-side numpy, built by the same code as the JAX
package's; a test pins them array-equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from ..ops.quadrature import streams
from ..ops.wigner import normalized_alp

# The solver needs omega strictly below 1: conservative scattering gives a
# zero eigenvalue in the m=0 mode. The ceiling and its reasons are the JAX
# package's (``sasktran2_tpu/rt/disco.py:61-73``); radiance shifts by about
# 1e-6 relative for a fully conservative atmosphere.
SSA_CEILING = 1.0 - 1e-4
KMIN = 1e-8


def clamp_ssa(omega):
    """Clamp omega below ``SSA_CEILING`` with a straight-through gradient:
    d(clamp)/d(omega) = 1 everywhere, so ssa weighting functions of a
    pure-Rayleigh (omega = 1) atmosphere are not zeroed."""
    return omega + (omega.clamp(max=SSA_CEILING) - omega).detach()


def beam_attenuation(dtau, mu0: float, chapman=None):
    """The direct solar beam through the layers (TOA first): its
    transmission at each layer top, t_top [P, W], and at the ground,
    t_ground [W], and each layer's mean slant factor sbar [P, W] (the slant
    optical depth across the layer over its dtau). ``chapman`` [P, P]
    (numpy) maps the layer dtau to the slant optical depth down to each
    layer's bottom; None is the plane-parallel 1/mu0
    (``sasktran2_tpu/rt/disco_nstream.py:413-425``)."""
    dt, dev = dtau.dtype, dtau.device
    P = dtau.shape[0]
    if chapman is None:
        c = torch.tril(torch.ones((P, P), dtype=dt, device=dev)) / mu0
    else:
        c = torch.as_tensor(chapman, dtype=dt, device=dev)
    slant_bottom = torch.einsum("pq,qw->pw", c, dtau)
    slant_top = torch.cat(
        [torch.zeros_like(slant_bottom[:1]), slant_bottom[:-1]], dim=0
    )
    sbar = (slant_bottom - slant_top) / torch.clamp(dtau, min=1e-30)
    return torch.exp(-slant_top), torch.exp(-slant_bottom[-1]), sbar


@dataclass(frozen=True)
class ModeTables:
    """Static per-azimuth-mode angular tables (host-side numpy).

    lam_stream [M, L, N], lam_sun [M, L], lam_user [M, L, U], parity
    [M, L]; mu, w [N] stream cosines and weights; mu0; user_mu [U].
    """

    lam_stream: np.ndarray
    lam_sun: np.ndarray
    lam_user: np.ndarray
    parity: np.ndarray
    mu: np.ndarray
    w: np.ndarray
    mu0: float
    user_mu: np.ndarray


def build_mode_tables(
    nstr: int,
    nlegendre: int,
    mu0: float,
    user_mu: np.ndarray,
    num_azimuth: int | None = None,
) -> ModeTables:
    """Build the static angular tables for all azimuth modes at one SZA.
    ``user_mu`` are positive cosines; the caller tracks whether each user
    direction is up- or down-welling."""
    if num_azimuth is None:
        num_azimuth = nstr
    mu, w = streams(nstr)
    L = max(nlegendre, 1)
    lam_stream = np.zeros((num_azimuth, L, len(mu)))
    lam_sun = np.zeros((num_azimuth, L))
    lam_user = np.zeros((num_azimuth, L, len(user_mu)))
    parity = np.zeros((num_azimuth, L))
    ls = np.arange(L)
    for m in range(num_azimuth):
        lam_stream[m] = normalized_alp(mu, m, L)
        lam_sun[m] = normalized_alp(np.array(mu0), m, L)
        lam_user[m] = normalized_alp(
            np.asarray(user_mu, dtype=np.float64), m, L
        )
        parity[m] = (-1.0) ** (ls + m)
    return ModeTables(
        lam_stream=lam_stream,
        lam_sun=lam_sun,
        lam_user=lam_user,
        parity=parity,
        mu=mu,
        w=w,
        mu0=float(mu0),
        user_mu=np.asarray(user_mu, dtype=np.float64),
    )
