"""Single-scatter-albedo clamp, solar-beam attenuation, the thermal layer
fit, BRDF azimuth moments and per-azimuth-mode angular tables of the
discrete-ordinates solvers (counterpart of
``sasktran2_tpu/rt/disco.py:61-231``).

The tables are host-side numpy, built by the same code as the JAX
package's; a test pins them array-equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

import torch

from ..ops.quadrature import streams
from ..ops.wigner import normalized_alp
from .brdf import KERNELS as BRDF_KERNELS

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


def thermal_layer_fit(thermal_b0, thermal_b1_bottom, dtau,
                      surface_emission, albedo):
    """The thermal source of each layer as b0 exp(-b1 tau), tau the
    optical depth below the layer top, fitted to the Planck values at its
    top (``thermal_b0``) and bottom (``thermal_b1_bottom``), both [P, W]
    (``sasktran2_tpu/rt/disco_nstream.py:443-464``); a layer whose two
    values are not both positive gets their mean, flat. Returns (b0, b1,
    surface emission [W], zeros where None).

    The logarithm's arguments are floored where the fit does not apply, so
    that the branch ``torch.where`` discards stays finite in the backward
    pass too. The reference floors at 1e-300, which is 0 in float32: there
    the floor is the dtype's smallest normal number."""
    if thermal_b0 is None or thermal_b1_bottom is None:
        msg = (
            "a thermal source needs both thermal_b0 and thermal_b1_bottom "
            "(the Planck source at the layer tops and bottoms)"
        )
        raise ValueError(msg)
    dt = dtau.dtype
    floor = 1e-300 if dt == torch.float64 else torch.finfo(dt).tiny
    both_pos = (thermal_b0 > 0.0) & (thermal_b1_bottom > 0.0)
    b1 = torch.where(
        both_pos,
        torch.log(
            torch.clamp(thermal_b0, min=floor)
            / torch.clamp(thermal_b1_bottom, min=floor)
        ) / torch.clamp(dtau, min=1e-30),
        torch.zeros_like(dtau),
    )
    b0 = torch.where(
        both_pos, thermal_b0, 0.5 * (thermal_b0 + thermal_b1_bottom)
    )
    if surface_emission is None:
        surface_emission = torch.zeros_like(albedo)
    return b0, b1, surface_emission


BRDF_AZIMUTH_NODES = 64


def brdf_azimuth_moments(brdf, brdf_args, mu, user_mu, mu0, m_indices):
    """Per-mode azimuth moments of a scalar BRDF kernel
    (``sasktran2_tpu/rt/disco.py:201-231``): the cos(m x) moments of the
    kernel over a 64-point midpoint rule in the internal Fourier variable
    x, evaluated at the geometric relative azimuth pi - x, for every
    wavelength of ``brdf_args`` [W, nargs] at once and differentiable in
    it. ``mu`` [N] and ``user_mu`` [U] are tensors of the working dtype;
    ``m_indices`` the modes. Returns rho_stream [M, W, N, N], rho_user
    [M, W, U, N], rho_sun_stream [M, W, N] and rho_sun_user [M, W, U]
    (outgoing direction first, incoming second)."""
    if not isinstance(brdf, tuple(BRDF_KERNELS.values())):
        msg = (
            f"BRDF kernel {type(brdf).__module__}.{type(brdf).__name__} is "
            "not one of the port's (sasktran2_tpu_torch.rt.brdf); "
            "params.brdf_from_reference carries a JAX-side kernel over"
        )
        raise NotImplementedError(msg)
    if brdf_args is None:
        msg = "a BRDF needs its brdf_args [W, nargs]"
        raise ValueError(msg)
    dt, dev = brdf_args.dtype, brdf_args.device
    nq = BRDF_AZIMUTH_NODES
    xq = 2.0 * math.pi * (
        torch.arange(nq, dtype=dt, device=dev) + 0.5
    ) / nq
    phi_geo = math.pi - xq
    m = torch.as_tensor(np.asarray(m_indices), dtype=dt, device=dev)
    cosmx = torch.cos(m[:, None] * xq[None, :]) / nq     # [M, Q], (1/2pi) dx

    def moments(mu_out, mu_in):
        kern = brdf.kernel(
            mu_out[:, None, None], mu_in[None, :, None],
            phi_geo[None, None, :], brdf_args,
        )                                                # [W, O, I, Q]
        return torch.einsum("woiq,mq->mwoi", kern, cosmx)

    mu0t = torch.full((1,), float(mu0), dtype=dt, device=dev)
    return {
        "rho_stream": moments(mu, mu),
        "rho_user": moments(user_mu, mu),
        "rho_sun_stream": moments(mu, mu0t)[..., 0],
        "rho_sun_user": moments(user_mu, mu0t)[..., 0],
    }


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
