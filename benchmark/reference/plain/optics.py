"""Level optics of the reference atmosphere: Rayleigh scattering (Bates
1984 refractivities and King factors, as upstream SASKTRAN2's
``optical/rayleigh.rs`` tabulates them), an absorber given by its volume
mixing ratio and tabulated cross section, and the layer optical depth,
single-scatter albedo and phase moments by trapezoidal averaging of the
level values (upstream ``engine.py``'s layer construction).

The level quantities are torch tensors, so that their derivatives with
respect to pressure, temperature, mixing ratio and albedo come from
autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .special import K_BOLTZMANN, safe_div


def _piecewise(wl, ranges, denom_const):
    out = np.zeros_like(wl)
    for (lo, hi), c0, c1 in ranges:
        sel = (wl > lo) & (wl <= hi)
        out = np.where(sel, c0 + c1 / (denom_const - wl**-2.0), out)
    return out


def rayleigh_bates(wavelength_nm):
    """(cross section [m^2], depolarization-corrected beta_2) of dry air
    (N2 78.084%, O2 20.946%, Ar 0.934%, CO2 0.036%)."""
    wl = np.asarray(wavelength_nm, dtype=np.float64) / 1000.0  # um
    o2 = _piecewise(wl, [((0.0, 0.221), 23796.7, 168988.4),
                         ((0.221, 0.288), 22120.4, 203187.6),
                         ((0.288, 0.546), 20564.8, 248089.9),
                         ((0.546, np.inf), 21351.1, 218567.0)], 40.9)
    dl = 0.468 - wl
    n2 = _piecewise(wl, [((0.0, 0.254), 6998.749, 3233582.0),
                         ((0.254, 0.468), 5989.242, 3363266.3),
                         ((0.468, np.inf), 6855.200, 3243157.0)], 144.0)
    n2 = n2 + 2.27684009 * np.sign(dl) * np.exp(-np.abs(dl) / 0.003)
    ar = (np.sqrt(5.547e-4 * (1.0 + 5.15e-3 * wl**-2.0 + 4.19e-5 * wl**-4.0)
                  + 1.0) - 1.0) * 1.0e8
    co2 = (22822.1 + 117.8 * wl**-2.0 + 2406030.0 / (130.0 - wl**-2.0)
           + 15997.0 / (38.9 - wl**-2.0))
    k_o2 = 1.096 + 1.385e-3 * wl**-2.0 + 1.448e-4 * wl**-4.0
    k_n2 = 1.034 + 3.17e-4 * wl**-2.0
    f = {"n2": 0.78084, "o2": 0.20946, "ar": 0.00934, "co2": 0.00036}
    lorenz = (f["o2"] * o2**2 * k_o2 + f["n2"] * n2**2 * k_n2
              + f["ar"] * ar**2 + f["co2"] * co2**2 * 1.15)
    king = f["o2"] * k_o2 + f["n2"] * k_n2 + f["ar"] + f["co2"] * 1.15
    n_ref = 2.686780111798444e25
    xs = 32.0 * np.pi**3 / (3.0 * n_ref**2 * wl**4) * lorenz * 1e8
    delta = 6.0 * (king - 1.0) / (3.0 + 7.0 * king)
    return xs, (1.0 - delta) / (2.0 + delta)


def level_optics(wavelength_nm, pressure, temperature, vmr, xs_table,
                 nleg: int):
    """Extinction [n, A] (1/m), single-scatter albedo [n, A] and phase
    moments [n, A, nleg] at the levels of ``n`` lanes.

    ``wavelength_nm`` [n] (numpy); ``pressure``, ``temperature`` [n, A]
    tensors that Rayleigh scattering sees (the absorber's air density is
    taken from their values, not differentiated: its weighting function
    is the mixing ratio's); ``vmr`` [n, A]; ``xs_table`` the absorber's
    (wavelengths_nm, cross sections m^2), interpolated linearly."""
    dt, dev = pressure.dtype, pressure.device
    xs_r, beta2 = rayleigh_bates(wavelength_nm)
    xs_a = np.interp(wavelength_nm, *xs_table)
    t = torch.as_tensor
    # divided in this order so that float32 autograd never squares k T
    n_air = pressure / temperature / K_BOLTZMANN
    k_ray = n_air * t(xs_r, dtype=dt, device=dev)[:, None]
    k_abs = vmr * n_air.detach() * t(xs_a, dtype=dt, device=dev)[:, None]
    ext = k_ray + k_abs
    ssa = k_ray / ext
    leg = torch.zeros(ext.shape + (nleg,), dtype=dt, device=dev)
    leg[..., 0] = 1.0
    leg[..., 2] = t(beta2, dtype=dt, device=dev)[:, None]
    return ext, ssa, leg


def layer_optics(altitudes_m, ext, ssa, leg):
    """TOA-first layer dtau, omega [n, P] and beta [n, P, L] from level
    values: dtau the trapezoid of the extinction, omega and beta the
    extinction- and scattering-weighted means of the two levels, written
    as the upper value plus the lower level's weight times the
    difference."""
    z = torch.as_tensor(np.asarray(altitudes_m, dtype=np.float64),
                        dtype=ext.dtype, device=ext.device)
    dz = z[1:] - z[:-1]
    k_lo, k_hi = ext[..., :-1], ext[..., 1:]
    k_sum = k_lo + k_hi
    ks_lo, ks_hi = k_lo * ssa[..., :-1], k_hi * ssa[..., 1:]
    ks_sum = ks_lo + ks_hi
    dtau = 0.5 * k_sum * dz
    omega = ssa[..., 1:] + safe_div(k_lo, k_sum) * (ssa[..., :-1] - ssa[..., 1:])
    beta = leg[..., 1:, :] + safe_div(ks_lo, ks_sum)[..., None] * (
        leg[..., :-1, :] - leg[..., 1:, :])
    return dtau.flip(-1), omega.flip(-1), beta.flip(-2)

