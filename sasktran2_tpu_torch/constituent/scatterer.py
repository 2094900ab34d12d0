"""Scattering constituents: extinction-profile aerosols with arbitrary
phase expansions.

Counterpart of ``sasktran2_tpu/constituent/scatterer.py``: the 1D classes
(numpy copies, pinned to the originals by tests), with
``MieScatteringOptical``'s Mie on the device. The 2D classes
(``NumberDensityScatterer2D``, ``ExtinctionScatterer2D``) wait for the
port's 2D geometry (ROADMAP Queue 1 item 8) and raise
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import numpy as np

from ..util.interpolation import linear_interpolating_matrix
from .base import Constituent


class NumberDensityScatterer(Constituent):
    """Scatterer specified by a number density profile and per-wavelength
    optical properties (cross sections + Legendre coefficients).

    ``optical`` must provide ``scattering_properties(wavelengths_nm)``
    returning a dict with ``xs_total`` [W] (m^2), ``ssa`` [W], and
    ``legendre`` [L, W] (a1, beta_0 = 1 convention).
    """

    def __init__(self, optical, altitudes_m, number_density,
                 param_values=None):
        self.optical = optical
        self._altitudes = np.asarray(altitudes_m, dtype=np.float64)
        self.number_density = np.asarray(number_density, dtype=np.float64)
        # optional per-altitude database parameters (e.g. particle size for
        # a ScattererDatabase), given on the constituent altitude grid
        self.param_values = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in (param_values or {}).items()
        }

    def _profile(self, atmo):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), "extend"
        )
        return interp @ self.number_density, interp

    def _props(self, atmo):
        """Properties with a uniform [A, W] / [L, A, W] shape, whether the
        optical property is altitude-independent ([W] / [L, W]) or a
        parameterized database."""
        alts = atmo.model_geometry.altitudes()
        if self.param_values:
            interp = linear_interpolating_matrix(
                self._altitudes, alts, "extend"
            )
            kwargs = {k: interp @ v for k, v in self.param_values.items()}
            props = self.optical.scattering_properties(
                atmo.wavelengths_nm, altitudes_m=alts, **kwargs
            )
        else:
            props = self.optical.scattering_properties(atmo.wavelengths_nm)
        A = len(alts)
        W = len(np.atleast_1d(atmo.wavelengths_nm))
        out = {}
        for k in ("xs_total", "ssa"):
            v = np.asarray(props[k])
            out[k] = (
                np.broadcast_to(v[None, :], (A, W)).copy()
                if v.ndim == 1 else v
            )
        leg = np.asarray(props["legendre"])
        out["legendre"] = (
            np.broadcast_to(leg[:, None, :], (leg.shape[0], A, W)).copy()
            if leg.ndim == 2 else leg
        )
        return out

    def add_to_atmosphere(self, atmo):
        props = self._props(atmo)
        nd, _ = self._profile(atmo)
        k = nd[:, None] * props["xs_total"]  # [A, W]
        kscat = k * props["ssa"]
        atmo.storage.total_extinction += k
        atmo.storage.ssa += kscat
        a1 = atmo.leg_coeff.a1
        leg = props["legendre"]  # [L, A, W]
        L = min(leg.shape[0], a1.shape[0])
        a1[:L] += kscat[None] * leg[:L]

    def _fill_per_nd(self, m, atmo):
        """Fill a derivative mapping with the per-unit-number-density
        derivative block (d_extinction/d_ssa/d_leg_coeff on the model
        grid); interpolators are the caller's business."""
        props = self._props(atmo)
        k_total = atmo.storage.total_extinction
        ssa = atmo.storage.ssa
        a1 = atmo.leg_coeff.a1
        dk = props["xs_total"]  # [A, W]
        dks = dk * props["ssa"]

        m.d_extinction[:] = dk
        with np.errstate(divide="ignore", invalid="ignore"):
            m.d_ssa[:] = np.where(
                k_total > 0, (dks - ssa * dk) / k_total, 0.0
            )
        kscat_tot = ssa * k_total
        leg = props["legendre"]  # [L, A, W]
        L = min(leg.shape[0], a1.shape[0])
        m.ensure_leg(L)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(kscat_tot > 0, 1.0 / kscat_tot, 0.0)
        for li in range(L):
            m.d_leg_coeff[li] = dks * (leg[li] - a1[li]) * inv

    def register_derivative(self, atmo, name: str):
        _, interp = self._profile(atmo)
        m = atmo.storage.get_derivative_mapping(f"wf_{name}")
        self._fill_per_nd(m, atmo)
        m.interpolator = interp.T
        m.interp_dim = f"{name}_altitude"


class GaussianHeightExtinction(NumberDensityScatterer):
    """Aerosol layer with a gaussian-shaped extinction profile normalized
    to a vertical optical depth at a reference wavelength, with analytic
    weighting functions for the layer height, FWHM width, and vertical
    optical depth (reference
    ``src/sasktran2/constituent/gaussianheight.py``).

    The implied number density is
        n(z) = g(z) * tau / (G * xs(lambda_0)),
        g(z) = exp(-4 ln2 (z - h)^2 / w^2),  G = integral of g dz.
    """

    def __init__(self, optical, height_m, width_fwhm_m,
                 vertical_optical_depth, vertical_optical_depth_wavel_nm,
                 altitudes_m):
        # mutable length-1 arrays so numeric perturbation harnesses
        # (test_util.wf.numeric_wf) can poke them element-wise
        self.height_m = np.array([float(height_m)])
        self.width_fwhm_m = np.array([float(width_fwhm_m)])
        self.vertical_optical_depth = np.array(
            [float(vertical_optical_depth)]
        )
        self.wavel0_nm = float(vertical_optical_depth_wavel_nm)
        super().__init__(optical, altitudes_m,
                         np.zeros(np.asarray(altitudes_m).size))

    def _gaussian_terms(self):
        z = self._altitudes
        h = self.height_m.item()
        w = self.width_fwhm_m.item()
        c = 4.0 * np.log(2.0)
        g = np.exp(-c * (z - h) ** 2 / w**2)
        dg_dh = g * 2.0 * c * (z - h) / w**2
        dg_dw = g * 2.0 * c * (z - h) ** 2 / w**3
        return g, dg_dh, dg_dw

    def _xs0(self):
        props = self.optical.scattering_properties(
            np.array([self.wavel0_nm])
        )
        xs0 = np.asarray(props["xs_total"])
        return float(xs0.ravel()[0])

    @property
    def number_density(self):
        g, _, _ = self._gaussian_terms()
        big_g = np.trapezoid(g, self._altitudes)
        return g * self.vertical_optical_depth.item() / (
            big_g * self._xs0()
        )

    @number_density.setter
    def number_density(self, value):
        # parent __init__ assigns a placeholder; the profile is derived
        pass

    def register_derivative(self, atmo, name: str):
        _, interp = self._profile(atmo)
        g, dg_dh, dg_dw = self._gaussian_terms()
        z = self._altitudes
        big_g = np.trapezoid(g, z)
        xs0 = self._xs0()
        tau = self.vertical_optical_depth.item()
        outer = tau / (big_g * xs0)

        # dn/dp on the constituent grid (quotient rule through G = int g)
        dn_dh = outer * (dg_dh - g * np.trapezoid(dg_dh, z) / big_g)
        dn_dw = outer * (dg_dw - g * np.trapezoid(dg_dw, z) / big_g)
        dn_dtau = g / (big_g * xs0)

        for suffix, dn in (
            ("height_m", dn_dh),
            ("width_fwhm_m", dn_dw),
            ("vertical_optical_depth", dn_dtau),
        ):
            m = atmo.storage.get_derivative_mapping(f"wf_{name}_{suffix}")
            self._fill_per_nd(m, atmo)
            m.interpolator = (interp @ dn)[None, :]  # [1, model_alt]
            m.interp_dim = f"{name}_{suffix}"


class ExtinctionScatterer(NumberDensityScatterer):
    """Scatterer specified by an extinction profile [m^-1] at a reference
    wavelength; the implied number density is ``extinction / xs(lambda_0)``
    and the weighting function is registered in extinction space
    (reference ``src/sasktran2/constituent/numdenscatterer.py:125``)."""

    def __init__(self, optical, altitudes_m, extinction_per_m,
                 extinction_wavelength_nm, param_values=None):
        self.extinction_per_m = np.asarray(extinction_per_m,
                                           dtype=np.float64)
        self.extinction_wavelength_nm = float(extinction_wavelength_nm)
        super().__init__(optical, altitudes_m,
                         np.zeros_like(self.extinction_per_m),
                         param_values=param_values)

    def _xs0(self):
        """Cross section at the reference wavelength on the constituent
        grid [A_src]."""
        if self.param_values:
            props = self.optical.scattering_properties(
                np.array([self.extinction_wavelength_nm]),
                altitudes_m=self._altitudes, **self.param_values,
            )
            xs = np.asarray(props["xs_total"])[:, 0]
        else:
            props = self.optical.scattering_properties(
                np.array([self.extinction_wavelength_nm])
            )
            xs = np.broadcast_to(
                np.asarray(props["xs_total"]).ravel()[:1],
                self._altitudes.shape,
            )
        return xs

    @property
    def number_density(self):
        xs0 = self._xs0()
        with np.errstate(divide="ignore", invalid="ignore"):
            nd = np.where(xs0 > 0, self.extinction_per_m / xs0, 0.0)
        return nd

    @number_density.setter
    def number_density(self, value):
        pass  # derived from the extinction profile

    def register_derivative(self, atmo, name: str):
        _, interp = self._profile(atmo)
        m = atmo.storage.get_derivative_mapping(f"wf_{name}")
        self._fill_per_nd(m, atmo)
        xs0 = self._xs0()
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(xs0 > 0, 1.0 / xs0, 0.0)
        # chain: dI/d ext_src = (1/xs0_src) sum_model interp dI/dn_model
        m.interpolator = interp.T * inv[:, None]
        m.interp_dim = f"{name}_altitude"


def _not_ported_2d(name):
    msg = (
        f"{name} needs the 2D geometry, which is not ported to the PyTorch "
        "engine yet (ROADMAP Queue 1 item 8, 2D geometry)"
    )
    return NotImplementedError(msg)


class NumberDensityScatterer2D:
    """Native-grid 2D scatterer: waits for the port's 2D geometry."""

    def __init__(self, *args, **kwargs):
        raise _not_ported_2d("NumberDensityScatterer2D")


class ExtinctionScatterer2D:
    """Native-grid 2D extinction scatterer: waits for the port's 2D
    geometry."""

    def __init__(self, *args, **kwargs):
        raise _not_ported_2d("ExtinctionScatterer2D")


class HGScatteringOptical:
    """Henyey-Greenstein test optical property for scatterers."""

    def __init__(self, xs_total, ssa, g, nleg=16):
        self.xs_total = np.atleast_1d(np.asarray(xs_total, dtype=np.float64))
        self.ssa_val = float(ssa)
        self.g = float(g)
        self.nleg = nleg

    def scattering_properties(self, wavelengths_nm):
        W = len(np.atleast_1d(wavelengths_nm))
        xs = np.broadcast_to(
            self.xs_total if self.xs_total.size == W else self.xs_total[0],
            (W,),
        ).copy()
        ls = np.arange(self.nleg)
        leg = np.broadcast_to(
            ((2 * ls + 1) * self.g**ls)[:, None], (self.nleg, W)
        ).copy()
        return {
            "xs_total": xs,
            "ssa": np.full(W, self.ssa_val),
            "legendre": leg,
        }


class MieScatteringOptical:
    """Mie-derived scattering properties for a lognormal particle size
    distribution, the Mie on ``device`` (None: the GPU)."""

    def __init__(self, refractive_index, median_radius_um, mode_width,
                 nleg=32, n_quad=40, device=None):
        from ..device import resolve_device

        self.m = refractive_index
        self.rg = float(median_radius_um)
        self.sigma_g = float(mode_width)
        self.nleg = nleg
        self.n_quad = n_quad
        self.device = resolve_device(device)

    def scattering_properties(self, wavelengths_nm):
        import torch

        from ..ops.quadrature import gauss_legendre
        from ..ops.wigner import legendre_p
        from ..optical.mie import (
            amplitudes_from_coefficients,
            efficiencies_from_coefficients,
            mie_coefficients,
        )

        wl_um = np.atleast_1d(wavelengths_nm) / 1000.0
        # lognormal quadrature in ln r
        x_q, w_q = gauss_legendre(self.n_quad)
        lnr = np.log(self.rg) + 3.5 * np.log(self.sigma_g) * x_q
        r = np.exp(lnr)
        pdf = np.exp(-0.5 * ((lnr - np.log(self.rg))
                             / np.log(self.sigma_g)) ** 2)
        wts = w_q * pdf
        wts /= wts.sum()

        # scattering angles for phase reconstruction
        mu_s, w_s = gauss_legendre(64)
        pl = legendre_p(mu_s, self.nleg)  # [L, T]
        mu_t = torch.as_tensor(mu_s, device=self.device)

        xs_t, ssa_out, leg_out = [], [], []
        for wl in wl_um:
            x = torch.as_tensor(2.0 * np.pi * r / wl, device=self.device)
            an, bn = mie_coefficients(x, self.m)
            qe, qs = efficiencies_from_coefficients(x, an, bn)
            s1, s2 = amplitudes_from_coefficients(x, an, bn, mu_t)
            s1, s2 = s1.cpu().numpy(), s2.cpu().numpy()
            area = np.pi * (r * 1e-6) ** 2
            cext = qe.cpu().numpy() * area
            csca = qs.cpu().numpy() * area
            k = 2.0 * np.pi / (wl * 1e-6)
            # ensemble phase function (normalized to 4 pi)
            p_num = np.einsum(
                "b,bt->t", wts, (np.abs(s1) ** 2 + np.abs(s2) ** 2) / 2.0,
            ) / k**2
            csca_bar = float(np.dot(wts, csca))
            cext_bar = float(np.dot(wts, cext))
            phase = 4.0 * np.pi * p_num / csca_bar
            # beta_l = (2l+1)/2 * int P_l(mu) p(mu) dmu  (beta_0 = 1)
            ls = np.arange(self.nleg)
            beta = (2 * ls + 1) / 2.0 * np.einsum(
                "lt,t,t->l", pl, phase, w_s
            )
            xs_t.append(cext_bar)
            ssa_out.append(csca_bar / cext_bar)
            leg_out.append(beta)
        return {
            "xs_total": np.array(xs_t),
            "ssa": np.array(ssa_out),
            "legendre": np.stack(leg_out, axis=-1),
        }
