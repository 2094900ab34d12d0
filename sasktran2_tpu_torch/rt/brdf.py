"""Surface BRDF kernels (counterpart of ``sasktran2_tpu/rt/brdf.py``).

Lambertian, Kokhanovsky snow, the MODIS RossThick/LiSparse-R kernel model
and their weighted sum. Each kernel is a torch function of (mu_out, mu_in,
geometric relative azimuth, args) returning the BRDF in 1/sr; the angles
are constant tensors and ``args`` [W, nargs] carries the wavelength batch,
so the discrete-ordinates solver's azimuth moments
(``rt.disco.brdf_azimuth_moments``) are differentiable in ``args`` and the
surface weighting functions come from autograd like every other input.
"""

from __future__ import annotations

import math

import torch


def _lead(x):
    """[W] -> [W, 1, 1, 1]: one wavelength's argument against the
    [O, I, Q] angle grid."""
    return x[..., None, None, None]


class LambertianKernel:
    """rho = albedo / pi. args: [..., 1] (albedo)."""

    num_args = 1

    def kernel(self, mu_out, mu_in, phi, args):
        shape = torch.broadcast_shapes(mu_out.shape, mu_in.shape, phi.shape)
        ones = torch.ones(shape, dtype=args.dtype, device=args.device)
        return (_lead(args[..., 0]) / math.pi) * ones


class SnowKokhanovskyKernel:
    """Kokhanovsky-Breon snow BRDF. args: [..., 1] = (chi + M) / wavelen_nm
    * L, the single absorption parameter; R = R0 exp(-alpha K0(mu_s)
    K0(mu_v) / R0) / pi with alpha = sqrt(4 pi args0)."""

    num_args = 1

    @staticmethod
    def _k0(mu):
        return (3.0 / 7.0) * (1.0 + 2.0 * mu)

    def kernel(self, mu_out, mu_in, phi, args):
        mus = mu_in
        muv = mu_out
        ss = torch.sqrt(torch.clamp(1.0 - mus * mus, 0.0, 1.0))
        sv = torch.sqrt(torch.clamp(1.0 - muv * muv, 0.0, 1.0))
        cost = torch.clamp(-mus * muv + ss * sv * torch.cos(phi), -1.0, 1.0)
        theta_deg = torch.rad2deg(torch.arccos(cost))
        p = 11.1 * torch.exp(-0.087 * theta_deg) + 1.1 * torch.exp(
            -0.014 * theta_deg
        )
        a, b, c = 1.247, 1.186, 5.157
        r0 = (a + b * (mus + muv) + c * mus * muv + p) / (4.0 * (mus + muv))
        alpha = _lead(torch.sqrt(4.0 * math.pi * args[..., 0]))
        return r0 * torch.exp(-alpha * self._k0(mus) * self._k0(muv) / r0) / (
            math.pi
        )


class WeightedKernel:
    """Linear combination of BRDF kernels. args: [..., sum(num_args_i) + K]
    = the member kernels' args concatenated in order, then the K mixing
    weights."""

    def __init__(self, kernels):
        self.kernels = list(kernels)
        self.num_args = sum(k.num_args for k in self.kernels) + len(
            self.kernels
        )

    def kernel(self, mu_out, mu_in, phi, args):
        n_member = sum(k.num_args for k in self.kernels)
        out = 0.0
        off = 0
        for i, k in enumerate(self.kernels):
            sub = args[..., off:off + k.num_args]
            out = out + _lead(args[..., n_member + i]) * k.kernel(
                mu_out, mu_in, phi, sub
            )
            off += k.num_args
        return out


class MODISKernel:
    """MODIS RossThick + LiSparse-Reciprocal kernel BRDF. args: [..., 3] =
    (f_iso, f_vol, f_geo)."""

    num_args = 3

    def kernel(self, mu_out, mu_in, phi, args):
        csza = mu_in
        cvza = mu_out
        ssza = torch.sqrt(torch.clamp(1.0 - csza * csza, 0.0, 1.0))
        svza = torch.sqrt(torch.clamp(1.0 - cvza * cvza, 0.0, 1.0))
        tsza = ssza / csza
        tvza = svza / cvza
        # the reference negates cos(phi_diff): raa = 0 is the forward plane
        craa = -torch.cos(phi)
        sraa = torch.sin(phi)
        csa = torch.clamp(csza * cvza + ssza * svza * craa, -1.0, 1.0)
        sa = torch.arccos(csa)
        ssa = torch.sin(sa)

        k_vol = ((0.5 * math.pi - sa) * csa + ssa) / (csza + cvza) - (
            0.25 * math.pi
        )

        d2 = tsza * tsza + tvza * tvza - 2.0 * tsza * tvza * craa
        ct = torch.clamp(
            2.0
            * torch.sqrt(d2 + tsza * tsza * tvza * tvza * sraa * sraa)
            * csza
            * cvza
            / (csza + cvza),
            -1.0,
            1.0,
        )
        t = torch.arccos(ct)
        st = torch.sin(t)
        o = (t - st * ct) * (csza + cvza) / (math.pi * csza * cvza)
        k_geo = o - (csza + cvza - 0.5 * (1.0 + csa)) / (csza * cvza)

        f_iso = _lead(args[..., 0])
        f_vol = _lead(args[..., 1])
        f_geo = _lead(args[..., 2])
        return (f_iso + f_vol * k_vol + f_geo * k_geo) / math.pi


# every kernel class of the port, by the JAX package's class names
KERNELS = {
    cls.__name__: cls
    for cls in (LambertianKernel, SnowKokhanovskyKernel, WeightedKernel,
                MODISKernel)
}
