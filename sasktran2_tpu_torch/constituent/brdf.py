"""Surface BRDF constituents (reference ``src/sasktran2/constituent/brdf/``).

(Numpy copy of ``sasktran2_tpu/constituent/brdf.py`` for the PyTorch port;
a test pins it to the original. The kernels it sets are the port's torch
kernels of ``rt/brdf.py``.)
"""

from __future__ import annotations

import numpy as np

from .base import Constituent


class LambertianSurface(Constituent):
    """Wavelength-dependent Lambertian albedo. ``albedo`` may be a scalar or
    an array on ``wavelengths_nm`` (interpolated to the engine grid)."""

    def __init__(self, albedo, wavelengths_nm=None, wavelengths_interpolator=None):
        self.albedo = np.atleast_1d(np.asarray(albedo, dtype=np.float64))
        self.wavelengths_nm = (
            np.asarray(wavelengths_nm, dtype=np.float64)
            if wavelengths_nm is not None
            else None
        )

    def _albedo_on_grid(self, atmo):
        if self.albedo.size == 1:
            return np.full(atmo.num_wavelengths, self.albedo[0]), None
        if self.wavelengths_nm is None:
            if self.albedo.size != atmo.num_wavelengths:
                msg = "albedo array length must match the wavelength grid"
                raise ValueError(msg)
            return self.albedo.copy(), None
        from ..util.interpolation import linear_interpolating_matrix

        interp = linear_interpolating_matrix(
            self.wavelengths_nm, atmo.wavelengths_nm, "extend"
        )
        return interp @ self.albedo, interp

    def add_to_atmosphere(self, atmo):
        alb, _ = self._albedo_on_grid(atmo)
        atmo.surface.albedo += alb

    def register_derivative(self, atmo, name: str):
        m = atmo.surface.get_derivative_mapping(f"wf_{name}_albedo")
        m.d_brdf[:] = 1.0
        m.interp_dim = "dummy"


class SnowKokhanovsky(Constituent):
    """Kokhanovsky snow BRDF surface (reference
    ``constituent/brdf/kokhanovsky.py``): args(0) = (chi + M)/wavelen * L."""

    def __init__(self, chi=1e-6, M=0.0, L=1e6):
        self.chi = chi
        self.M = M
        self.L = L

    def add_to_atmosphere(self, atmo):
        from ..rt.brdf import SnowKokhanovskyKernel

        wl_nm = atmo.wavelengths_nm
        args = (self.chi + self.M) / wl_nm * self.L
        atmo.surface.brdf = SnowKokhanovskyKernel()
        atmo.surface.brdf_args = args[:, None]

    def register_derivative(self, atmo, name: str):
        m = atmo.surface.get_derivative_mapping(f"wf_{name}_L")
        m.d_brdf = np.zeros((atmo.num_wavelengths, 1))
        m.d_brdf[:, 0] = (self.chi + self.M) / atmo.wavelengths_nm


class WeightedBRDF(Constituent):
    """Linear combination of BRDF constituents (reference ``WeightedBRDF``,
    ``surface.h:99``): ``WeightedBRDF({"snow": (SnowKokhanovsky(), 0.7),
    "soil": (MODIS(...), 0.3)})``. Weights may be scalars or per-wavelength
    arrays; weighting functions are produced for each member's parameters
    (scaled by its weight) and for each weight itself."""

    def __init__(self, members: dict):
        self.members = {
            name: (c, np.atleast_1d(np.asarray(w, dtype=np.float64)))
            for name, (c, w) in members.items()
        }

    def _weights_on_grid(self, atmo):
        W = atmo.num_wavelengths
        return {
            name: np.broadcast_to(w, (W,)).copy()
            for name, (_, w) in self.members.items()
        }

    def add_to_atmosphere(self, atmo):
        from ..rt.brdf import LambertianKernel, WeightedKernel

        kernels = []
        args_list = []
        self._member_arg_offsets = {}
        off = 0
        W = atmo.num_wavelengths
        for name, (c, _) in self.members.items():
            # materialize each member's kernel+args via a scratch surface
            scratch = _ScratchSurface(W)
            c.add_to_atmosphere(_ScratchAtmo(atmo, scratch))
            if scratch.brdf is None:
                # Lambertian member: albedo as a 1-arg kernel
                kernels.append(LambertianKernel())
                args_list.append(scratch.albedo[:, None])
            else:
                kernels.append(scratch.brdf)
                args_list.append(scratch.brdf_args)
            self._member_arg_offsets[name] = (off, args_list[-1].shape[1])
            off += args_list[-1].shape[1]
        weights = self._weights_on_grid(atmo)
        warr = np.stack([weights[n] for n in self.members], axis=-1)
        atmo.surface.brdf = WeightedKernel(kernels)
        atmo.surface.brdf_args = np.concatenate(args_list + [warr], axis=-1)
        self._n_member_args = off

    def register_derivative(self, atmo, name: str):
        ntot = self._n_member_args + len(self.members)
        weights = self._weights_on_grid(atmo)
        for i, mname in enumerate(self.members):
            # d/d weight_i
            m = atmo.surface.get_derivative_mapping(
                f"wf_{name}_{mname}_weight"
            )
            m.d_brdf = np.zeros((atmo.num_wavelengths, ntot))
            m.d_brdf[:, self._n_member_args + i] = 1.0
            # member parameter WFs: chain through the member's own
            # register_derivative on a scratch surface, remapped into the
            # concatenated arg layout
            c, _ = self.members[mname]
            scratch = _ScratchSurface(atmo.num_wavelengths)
            c.add_to_atmosphere(_ScratchAtmo(atmo, scratch))
            c.register_derivative(_ScratchAtmo(atmo, scratch), mname)
            off, width = self._member_arg_offsets[mname]
            for dname, dm in scratch._derivative_mappings.items():
                out_m = atmo.surface.get_derivative_mapping(
                    f"wf_{name}_{dname.removeprefix('wf_')}"
                )
                out_m.d_brdf = np.zeros((atmo.num_wavelengths, ntot))
                d = dm.d_brdf
                if d.shape[1] == width:
                    out_m.d_brdf[:, off:off + width] = d
                else:  # Lambertian member: single albedo arg
                    out_m.d_brdf[:, off] = d[:, 0]
                out_m.interp_dim = dm.interp_dim


class _ScratchSurface:
    """Minimal Surface stand-in for materializing a member BRDF."""

    def __init__(self, nwavel):
        self.albedo = np.zeros(nwavel)
        self.emission = np.zeros(nwavel)
        self.brdf = None
        self.brdf_args = None
        self._derivative_mappings = {}

    def get_derivative_mapping(self, name):
        from ..atmosphere import SurfaceDerivativeMapping

        if name not in self._derivative_mappings:
            nargs = 1 if self.brdf is None else self.brdf_args.shape[1]
            self._derivative_mappings[name] = SurfaceDerivativeMapping(
                len(self.albedo), nargs
            )
        return self._derivative_mappings[name]


class _ScratchAtmo:
    """Proxy exposing the real atmosphere's grids with a scratch surface."""

    def __init__(self, atmo, surface):
        self._atmo = atmo
        self.surface = surface

    def __getattr__(self, item):
        return getattr(self._atmo, item)


class MODIS(Constituent):
    """MODIS RossThick-LiSparse kernel surface (reference
    ``constituent/brdf/modis.py``)."""

    def __init__(self, isotropic, volumetric, geometric):
        self.f_iso = np.atleast_1d(np.asarray(isotropic, dtype=np.float64))
        self.f_vol = np.atleast_1d(np.asarray(volumetric, dtype=np.float64))
        self.f_geo = np.atleast_1d(np.asarray(geometric, dtype=np.float64))

    def add_to_atmosphere(self, atmo):
        from ..rt.brdf import MODISKernel

        W = atmo.num_wavelengths
        args = np.stack([
            np.broadcast_to(self.f_iso, (W,)),
            np.broadcast_to(self.f_vol, (W,)),
            np.broadcast_to(self.f_geo, (W,)),
        ], axis=-1)
        atmo.surface.brdf = MODISKernel()
        atmo.surface.brdf_args = args

    def register_derivative(self, atmo, name: str):
        for i, pname in enumerate(("isotropic", "volumetric", "geometric")):
            m = atmo.surface.get_derivative_mapping(f"wf_{name}_{pname}")
            m.d_brdf = np.zeros((atmo.num_wavelengths, 3))
            m.d_brdf[:, i] = 1.0
