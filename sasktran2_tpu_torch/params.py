"""Carry state into the port's tensors and tables, and across from the
JAX package.

The port has its own ``Atmosphere`` (a copy of the JAX package's numpy
class), so a calculation's inputs are the same dict of numpy arrays in
both packages. ``core_from_reference`` turns that dict into the port's
tensors. ``atmosphere_from_reference`` and ``mode_tables_from_reference``
copy a JAX-side object's numpy state into the port's class; they read
attributes only and import nothing of ``sasktran2_tpu``, so the parity
tests can feed both packages the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .atmosphere import Atmosphere
from .rt.brdf import KERNELS as BRDF_KERNELS
from .rt.disco import ModeTables


def core_from_reference(core_np: dict, device, dtype) -> dict:
    """``Atmosphere.internal_object()`` (wavelength-leading numpy arrays:
    extinction/ssa/emission [W, A], leg_coeff [W, A, L], albedo [W], ...)
    -> the same keys as tensors of ``dtype`` on ``device``."""
    return {
        k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
        for k, v in core_np.items()
    }


def mode_tables_from_reference(tables) -> ModeTables:
    """A JAX-side ``sasktran2_tpu.rt.disco.ModeTables`` (numpy fields) ->
    the port's ``ModeTables``."""
    return ModeTables(
        lam_stream=np.asarray(tables.lam_stream),
        lam_sun=np.asarray(tables.lam_sun),
        lam_user=np.asarray(tables.lam_user),
        parity=np.asarray(tables.parity),
        mu=np.asarray(tables.mu),
        w=np.asarray(tables.w),
        mu0=float(tables.mu0),
        user_mu=np.asarray(tables.user_mu),
    )


def atmosphere_from_reference(ref_atmo, geometry, config) -> Atmosphere:
    """A JAX-side ``Atmosphere`` -> the port's ``Atmosphere`` on
    (``geometry``, ``config``), the port's own objects (a ``Geometry2D``
    for a 2D atmosphere, whose storage has a row per location), with
    copies of the
    same storage, surface (a BRDF as the port's kernel of the same class,
    with its arguments), wavelengths and derivative mappings. Constituents
    are not carried: the result is a raw-input atmosphere holding the state
    that ``ref_atmo`` holds now."""
    wl = ref_atmo.wavelengths_nm
    atmo = Atmosphere(
        geometry, config,
        wavelengths_nm=None if wl is None else np.array(wl),
        numwavel=ref_atmo.num_wavelengths if wl is None else None,
        calculate_derivatives=ref_atmo.calculate_derivatives,
        calculate_emission_derivatives=ref_atmo.calculate_emission_derivatives,
    )
    src, dst = ref_atmo.storage, atmo.storage
    for name in ("total_extinction", "ssa", "emission_source", "leg_coeff",
                 "solar_irradiance", "f"):
        getattr(dst, name)[...] = getattr(src, name)
    for name in ("albedo", "emission"):
        getattr(atmo.surface, name)[...] = getattr(ref_atmo.surface, name)
    if ref_atmo.surface.brdf is not None:
        atmo.surface.brdf = brdf_from_reference(ref_atmo.surface.brdf)
        atmo.surface.brdf_args = np.array(ref_atmo.surface.brdf_args)
    for name, m in src.derivative_mappings.items():
        mine = dst.get_derivative_mapping(name)
        for field in ("d_extinction", "d_ssa", "d_emission", "d_leg_coeff",
                      "scat_factor", "interpolator"):
            value = getattr(m, field)
            setattr(mine, field, None if value is None else np.array(value))
        for field in ("interp_dim", "assign_name", "log_radiance_space"):
            setattr(mine, field, getattr(m, field))
    for name, m in ref_atmo.surface.derivative_mappings.items():
        mine = atmo.surface.get_derivative_mapping(name)
        mine.d_brdf = np.array(m.d_brdf)
        mine.interpolator = (
            None if m.interpolator is None else np.array(m.interpolator)
        )
        mine.interp_dim = m.interp_dim
    return atmo


def brdf_from_reference(kernel):
    """A JAX-side BRDF kernel (``sasktran2_tpu.rt.brdf``) -> the port's
    kernel of the same class name in ``rt.brdf``, the members of a
    ``WeightedKernel`` mapped in turn. Raises ``NotImplementedError`` for a
    class the port does not have."""
    name = type(kernel).__name__
    cls = BRDF_KERNELS.get(name)
    if cls is None:
        msg = f"the port has no BRDF kernel {name}"
        raise NotImplementedError(msg)
    if name == "WeightedKernel":
        return cls([brdf_from_reference(k) for k in kernel.kernels])
    return cls()
