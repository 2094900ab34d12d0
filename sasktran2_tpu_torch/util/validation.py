"""Input validation (reference ``cpp/include/sasktran2/validation/
validation.h:12-48`` + engine-level checks ``engine.cpp:431-490``).

Modes: Strict (raise on anything suspicious, including ssa == 1 warnings
upgraded to errors), Standard (raise on definite errors), Disabled.

(Copy of ``sasktran2_tpu/util/validation.py`` for the PyTorch port;
``validate_atmosphere_core`` reads the storage's own layout.)
"""

from __future__ import annotations

import logging

import numpy as np

from ..config import InputValidationMode


class ValidationError(ValueError):
    pass


def verify_finite(name, arr, mode):
    if mode == InputValidationMode.Disabled:
        return
    if not np.all(np.isfinite(arr)):
        msg = f"{name} contains non-finite values"
        raise ValidationError(msg)


def verify_range(name, arr, lo, hi, mode):
    if mode == InputValidationMode.Disabled:
        return
    if np.any(np.asarray(arr) < lo) or np.any(np.asarray(arr) > hi):
        msg = f"{name} outside [{lo}, {hi}]"
        raise ValidationError(msg)


def validate_atmosphere_core(core: dict, nalt: int, mode):
    """Engine-level validation of the core arrays in the storage's own
    layout: extinction and ssa [A, W], leg_coeff the a1 greek [L, A, W]
    (``Atmosphere.internal_object(native=True)``)."""
    if mode == InputValidationMode.Disabled:
        return
    k = np.asarray(core["extinction"])
    ssa = np.asarray(core["ssa"])
    if k.shape[0] != nalt:
        msg = (
            f"extinction has {k.shape[0]} altitude entries; the geometry "
            f"has {nalt} grid points"
        )
        raise ValidationError(msg)
    verify_finite("extinction", k, mode)
    verify_finite("ssa", ssa, mode)
    if np.any(k < 0):
        msg = "extinction contains negative values"
        raise ValidationError(msg)
    verify_range("ssa", ssa, 0.0, 1.0, mode)
    if "albedo" in core:
        verify_range("albedo", core["albedo"], 0.0, 1.0, mode)
    leg = np.asarray(core["leg_coeff"])
    verify_finite("leg_coeff", leg, mode)
    if mode == InputValidationMode.Strict:
        b0 = leg[0]
        scattering = ssa * k > 0
        if np.any(scattering & ~np.isclose(b0, 1.0)):
            msg = (
                "leg_coeff[0] must be 1 wherever there is scattering "
                "(strict validation)"
            )
            raise ValidationError(msg)
