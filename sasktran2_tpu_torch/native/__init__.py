"""The native (C++) host ray tracer of the port.

Copy of ``sasktran2_tpu/native/__init__.py``: ``csrc/raytracer.cpp`` is
built with g++ at first use into ``sasktran2_tpu_torch/_build/`` (listed
in ``.gitignore``) and loaded through ctypes. If it cannot be built,
``get_native_lib`` returns None and ``rt/raytrace.py`` traces with its
numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_and_load():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(pkg, "csrc", "raytracer.cpp")
    build_dir = os.path.join(pkg, "_build")
    lib_path = os.path.join(build_dir, "libsk_raytracer.so")
    if (
        not os.path.exists(lib_path)
        or os.path.getmtime(lib_path) < os.path.getmtime(src)
    ):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{lib_path}.tmp{os.getpid()}"
        cmd = [
            "g++", "-O2", "-march=native", "-shared", "-fPIC",
            "-o", tmp, src,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    d = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_ubyte)
    lib.sk_trace_rays.restype = None
    lib.sk_trace_rays.argtypes = [
        d, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int), d, ctypes.c_int,
        d, d, d, d, d, d, d, d, i64, d, d, d, u8, d, d, d,
    ]
    return lib


def get_native_lib():
    """The compiled native library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            _LIB = _build_and_load()
        except Exception:
            _LIB = None
        return _LIB


def native_trace(radii, earth_radius, kinds, params):
    """Run the native tracer. Returns the raw table dict, or None."""
    lib = get_native_lib()
    if lib is None:
        return None
    radii = np.ascontiguousarray(radii, dtype=np.float64)
    A = len(radii)
    R = len(kinds)
    S = 2 * (A - 1)
    kinds_a = np.ascontiguousarray(kinds, dtype=np.int32)
    params_a = np.ascontiguousarray(params, dtype=np.float64)

    out = {
        "od_weights": np.zeros((R, S, A)),
        "sun_weights": np.zeros((R, S + 1, A)),
        "interp_weights": np.zeros((R, S + 1, A)),
        "lengths": np.zeros((R, S)),
        "mask": np.zeros((R, S)),
        "cos_scatter": np.zeros((R, S + 1)),
        "cos_zenith": np.zeros((R, S + 1)),
        "cos_sza": np.zeros((R, S + 1)),
        "seg_layer": np.zeros((R, S), dtype=np.int64),
        "seg_entrance_frac": np.zeros((R, S)),
        "seg_exit_frac": np.zeros((R, S)),
        "boundary_relazi": np.zeros((R, S + 1)),
        "ground_hit": np.zeros(R, dtype=np.uint8),
        "ground_cos_sza": np.zeros(R),
        "ground_cos_vza": np.zeros(R),
        "ground_relazi": np.zeros(R),
    }

    def dp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    lib.sk_trace_rays(
        dp(radii), A, ctypes.c_double(earth_radius),
        kinds_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        dp(params_a), R,
        dp(out["od_weights"]), dp(out["sun_weights"]),
        dp(out["interp_weights"]), dp(out["lengths"]), dp(out["mask"]),
        dp(out["cos_scatter"]), dp(out["cos_zenith"]), dp(out["cos_sza"]),
        out["seg_layer"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dp(out["seg_entrance_frac"]), dp(out["seg_exit_frac"]),
        dp(out["boundary_relazi"]),
        out["ground_hit"].ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        dp(out["ground_cos_sza"]), dp(out["ground_cos_vza"]),
        dp(out["ground_relazi"]),
    )
    return out
