"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At its first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``sasktran2_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. Nothing is built at import, so the package imports on a
machine with no CUDA toolkit. The library's file name carries a hash of
the source and the flags, so an edited source is never served by a stale
build.

``nvcc`` is run with ``-Xptxas -v``; its register, shared-memory and
spill report is kept beside the library as ``lib<name>_<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .. import spans

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# held while a wrapper adds to its launch counts: ``Engine.calculate_radiance(
# mesh=)`` launches from one host thread per block of wavelengths
COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    msg = "nvcc not found: the CUDA kernels need the CUDA toolkit to build"
    raise RuntimeError(msg)


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source is
    present; return the library's path."""
    out = library_path(name)
    if not os.path.exists(out):
        compile_library(os.path.join(CSRC_DIR, f"{name}.cu"), out)
    return out


def compile_library(src: str, out: str) -> str:
    """``nvcc`` ``src`` into the shared library ``out``, with its ptxas
    report beside it as ``<out without .so>.log``."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        msg = f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}"
        raise RuntimeError(msg)
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each exported function to its ctypes argtypes;
    every function returns the ``cudaError_t`` of its launch as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with spans.span("kernel_load", kernel=name) as span:
                if span:
                    span.count(nvcc=int(not os.path.exists(library_path(name))))
                lib = ctypes.CDLL(build(name))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(err: int, what: str):
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        msg = f"{what} kernel launch failed with cudaError_t {err}"
        raise RuntimeError(msg)
