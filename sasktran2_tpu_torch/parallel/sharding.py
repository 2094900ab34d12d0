"""The wavelength split of the radiative transfer across devices
(counterpart of ``sasktran2_tpu/parallel/sharding.py``).

The reference threads wavelengths over OpenMP/Rayon
(``cpp/lib/engine/engine.cpp:560-572``). Here the wavelength batch is cut
into one contiguous block per device of a ``Mesh`` and each block runs
the whole forward model and its Jacobian rows on its own device, driven
by one host thread per block. Wavelengths are independent, so the blocks
exchange nothing; the results come back in wavelength order.

The mesh's second axis ("los") is accepted and ignored, as in the JAX
package: the solve is replicated over it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

AXIS_NAMES = ("wavelength", "los")
# the core keys that ``shard_core`` splits; the rest are replicated
# (``sasktran2_tpu/parallel/sharding.py:39-46``)
WAVELENGTH_KEYS = ("extinction", "ssa", "leg_coeff", "albedo", "emission",
                   "solar_irradiance")


@dataclass(frozen=True)
class Mesh:
    """A [n_wavelength, n_los] array of ``torch.device`` with the axis
    names ("wavelength", "los"). A device may appear more than once: each
    entry of the wavelength axis takes a block of its own."""

    devices: np.ndarray
    axis_names = AXIS_NAMES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def wavelength_devices(self) -> list:
        """The device of each wavelength block, in wavelength order."""
        return list(self.devices[:, 0])


def make_mesh(n_wavelength: int | None = None, n_los: int = 1, devices=None):
    """A (wavelength, los) mesh over ``devices`` (default: every visible
    CUDA device), all of them on the wavelength axis unless ``n_wavelength``
    says otherwise."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            msg = "make_mesh: no CUDA device is visible; pass devices="
            raise RuntimeError(msg)
    devices = [torch.device(d) for d in devices]
    if n_wavelength is None:
        n_wavelength = len(devices) // n_los
    if n_wavelength < 1 or n_wavelength * n_los > len(devices):
        msg = (f"make_mesh: {n_wavelength} x {n_los} does not fit "
               f"{len(devices)} devices")
        raise ValueError(msg)
    arr = np.empty(n_wavelength * n_los, dtype=object)
    arr[:] = devices[: n_wavelength * n_los]
    return Mesh(arr.reshape(n_wavelength, n_los))


def wavelength_blocks(W: int, mesh: Mesh) -> list:
    """(device, start, stop) of each non-empty block of ``W`` wavelengths:
    as equal as they can be, the larger ones first (W = 11 over 8 devices:
    2, 2, 2, 1, 1, 1, 1, 1). With fewer wavelengths than devices the last
    devices take none."""
    devices = mesh.wavelength_devices
    n = len(devices)
    sizes = [W // n + (i < W % n) for i in range(n)]
    stops = np.cumsum(sizes)
    return [(dev, int(stop - size), int(stop))
            for dev, size, stop in zip(devices, sizes, stops) if size]


def _to(v, dev, start, stop):
    if isinstance(v, torch.Tensor):
        return v[start:stop].to(dev)
    return torch.as_tensor(np.asarray(v)[start:stop], device=dev)


def _whole(v, dev):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.as_tensor(np.asarray(v), device=dev)


def shard_core_wavelength(core: dict, mesh: Mesh):
    """Split every core array (wavelength-leading by the engine's
    convention; tensors or numpy arrays) into the mesh's wavelength
    blocks, each on its device. Returns (blocks, W): one dict per
    non-empty block, in wavelength order, and the batch's size. No
    padding is needed: a block is as wide as its wavelengths."""
    W = next(iter(core.values())).shape[0]
    return [{k: _to(v, dev, a, b) for k, v in core.items()}
            for dev, a, b in wavelength_blocks(W, mesh)], W


def shard_core(core: dict, mesh: Mesh):
    """As ``shard_core_wavelength``, but only the keys of
    ``WAVELENGTH_KEYS`` are split; every other array is copied whole to
    each block's device."""
    W = core["extinction"].shape[0]
    return [{k: (_to(v, dev, a, b) if k in WAVELENGTH_KEYS
                 else _whole(v, dev)) for k, v in core.items()}
            for dev, a, b in wavelength_blocks(W, mesh)]


def _gather(parts, dev):
    """Concatenate the blocks' results (a tensor, or a list of them)
    along the wavelength axis on ``dev``."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    return [_gather(list(ps), dev) for ps in zip(*parts)]


def run_blocks(fn, blocks: list) -> list:
    """``fn(block)`` for each block, each on its own host thread with its
    device current (CUDA); the results in the blocks' order. An exception
    in any block is raised here."""

    def one(block):
        dev = next(iter(block.values())).device
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return fn(block)
        return fn(block)

    if len(blocks) == 1:
        return [one(blocks[0])]
    with ThreadPoolExecutor(len(blocks)) as pool:
        return list(pool.map(one, blocks))


def sharded_radiance_fn(fn, mesh: Mesh):
    """``fn(core) -> result`` (a tensor or a list of them, wavelength
    leading) as a function of the whole core that runs ``fn`` on each of
    the mesh's wavelength blocks on its device, one host thread per block,
    and concatenates the results in wavelength order on the first block's
    device."""

    def run(core):
        blocks, _ = shard_core_wavelength(core, mesh)
        parts = run_blocks(fn, blocks)
        return _gather(parts, next(iter(blocks[0].values())).device)

    return run
