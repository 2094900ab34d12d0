"""Device and dtype policy of the PyTorch port.

An entry point runs on the GPU unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and raises where no GPU is
available, so that a run meant for the card never carries on quietly on
the CPU. On the CPU the port computes in float64, so that it can be held against the JAX package's
float64 CPU path at its own tolerances. On CUDA it computes in the
``Config.dtype`` that the caller asked for.

TF32 is switched off at import for matmuls and for cuDNN: ``torch.einsum``
goes through matmul, and TF32 keeps only about three decimal digits. This
is the counterpart of the JAX engine's ``default_matmul_precision("highest")``
(``sasktran2_tpu/engine.py:1618-1619``, ``:1706-1708``).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``device`` as given, or
    ``cuda`` when it is None. Raises ``RuntimeError`` for None where CUDA
    is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        msg = (
            "no CUDA device is available: the port runs on the GPU unless "
            'the caller passes device="cpu"'
        )
        raise RuntimeError(msg)
    return torch.device("cuda")


def resolve_dtype(config_dtype: str, device) -> torch.dtype:
    """Working dtype for a run on ``device``: float64 on the CPU, and the
    configured ``"float32"`` / ``"float64"`` on CUDA."""
    device = torch.device(device)
    if device.type == "cpu" or config_dtype == "float64":
        return torch.float64
    if config_dtype == "float32":
        return torch.float32
    msg = f"unsupported dtype {config_dtype!r}"
    raise ValueError(msg)
