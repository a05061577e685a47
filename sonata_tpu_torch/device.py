"""Where the port runs: device resolution and float32 precision on the card.

Every entry point that takes a ``device`` (voices, diacritizer models)
resolves it here, so every one that lands on a CUDA device pins full
float32 before it computes anything.
"""

from __future__ import annotations

import torch

from .core import OperationError


def full_float32() -> None:
    """float32 on the card means float32.  cuDNN's default runs float32
    convolutions and recurrent layers in TF32 (about three decimal digits),
    which would break parity with the reference; matmuls default to full
    float32 already.  Both switches are pinned."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises when CUDA is absent.

    There is no silent CPU fallback: running on the CPU is asked for with
    ``device="cpu"``.  A CUDA result pins full float32
    (:func:`full_float32`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise OperationError(
                "no CUDA device is available; pass device='cpu' to run "
                "the PyTorch port on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise OperationError(f"device {device!r} requested but CUDA "
                                     "is not available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise OperationError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        full_float32()
    return dev
