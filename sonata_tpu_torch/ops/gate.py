"""Fused WaveNet gate: ``tanh(a) * sigmoid(b)`` over the two halves of a
WaveNet pre-activation, with the conditioning add folded in.

Port of ``sonata_tpu/ops/gate.py``.  On a CUDA tensor :func:`fused_gate`
launches the hand-written kernel ``csrc/gate.cu``, which replaces the TPU
kernel ``fused_gate_pallas`` (``_gate_kernel``); on a CPU tensor it takes
the plain version :func:`fused_gate_reference`.  There is no fallback from
the card to the plain version: a CUDA tensor the kernel cannot take raises.

What bounds it on the card: memory.  A row of the ``[rows, 2H]``
pre-activation costs 12·H bytes (read 2H floats, write H); the
transcendentals are a few operations per byte.  The kernel therefore makes
one streaming pass in 16-byte vectors, one vector of one channel row a
thread, in the channels-first layout the port's ``wn`` holds, and folds the
broadcast ``g`` add into its loads, reading ``g`` in place through its row
stride (``wn`` passes one layer's slice of the stacked conditioning).  Its
design is described in the source.  Fusing the gate into the WaveNet layer
is later performance work (``ROADMAP.md`` §3).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import OperationError


def fused_gate_reference(y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``y: [B, T, 2H]`` → ``[B, T, H]``."""
    hidden = y.shape[-1] // 2
    return torch.tanh(y[..., :hidden]) * torch.sigmoid(y[..., hidden:])


def fused_gate(x: torch.Tensor,
               g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated activation with optional conditioning.

    ``x: [B, T, 2H]``, ``g: [B, 1, 2H]`` or None → ``[B, T, H]``.  On the
    GPU, ``x`` must be the ``[B, T, 2H]`` view of a contiguous
    ``[B, 2H, T]`` tensor (the channels-first layout the port's ``wn``
    keeps); the result is the same kind of view of a ``[B, H, T]`` tensor.
    """
    if x.device.type == "cpu":
        return fused_gate_reference(x if g is None else x + g)
    if x.device.type != "cuda":
        raise OperationError(f"fused_gate: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[-1] % 2:
        raise OperationError(
            f"fused_gate: expected float32 [B, T, 2H], got {x.dtype} "
            f"{tuple(x.shape)}")
    b, t, two_h = x.shape
    hidden = two_h // 2
    if not x.transpose(1, 2).is_contiguous():
        raise OperationError(
            "fused_gate: x must be the [B, T, 2H] view of a contiguous "
            "[B, 2H, T] tensor")
    out = torch.empty((b, hidden, t), dtype=x.dtype,
                      device=x.device).transpose(1, 2)
    g_ptr, g_stride = None, 0
    if g is not None:
        if (g.dtype != torch.float32 or g.device != x.device
                or tuple(g.shape) != (b, 1, two_h)
                or (two_h > 1 and g.stride(2) != 1)):
            raise OperationError(
                f"fused_gate: expected float32 g [{b}, 1, {two_h}] with unit "
                f"channel stride on {x.device}, got {g.dtype} "
                f"{tuple(g.shape)} strides {g.stride()} on {g.device}")
        # read in place: g[b, 0, c] is at g_ptr + b * g_stride + c
        g_ptr, g_stride = g.data_ptr(), g.stride(0)
    from ._build import check, library, stream_of

    rc = library().sonata_gate_f32(x.data_ptr(), g_ptr, g_stride,
                                   out.data_ptr(), b, t, hidden,
                                   x.device.index, stream_of(x))
    check(rc, "fused_gate")
    fused_gate.launches += 1
    return out


#: kernel launches since the last reset (the CPU path never counts)
fused_gate.launches = 0
