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
one streaming pass, coalesced in the channels-first layout the port's
``wn`` holds, and folds the broadcast ``g`` add into its loads rather than
paying a separate ``x + g`` pass.  At Piper widths one call moves about a megabyte, so launch
latency dominates; fusing the gate into the WaveNet layer is the way to a
faster one.
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
    g_ptr = None
    if g is not None:
        if (g.dtype != torch.float32 or g.device != x.device
                or tuple(g.shape) != (b, 1, two_h)):
            raise OperationError(
                f"fused_gate: expected float32 g [{b}, 1, {two_h}] on "
                f"{x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
        g = g.reshape(b, two_h).contiguous()
        g_ptr = g.data_ptr()
    from ._build import check, library, stream_of

    rc = library().sonata_gate_f32(x.data_ptr(), g_ptr, out.data_ptr(), b, t,
                                   hidden, x.device.index, stream_of(x))
    check(rc, "fused_gate")
    fused_gate.launches += 1
    return out


#: kernel launches since the last reset (the CPU path never counts)
fused_gate.launches = 0
