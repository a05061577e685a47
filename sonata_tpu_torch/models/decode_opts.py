"""Decoder-arm options: the streaming decode epilogue (crossfade taper +
peak-scaled int16 quantize) and the int8 weight-only decoder.

Port of ``sonata_tpu/models/decode_opts.py``.  Each
decoded streaming window ends here: the samples outside the row's emitted
range ``[lo, hi)`` are zeroed, the range's edges get the reference's
per-chunk crossfade taper, and the row is quantized to int16 against its
own peak, which goes out beside it so the host restores the amplitudes
exactly (:func:`dequantize_chunk`).

On a CUDA tensor :func:`fused_epilogue` launches the hand-written kernel
``csrc/epilogue.cu``, which replaces the TPU kernel ``_pallas_epilogue``
(``_pallas_epilogue_kernel``); on a CPU tensor it takes the plain version
:func:`fused_epilogue_reference`.  A CUDA tensor never takes the plain
version.  What bounds the kernel on the card: memory (6 bytes a sample),
and at batch 1 the latency of the loads, so one thread-block cluster of up
to 8 blocks shares each row (:func:`epilogue_plan`); its design is
described in the source.

``SONATA_FUSED_EPILOGUE`` selects ``fused`` (the default: this epilogue)
or ``off`` (the host-side slice + :meth:`AudioSamples.crossfade`, which only
a voice on the CPU takes).  ``lax`` and ``pallas``, the JAX package's names
for its two fused arms, are accepted as aliases of ``fused`` so that one
environment serves both packages.

``SONATA_DECODE_QUANT=int8`` (default off) quantizes every HiFi-GAN conv
weight to int8 with one float32 scale per output channel, once, at voice
load, in numpy with the JAX module's arithmetic (:func:`quantize_decoder`:
the same ``w_q`` and ``w_scale`` bits).  On the device the decoder keeps
``w_q`` as an int8 tensor and rescales it to float32 right before each
convolution (:class:`~.weights.QConv`); activations stay float32.  The
epilogue's input stays float32 under every arm.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ..core import OperationError

FUSED_EPILOGUE_ENV = "SONATA_FUSED_EPILOGUE"
FUSED_EPILOGUE_MODES = ("fused", "off")
#: the JAX package's fused arms; each means ``fused`` here
FUSED_EPILOGUE_ALIASES = ("lax", "pallas")

DECODE_QUANT_ENV = "SONATA_DECODE_QUANT"

#: float32 pi/2 as a Python float (exactly representable, so the float32
#: product is the reference's); a host scalar needs no copy to the card
_HALF_PI = float(np.float32(np.pi / 2))


def resolve_fused_epilogue(setting: Optional[str] = None,
                           env: Optional[dict] = None) -> str:
    """``fused`` (the default) | ``off``; a typo fails loudly."""
    if setting is None:
        env = os.environ if env is None else env
        setting = env.get(FUSED_EPILOGUE_ENV, "").strip().lower()
    if not setting or setting in FUSED_EPILOGUE_ALIASES:
        return "fused"
    if setting not in FUSED_EPILOGUE_MODES:
        raise OperationError(
            f"{FUSED_EPILOGUE_ENV}={setting!r} is not one of "
            f"{'/'.join(FUSED_EPILOGUE_MODES + FUSED_EPILOGUE_ALIASES)}")
    return setting


def resolve_decode_quant(setting: Optional[str] = None,
                         env: Optional[dict] = None) -> Optional[str]:
    """``int8`` or None (off); a typo fails loudly."""
    if setting is None:
        env = os.environ if env is None else env
        setting = env.get(DECODE_QUANT_ENV, "").strip().lower()
    if setting in ("", "off", "0"):
        return None
    if setting == "int8":
        return "int8"
    raise OperationError(
        f"{DECODE_QUANT_ENV}={setting!r} is not one of int8/off")


def fused_epilogue_reference(wav: torch.Tensor, lo: torch.Tensor,
                             hi: torch.Tensor, fade: int):
    """Plain PyTorch version, in the float32 operation order of the
    reference's ``_taper_gains`` and ``_quantize_rows``.

    ``wav``: [B, S] float32; ``lo``/``hi``: [B] int32 sample bounds of each
    row's emitted range.  Returns (int16 [B, S], peak [B])."""
    idx = torch.arange(wav.shape[-1], dtype=torch.int32,
                       device=wav.device)[None, :]
    lo, hi = lo[:, None], hi[:, None]
    n = torch.clamp(hi - lo, max=fade)
    nf = torch.clamp(n, min=1).to(torch.float32)
    j = (idx - lo).to(torch.float32)
    k = (idx - (hi - n)).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=wav.device)
    in_gain = torch.where(idx - lo < n, torch.sin(j / nf * _HALF_PI), one)
    out_gain = torch.where(idx >= hi - n, torch.cos(k / nf * _HALF_PI), one)
    mask = ((idx >= lo) & (idx < hi)).to(torch.float32)
    tapered = wav * (in_gain * out_gain * mask)
    peak = torch.amax(torch.abs(tapered), dim=-1)
    floor = torch.clamp(peak, min=0.01)[:, None]
    # a true division, as the reference's: ``32767.0 / tensor`` would be
    # ``reciprocal(tensor) * 32767``, an ulp off for about a quarter of peaks
    scale = torch.full_like(floor, 32767.0) / floor
    q = torch.clamp(tapered * scale, -32768.0, 32767.0).to(torch.int16)
    return q, peak


#: the portable thread-block cluster size: the most blocks sharing a row
EPILOGUE_MAX_CLUSTER = 8
#: a row gets one block per this many samples, up to the cluster's size
EPILOGUE_BLOCK_SAMPLES = 2048
#: the longest fade the kernel's gain table holds (the port's is 42)
EPILOGUE_MAX_FADE = 1024


def epilogue_plan(b: int, s: int):
    """The kernel's launch for ``wav [b, s]``, a function of the shape only:
    ``(c, lv, grid)`` with ``c`` blocks in each row's cluster, ``lv`` float4
    vectors in each block's slice, and the grid ``(c, b)``."""
    c = max(1, min(EPILOGUE_MAX_CLUSTER, -(-s // EPILOGUE_BLOCK_SAMPLES)))
    vectors = -(-s // 4)
    return c, -(-vectors // c), (c, b)


def epilogue_slices(s: int, c: int, lv: int, head: int = 0,
                    vector: bool = True):
    """The samples each block of a row's cluster takes in the kernel, as a
    list of ``[(start, stop), ...]`` ranges per rank.

    In vector mode (the row's wav and q start at the same place within a
    vector) rank ``k`` takes vectors ``[k·lv, (k+1)·lv)`` of those that
    follow the row's ``head`` samples before its first 16-byte boundary, and
    rank 0 also takes the head and the tail after the last whole vector.
    Otherwise rank ``k`` takes samples ``[4k·lv, 4(k+1)·lv)``."""
    if not vector:
        return [[(min(4 * k * lv, s), min(4 * (k + 1) * lv, s))]
                for k in range(c)]
    head = min(head, s)
    nv = (s - head) // 4
    slices = []
    for k in range(c):
        v0 = min(k * lv, nv)
        v1 = min(v0 + lv, nv)
        slices.append([(head + 4 * v0, head + 4 * v1)])
    slices[0] += [(0, head), (head + 4 * nv, s)]
    return slices


def fused_epilogue(wav: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   fade: int):
    """Taper + quantize decoded windows: the kernel on a CUDA tensor, the
    plain version on a CPU one.  Same arguments and results as
    :func:`fused_epilogue_reference`."""
    # every decoder arm hands the epilogue float32 (the bf16 decode casts
    # back before tanh); any other input is refused, never cast
    if wav.dtype != torch.float32 or wav.dim() != 2:
        raise OperationError(
            f"fused_epilogue: expected float32 [B, S], got {wav.dtype} "
            f"{tuple(wav.shape)}")
    if wav.device.type == "cpu":
        return fused_epilogue_reference(wav, lo, hi, fade)
    if wav.device.type != "cuda":
        raise OperationError(f"fused_epilogue: unsupported device "
                             f"{wav.device}")
    b, s = wav.shape
    for name, t in (("lo", lo), ("hi", hi)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (b,)
                or t.device != wav.device):
            raise OperationError(
                f"fused_epilogue: expected int32 {name} [{b}] on "
                f"{wav.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if fade > EPILOGUE_MAX_FADE:
        raise OperationError(f"fused_epilogue: fade {fade} exceeds the "
                             f"kernel's {EPILOGUE_MAX_FADE} samples")
    wav, lo, hi = wav.contiguous(), lo.contiguous(), hi.contiguous()
    cluster, lv, _ = epilogue_plan(b, s)
    q = torch.empty((b, s), dtype=torch.int16, device=wav.device)
    peak = torch.empty((b,), dtype=torch.float32, device=wav.device)
    from ..ops._build import check, library, stream_of

    rc = library().sonata_epilogue_f32(
        wav.data_ptr(), lo.data_ptr(), hi.data_ptr(), q.data_ptr(),
        peak.data_ptr(), b, s, int(fade), cluster, lv, wav.device.index,
        stream_of(wav))
    check(rc, "fused_epilogue")
    with _launch_lock:  # the mesh's lanes launch from several threads
        fused_epilogue.launches += 1
    return q, peak


#: kernel launches since the last reset (the CPU path never counts)
fused_epilogue.launches = 0
_launch_lock = threading.Lock()


def dequantize_chunk(q, peak) -> np.ndarray:
    """Host-side inverse of the fused quantize for one row: restores the
    pre-quantization float32 amplitudes (same 0.01 floor)."""
    return np.asarray(q, np.float32) * (max(float(peak), 0.01) / 32767.0)


# ---------------------------------------------------------------------------
# int8 weight-only decoder quantization (numpy, the reference's layouts)
# ---------------------------------------------------------------------------

def _map_convs(tree, fn):
    """Apply ``fn`` to every conv-param dict (the {w, b} /
    {w_q, w_scale, b} leaves) of a decoder subtree, preserving
    structure."""
    if isinstance(tree, dict):
        if "w" in tree or "w_q" in tree:
            return fn(tree)
        return {k: _map_convs(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_convs(v, fn) for v in tree]
    return tree


def quantize_decoder(pd):
    """Per-output-channel symmetric int8 of every decoder conv weight.

    ``pd`` is the reference's decoder tree (numpy leaves, weights
    ``[K, C_in, C_out]``); each output channel gets its own scale
    (``max|w| / 127`` over the kernel and input axes).  Biases stay
    float32.  The arithmetic is the reference's, in numpy, so ``w_q``
    (int8) and ``w_scale`` (float32 ``[1, 1, C_out]``) are bit-equal to
    its arrays.  An already-quantized conv passes through."""
    def q_conv(p):
        if "w_q" in p:
            return p  # already quantized (replica copies)
        w = np.asarray(p["w"], np.float32)
        scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)),
                       keepdims=True) / 127.0
        scale = np.maximum(scale, 1e-12).astype(np.float32)
        wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
        out = {"w_q": wq, "w_scale": scale}
        if "b" in p:
            out["b"] = p["b"]
        return out

    return _map_convs(pd, q_conv)


def decoder_is_quantized(pd) -> bool:
    """Whether a decoder (a reference tree, or the port's module tree)
    holds int8 weights."""
    if isinstance(pd, torch.nn.Module):
        return any(name.endswith("w_q") for name, _ in pd.named_buffers())
    hit = []

    def probe(p):
        if "w_q" in p:
            hit.append(True)
        return p

    _map_convs(pd, probe)
    return bool(hit)


def dequantize_decoder(pd):
    """Structural inverse on a reference tree: int8 weights rescale to
    float32 (``w_q * w_scale``, the product :class:`~.weights.QConv` forms
    on the device before each conv).  A plain float32 tree passes
    through untouched."""
    if not decoder_is_quantized(pd):
        return pd

    def dq(p):
        if "w_q" not in p:
            return p
        out = {"w": np.asarray(p["w_q"]).astype(np.float32)
               * np.asarray(p["w_scale"], np.float32)}
        if "b" in p:
            out["b"] = p["b"]
        return out

    return _map_convs(pd, dq)
