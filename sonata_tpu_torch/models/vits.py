"""Piper-flavor VITS in PyTorch.

Port of ``sonata_tpu/models/vits.py``, stage for stage:

- ``encode_text``  — text encoder + stochastic duration predictor
                     → phoneme-level priors and frame durations.
- ``acoustics``    — length regulation (``generate_path``), prior sampling,
                     residual-coupling flow (reverse) → latent ``z``.
- ``decode_with``  — HiFi-GAN generator: ``z`` → waveform.

Differences from the reference, on purpose:

- **Noise is an argument.**  PyTorch cannot reproduce JAX's threefry, so
  the stochastic stages take explicit standard-normal tensors instead of
  keys: ``duration_predictor_reverse``/``encode_text`` a ``[B, T, 2]``
  draw, ``acoustics`` a ``[B, F, C]`` draw.  :func:`per_row_normal` is the
  port's own sampler, with the reference's per-row rule.
- No device mesh: the sequence-parallel stages are later work.  The
  decoder has the reference's precision arms (``compute_dtype``, and int8
  weights through :class:`~.weights.QConv`); every other stage is
  float32.

Public functions keep ``[batch, time, channels]`` and ``[B, T, 1]`` masks;
the flow and the decoder run in torch's ``[B, C, T]`` inside.
"""

from __future__ import annotations

import hashlib
import math

import torch

from . import modules as m
from .config import VitsHyperParams


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

def _row_seed(*parts: int) -> int:
    """A 63-bit generator seed mixed from integers (seed, counter, stream,
    row), the same in every process."""
    digest = hashlib.blake2b(repr(tuple(int(p) for p in parts)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def per_row_normal(seed: int, counter: int, stream: int,
                   shape: tuple) -> torch.Tensor:
    """Standard-normal ``[B, ...]`` draws, on the CPU, with one
    ``torch.Generator`` per row.

    Row ``i`` is drawn from a generator seeded by ``(seed, counter,
    stream, i)`` over the per-row shape alone, so a row's draw depends only
    on those values and the row shape — never on its batch neighbours or
    on padding rows, which is the rule of the reference's
    ``vits.per_row_normal``.  The bits are not the reference's."""
    rows = []
    for i in range(shape[0]):
        gen = torch.Generator().manual_seed(_row_seed(seed, counter, stream, i))
        rows.append(torch.randn(tuple(shape[1:]), generator=gen))
    return torch.stack(rows) if rows else torch.zeros(tuple(shape))


# ---------------------------------------------------------------------------
# stage 1: text encoder + stochastic duration predictor
# ---------------------------------------------------------------------------

def sequence_mask(lengths, max_len: int):
    """[B] lengths → [B, max_len, 1] float mask."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return (idx < lengths[:, None]).to(torch.float32)[..., None]


def text_encoder(p, hp: VitsHyperParams, ids, x_mask):
    x = p["emb"][ids] * math.sqrt(hp.hidden_channels)  # [B, T, H]
    x = m.transformer(x, x_mask, p["encoder"], n_heads=hp.n_heads,
                      window=hp.attn_window)
    stats = m.conv1d(x, p["proj"]) * x_mask
    m_p, logs_p = torch.chunk(stats, 2, dim=-1)
    return x, m_p, logs_p


def _as_rows(value, device):
    """A scalar or a per-row [B] vector → [B or 1, 1, 1] float32."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).reshape(-1, 1, 1)


def duration_predictor_reverse(p, hp: VitsHyperParams, x, x_mask, noise,
                               noise_w, g=None):
    """Stochastic duration predictor, inference (reverse-flow) path → logw.

    ``noise``: [B, T, 2] standard normal.  The flow order follows VITS
    inference exactly, including skipping ConvFlow #0."""
    h = m.conv1d(x, p["pre"])
    if g is not None and "cond" in p:
        h = h + m.conv1d(g, p["cond"])
    h = m.dds_conv(h, x_mask, p["convs"], kernel=hp.dp_kernel_size)
    h = m.conv1d(h, p["proj"]) * x_mask

    z = noise * _as_rows(noise_w, x.device) * x_mask
    # reversed flow stack: Flip/ConvFlow pairs (skipping ConvFlow #0), then
    # the elementwise affine
    for i in range(hp.dp_n_flows - 1, 0, -1):
        z = z.flip(-1)
        z = _conv_flow_reverse(p["flows"][i], hp, z, x_mask, h)
    z = z.flip(-1)  # the Flip preceding the skipped ConvFlow #0
    aff = p["affine"]
    z = (z - aff["m"]) * torch.exp(-aff["logs"]) * x_mask
    return z[..., 0:1]


def _conv_flow_reverse(pf, hp: VitsHyperParams, z, mask, g):
    z0, z1 = z[..., 0:1], z[..., 1:2]
    h = m.conv1d(z0, pf["pre"])
    h = m.dds_conv(h, mask, pf["convs"], kernel=hp.dp_kernel_size, g=g)
    h = m.conv1d(h, pf["proj"]) * mask  # [B, T, 3*bins-1]
    nb = hp.dp_num_bins
    filt = hp.dp_filter_channels
    uw = h[..., :nb] / math.sqrt(filt)
    uh = h[..., nb:2 * nb] / math.sqrt(filt)
    ud = h[..., 2 * nb:]
    x1, _ = m.rational_quadratic_spline_inverse(
        z1[..., 0], uw, uh, ud, tail_bound=hp.dp_tail_bound)
    return torch.cat([z0, x1[..., None] * mask], dim=-1)


def speaker_embedding(p, sid):
    """[B] speaker ids → g [B, 1, gin], or None for a single-speaker
    voice."""
    if sid is None or "emb_g" not in p:
        return None
    return p["emb_g"][sid][:, None, :]


def encode_text(p, hp: VitsHyperParams, ids, x_lengths, noise, *,
                noise_w, length_scale, sid=None):
    """ids [B, T] → (m_p, logs_p [B, T, C], w_ceil [B, T], x_mask, g).

    ``noise``: [B, T, 2] standard normal for the duration predictor."""
    x_mask = sequence_mask(x_lengths, ids.shape[1])
    g = speaker_embedding(p, sid)
    x, m_p, logs_p = text_encoder(p["enc_p"], hp, ids, x_mask)
    logw = duration_predictor_reverse(p["dp"], hp, x, x_mask, noise,
                                      noise_w, g=g)
    w = torch.exp(logw) * x_mask * _as_rows(length_scale, ids.device)
    w_ceil = torch.ceil(w)[..., 0]  # [B, T]
    return m_p, logs_p, w_ceil, x_mask, g


# ---------------------------------------------------------------------------
# stage 2: length regulation + prior + flow reverse
# ---------------------------------------------------------------------------

def generate_path(w_ceil, x_mask, max_frames: int):
    """Monotonic alignment path: ``w_ceil: [B, T]`` → ``[B, T, F]`` with
    ``path[b, t, f] = 1`` iff frame ``f`` belongs to phoneme ``t``.  The
    exclusive prefix sum is ``cum - w`` (exact: durations are small
    integers), as in the reference."""
    w = w_ceil * x_mask[..., 0]
    cum = torch.cumsum(w, dim=1)
    f = torch.arange(max_frames, device=w.device)[None, None, :]
    upper = f < cum[..., None]
    lower = f >= (cum - w)[..., None]
    return (upper & lower).to(torch.float32)


def acoustics(p, hp: VitsHyperParams, m_p, logs_p, w_ceil, x_mask, noise, *,
              noise_scale, max_frames: int, g=None):
    """Durations + priors → latent ``z`` [B, F, C] and the frame mask.

    ``noise``: [B, max_frames, C] standard normal for the prior."""
    y_lengths = torch.clamp(w_ceil.sum(dim=1), 1, max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames)  # [B, F, 1]
    path = generate_path(w_ceil, x_mask, max_frames).transpose(1, 2)
    m_p_f = path @ m_p  # [B, F, C]
    logs_p_f = path @ logs_p
    z_p = m_p_f + noise * torch.exp(logs_p_f) * _as_rows(noise_scale,
                                                          m_p.device)
    z = flow_reverse(p["flow"], hp, z_p, y_mask, g=g)
    return z * y_mask, y_mask, y_lengths


def flow_reverse(pf, hp: VitsHyperParams, z, mask, g=None):
    """Residual-coupling flow, reverse.  ``z: [B, F, C]``, ``mask:
    [B, F, 1]``, ``g: [B, 1, gin]`` or None."""
    half = hp.inter_channels // 2
    z, mask = z.transpose(1, 2), mask.transpose(1, 2)
    g = None if g is None else g.transpose(1, 2)
    for layer in reversed(pf["layers"]):
        z = z.flip(1)  # Flip (reverse order: undo the flip first)
        z0, z1 = z[:, :half], z[:, half:]
        h = m.conv_nct(z0, layer["pre"]) * mask
        h = m.wn_nct(h, mask, layer["wn"], dilation_rate=1,
                     n_layers=hp.flow_wn_layers, g=g)
        mean = m.conv_nct(h, layer["post"]) * mask
        z1 = (z1 - mean) * mask  # mean-only coupling, reverse
        z = torch.cat([z0, z1], dim=1)
    return z.transpose(1, 2)


# ---------------------------------------------------------------------------
# stage 3: HiFi-GAN decoder
# ---------------------------------------------------------------------------

class _Cast:
    """A convolution's weight and bias in the compute dtype, cast at the
    call (an int8 weight is rescaled to float32 first, at its read)."""

    __slots__ = ("weight", "bias")

    def __init__(self, conv, dtype):
        self.weight = conv.weight.to(dtype)
        self.bias = None if conv.bias is None else conv.bias.to(dtype)


def decode_with(p, hp: VitsHyperParams, z, g=None, *, compute_dtype=None):
    """HiFi-GAN generator on ``p["dec"]``: ``z: [B, F, C]``, ``g: [B, 1,
    gin]`` or None → ``[B, F * hop]`` float32.

    ``compute_dtype``: ``torch.bfloat16`` casts each conv's weights (kept
    as loaded) and the activations to bfloat16 at the call and returns to
    float32 before ``tanh``, as the reference's ``decode_with`` does, so
    the waveform and the epilogue after it stay float32.  An int8 conv's
    weight is rescaled to float32 and then cast, the reference's order."""
    pd = p["dec"]
    if compute_dtype is None:
        def cv(q):
            return q
    else:
        def cv(q):
            return _Cast(q, compute_dtype)

        z = z.to(compute_dtype)
        if g is not None:
            g = g.to(compute_dtype)
    x = m.conv_nct(z.transpose(1, 2), cv(pd["conv_pre"]))
    if g is not None and "cond" in pd:
        x = x + m.conv_nct(g.transpose(1, 2), cv(pd["cond"]))
    n_kernels = len(hp.resblock_kernel_sizes)
    for i, (r_up, k_up) in enumerate(zip(hp.upsample_rates,
                                         hp.upsample_kernel_sizes)):
        x = torch.nn.functional.leaky_relu(x, m.LRELU_SLOPE)
        x = m.conv_transpose_nct(x, cv(pd["ups"][i]), stride=r_up,
                                 padding=(k_up - r_up) // 2)
        xs = None
        for j in range(n_kernels):
            y = _resblock1(pd["resblocks"][i * n_kernels + j], x,
                           hp.resblock_dilation_sizes[j], cv)
            xs = y if xs is None else xs + y
        x = xs / n_kernels
    x = torch.nn.functional.leaky_relu(x, m.LRELU_SLOPE)
    x = m.conv_nct(x, cv(pd["conv_post"]))
    return torch.tanh(x.to(torch.float32))[:, 0]  # [B, samples]


def _resblock1(block, x, dilations, cv=lambda q: q):
    for c1, c2, d in zip(block["convs1"], block["convs2"], dilations):
        y = torch.nn.functional.leaky_relu(x, m.LRELU_SLOPE)
        y = m.conv_nct(y, cv(c1), dilation=d)
        y = torch.nn.functional.leaky_relu(y, m.LRELU_SLOPE)
        y = m.conv_nct(y, cv(c2))
        x = x + y
    return x
