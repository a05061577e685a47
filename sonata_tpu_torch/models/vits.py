"""Piper-flavor VITS in PyTorch.

Port of ``sonata_tpu/models/vits.py``, stage for stage:

- ``encode_text``  — text encoder + stochastic duration predictor
                     → phoneme-level priors and frame durations.
- ``acoustics``    — length regulation (``generate_path``), prior sampling,
                     residual-coupling flow (reverse) → latent ``z``.
- ``decode_with``  — HiFi-GAN generator: ``z`` → waveform.
- ``infer``        — the three composed: ids → waveform.

Differences from the reference, on purpose:

- **Noise is an argument.**  PyTorch cannot reproduce JAX's threefry, so
  the stochastic stages take explicit standard-normal tensors instead of
  keys: ``duration_predictor_reverse``/``encode_text`` a ``[B, T, 2]``
  draw, ``acoustics`` a ``[B, F, C]`` draw.  :func:`per_row_normal` is the
  port's own sampler, with the reference's per-row rule.
- The decoder has the reference's precision arms (``compute_dtype``, and
  int8 weights through :class:`~.weights.QConv`); every other stage is
  float32.
- A device mesh (``mesh=``, :mod:`..parallel`) is placed by the port
  itself, where XLA's partitioner places the reference's: rows split over
  the data axis (:func:`..parallel.mesh.map_rows`), the text encoder and
  the frame domain over the seq axis (:mod:`.seq_parallel`), and the
  decoder's channels over the model axis with its collectives written out
  (:func:`decode_tensor_parallel`).  Every stage returns its rows to the
  device its inputs came from.

Public functions keep ``[batch, time, channels]`` and ``[B, T, 1]`` masks;
the flow and the decoder run in torch's ``[B, C, T]`` inside.
"""

from __future__ import annotations

import hashlib
import math

import torch

from ..parallel.mesh import map_rows
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


def text_encoder(p, hp: VitsHyperParams, ids, x_mask, mesh=None):
    x = p["emb"][ids] * math.sqrt(hp.hidden_channels)  # [B, T, H]
    seq = 0 if mesh is None else mesh.shape.get("seq", 1)
    if mesh is not None and seq > 1 and x.shape[1] % seq == 0:
        # sequence parallelism: ring attention + halo convs over the
        # mesh's seq axis (long inputs shard along time)
        x = m.transformer_seq_parallel(x, x_mask, p["encoder"],
                                       n_heads=hp.n_heads,
                                       window=hp.attn_window, mesh=mesh)
    else:
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
                noise_w, length_scale, sid=None, mesh=None):
    """ids [B, T] → (m_p, logs_p [B, T, C], w_ceil [B, T], x_mask, g).

    ``noise``: [B, T, 2] standard normal for the duration predictor.  On a
    ``mesh`` the rows split over the data axis and, when the text bucket
    divides by the seq axis, the encoder runs as a ring."""
    if mesh is not None:
        def group(sub, ids, x_lengths, noise, noise_w, length_scale, sid):
            return _encode_text(sub.put(p), hp, ids, x_lengths, noise,
                                noise_w, length_scale, sid, sub)

        return map_rows(mesh, group, ids, x_lengths, noise, noise_w,
                        length_scale, sid)
    return _encode_text(p, hp, ids, x_lengths, noise, noise_w, length_scale,
                        sid, None)


def _encode_text(p, hp, ids, x_lengths, noise, noise_w, length_scale, sid,
                 mesh):
    x_mask = sequence_mask(x_lengths, ids.shape[1])
    g = speaker_embedding(p, sid)
    x, m_p, logs_p = text_encoder(p["enc_p"], hp, ids, x_mask, mesh=mesh)
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
              noise_scale, max_frames: int, g=None, mesh=None):
    """Durations + priors → latent ``z`` [B, F, C] and the frame mask.

    ``noise``: [B, max_frames, C] standard normal for the prior.  On a
    ``mesh`` the rows split over the data axis and the flow runs over the
    seq axis when :func:`_use_seq_parallel` says so."""
    if mesh is not None:
        def group(sub, m_p, logs_p, w_ceil, x_mask, noise, noise_scale, g):
            return _acoustics(sub.put(p), hp, m_p, logs_p, w_ceil, x_mask,
                              noise, noise_scale, max_frames, g, sub)

        return map_rows(mesh, group, m_p, logs_p, w_ceil, x_mask, noise,
                        noise_scale, g)
    return _acoustics(p, hp, m_p, logs_p, w_ceil, x_mask, noise, noise_scale,
                      max_frames, g, None)


def _acoustics(p, hp, m_p, logs_p, w_ceil, x_mask, noise, noise_scale,
               max_frames, g, mesh):
    y_lengths = torch.clamp(w_ceil.sum(dim=1), 1, max_frames).to(torch.int32)
    y_mask = sequence_mask(y_lengths, max_frames)  # [B, F, 1]
    path = generate_path(w_ceil, x_mask, max_frames).transpose(1, 2)
    m_p_f = path @ m_p  # [B, F, C]
    logs_p_f = path @ logs_p
    z_p = m_p_f + noise * torch.exp(logs_p_f) * _as_rows(noise_scale,
                                                          m_p.device)
    if _use_seq_parallel(mesh, max_frames, hp):
        from .seq_parallel import flow_reverse_sp

        z = flow_reverse_sp(p["flow"], hp, z_p, y_mask, mesh, g=g)
    else:
        z = flow_reverse(p["flow"], hp, z_p, y_mask, g=g)
    return z * y_mask, y_mask, y_lengths


def _use_seq_parallel(mesh, frames: int, hp: VitsHyperParams) -> bool:
    """Frame-domain ops split over the seq axis when the mesh has one and
    the per-shard frame count leaves room for every conv halo (the halos
    are neighbour-only, so each stage's local length must cover its
    largest receptive-field reach), as the reference decides.

    A model axis above 1 turns it off: tensor parallelism owns the flow
    and the decoder then (the reference's rule); ring attention in the
    text domain still rides the seq axis."""
    if mesh is None:
        return False
    if mesh.shape.get("model", 1) > 1:
        return False
    seq = mesh.shape.get("seq", 1)
    if seq <= 1 or frames % seq:
        return False
    from .seq_parallel import min_local_frames

    return frames // seq >= min_local_frames(hp)


def flow_reverse(pf, hp: VitsHyperParams, z, mask, g=None, conv=None):
    """Residual-coupling flow, reverse.  ``z: [B, F, C]``, ``mask:
    [B, F, 1]``, ``g: [B, 1, gin]`` or None.  ``conv`` replaces the
    WaveNet's dilated convolutions (:mod:`.seq_parallel` passes a
    halo-exchange one)."""
    half = hp.inter_channels // 2
    z, mask = z.transpose(1, 2), mask.transpose(1, 2)
    g = None if g is None else g.transpose(1, 2)
    for layer in reversed(pf["layers"]):
        z = z.flip(1)  # Flip (reverse order: undo the flip first)
        z0, z1 = z[:, :half], z[:, half:]
        h = m.conv_nct(z0, layer["pre"]) * mask
        h = m.wn_nct(h, mask, layer["wn"], dilation_rate=1,
                     n_layers=hp.flow_wn_layers, g=g, conv=conv)
        mean = m.conv_nct(h, layer["post"]) * mask
        z1 = (z1 - mean) * mask  # mean-only coupling, reverse
        z = torch.cat([z0, z1], dim=1)
    return z.transpose(1, 2)


# ---------------------------------------------------------------------------
# stage 3: HiFi-GAN decoder
# ---------------------------------------------------------------------------

class _Cast:
    """A convolution's weight and bias in the compute dtype, cast at the
    read (an int8 weight is rescaled to float32 first, at its read).
    ``src`` is the convolution itself."""

    __slots__ = ("src", "dtype")

    def __init__(self, conv, dtype):
        self.src = conv
        self.dtype = dtype

    @property
    def weight(self):
        return self.src.weight.to(self.dtype)

    @property
    def bias(self):
        bias = self.src.bias
        return None if bias is None else bias.to(self.dtype)


def decode(p, hp: VitsHyperParams, z, g=None, mesh=None,
           compute_dtype=None):
    """Latent ``z`` [B, F, C] → waveform [B, F * hop] float32.

    Without a mesh this is :func:`decode_with`.  On a ``mesh`` the rows
    split over the data axis; in each data group the frames split over
    the seq axis (:func:`.seq_parallel.decode_sp`) when
    :func:`_use_seq_parallel` says so, else the channels over the model
    axis when it is above 1 (:func:`decode_tensor_parallel`)."""
    if mesh is None:
        return decode_with(p, hp, z, g=g, compute_dtype=compute_dtype)

    def group(sub, z, g):
        if _use_seq_parallel(sub, z.shape[1], hp):
            from .seq_parallel import decode_sp

            return decode_sp(p, hp, z, sub, g=g, compute_dtype=compute_dtype)
        if sub.shape.get("model", 1) > 1:
            return decode_tensor_parallel(p, hp, z, sub, g=g,
                                          compute_dtype=compute_dtype)
        return decode_with(sub.put(p), hp, z, g=g,
                           compute_dtype=compute_dtype)

    return map_rows(mesh, group, z, g)


def decode_with(p, hp: VitsHyperParams, z, g=None, *, conv=None, tconv=None,
                compute_dtype=None):
    """HiFi-GAN generator on ``p["dec"]``: ``z: [B, F, C]``, ``g: [B, 1,
    gin]`` or None → ``[B, F * hop]`` float32.

    ``conv``/``tconv`` replace :func:`.modules.conv_nct` and
    :func:`.modules.conv_transpose_nct` (the sharded decoders pass
    halo-exchange or channel-split ones), so the model math exists once;
    each receives the convolution, or its :class:`_Cast`.
    ``compute_dtype``: ``torch.bfloat16`` casts each conv's weights (kept
    as loaded) and the activations to bfloat16 at the call and returns to
    float32 before ``tanh``, as the reference's ``decode_with`` does, so
    the waveform and the epilogue after it stay float32.  An int8 conv's
    weight is rescaled to float32 and then cast, the reference's order."""
    conv = conv or m.conv_nct
    tconv = tconv or m.conv_transpose_nct
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
    x = conv(z.transpose(1, 2), cv(pd["conv_pre"]))
    if g is not None and "cond" in pd:
        x = x + m.conv_nct(g.transpose(1, 2), cv(pd["cond"]))
    n_kernels = len(hp.resblock_kernel_sizes)
    for i, (r_up, k_up) in enumerate(zip(hp.upsample_rates,
                                         hp.upsample_kernel_sizes)):
        x = torch.nn.functional.leaky_relu(x, m.LRELU_SLOPE)
        x = tconv(x, cv(pd["ups"][i]), stride=r_up,
                  padding=(k_up - r_up) // 2)
        xs = None
        for j in range(n_kernels):
            y = _resblock1(pd["resblocks"][i * n_kernels + j], x,
                           hp.resblock_dilation_sizes[j], cv, conv)
            xs = y if xs is None else xs + y
        x = xs / n_kernels
    x = torch.nn.functional.leaky_relu(x, m.LRELU_SLOPE)
    x = conv(x, cv(pd["conv_post"]))
    return torch.tanh(x.to(torch.float32))[:, 0]  # [B, samples]


def _resblock1(block, x, dilations, cv=lambda q: q, conv=None):
    conv = conv or m.conv_nct
    for c1, c2, d in zip(block["convs1"], block["convs2"], dilations):
        y = torch.nn.functional.leaky_relu(x, m.LRELU_SLOPE)
        y = conv(y, cv(c1), dilation=d)
        y = torch.nn.functional.leaky_relu(y, m.LRELU_SLOPE)
        y = conv(y, cv(c2))
        x = x + y
    return x


# ---------------------------------------------------------------------------
# the tensor-parallel decoder: its collectives, placed by hand
# ---------------------------------------------------------------------------

class _Weights:
    """A convolution's (sliced) weight and bias, as the conv primitives
    read them."""

    __slots__ = ("weight", "bias")

    def __init__(self, weight, bias):
        self.weight = weight
        self.bias = bias


def decode_tensor_parallel(p, hp: VitsHyperParams, z, mesh, g=None,
                           compute_dtype=None):
    """:func:`decode_with` with the decoder's channels split over the
    mesh's model axis, by the placements of
    :func:`..parallel.mesh.param_shardings` (Megatron's column/row pairs):

    - column (``conv_pre``, ``ups``, each resblock's ``convs1``): each
      model position computes its block of output channels from the whole
      input, and the blocks are gathered on the group's lead device,
      since the next op (a residual add, a transposed conv) needs them
      all;
    - row (each resblock's ``convs2``): each position convolves its block
      of input channels, and the partial sums are reduced on the lead
      device in position order before the bias adds;
    - replicated (``conv_post``, ``cond``, a channel count the axis does
      not divide): computed once, on the lead device.

    XLA's partitioner places the reference's collectives; these are the
    port's.  Rows split over the data axis first."""
    from ..parallel.mesh import MODEL_AXIS, conv_placement

    def group(sub, z, g):
        devs = sub.axis_devices(MODEL_AXIS)
        parts = len(devs)
        pp = sub.put(p)
        kinds = {}
        for name, mod in pp["dec"].named_modules():
            if hasattr(mod, "weight"):
                kinds[id(mod)] = conv_placement(
                    ("dec",) + tuple(name.split(".")), mod, parts)

        def split(q):
            """(weight placement, per-position weights) of conv ``q``, or
            (None, None) when it is replicated."""
            src = getattr(q, "src", q)
            place = kinds.get(id(src))
            if place is None or place["w"].dim is None:
                return None, None
            dtype = getattr(q, "dtype", None)
            shards = []
            for k, dev in enumerate(devs):
                w = sub.shard(src.weight, place["w"].dim, k, parts, dev)
                # a column conv's bias splits with its output channels; a
                # row conv's adds after the reduce
                b = (None if place["b"].dim is None
                     else sub.shard(src.bias, 0, k, parts, dev))
                if dtype is not None:
                    w = w.to(dtype)
                    b = None if b is None else b.to(dtype)
                shards.append(_Weights(w, b))
            return place["w"], shards

        def gather(ys, lead):
            return torch.cat([y.to(lead, non_blocking=True) for y in ys],
                             dim=1)

        def conv(x, q, *, dilation: int = 1):
            place, shards = split(q)
            if place is None:
                return m.conv_nct(x, q, dilation=dilation)
            lead = x.device
            if place.dim == 0:  # column: [C_out, C_in, K] split on C_out
                return gather([m.conv_nct(x.to(dev, non_blocking=True), w,
                                          dilation=dilation)
                               for w, dev in zip(shards, devs)], lead)
            # row: [C_out, C_in, K] split on C_in, partial sums reduced
            step = x.shape[1] // parts
            y = None
            for k, (w, dev) in enumerate(zip(shards, devs)):
                part = m.conv_nct(
                    x[:, k * step:(k + 1) * step].to(dev, non_blocking=True),
                    w, dilation=dilation).to(lead, non_blocking=True)
                y = part if y is None else y + part
            bias = q.bias
            return y if bias is None else y + bias[None, :, None]

        def tconv(x, q, *, stride: int, padding: int):
            place, shards = split(q)
            if place is None:
                return m.conv_transpose_nct(x, q, stride=stride,
                                            padding=padding)
            # column: ConvTranspose1d [C_in, C_out, K] split on C_out
            return gather([m.conv_transpose_nct(
                x.to(dev, non_blocking=True), w, stride=stride,
                padding=padding) for w, dev in zip(shards, devs)], x.device)

        return decode_with(pp, hp, z, g=g, conv=conv, tconv=tconv,
                           compute_dtype=compute_dtype)

    return map_rows(mesh, group, z, g)


# ---------------------------------------------------------------------------
# full graph
# ---------------------------------------------------------------------------

def infer(p, hp: VitsHyperParams, ids, x_lengths, dur_noise, prior_noise, *,
          noise_scale=0.667, length_scale=1.0, noise_w=0.8,
          max_frames: int = 1024, sid=None):
    """Single-graph inference: ids → waveform, the reference's single-ONNX
    contract (``input [B, T]``, ``input_lengths [B]``, the scales, ``sid``)
    with a static frame budget ``max_frames``.

    The noise is explicit, as in every stochastic stage here:
    ``dur_noise`` [B, T, 2] for the duration predictor and ``prior_noise``
    [B, max_frames, C] for the prior, standard normal.

    Returns ``(wav [B, max_frames * hop], wav_lengths [B])`` in samples."""
    m_p, logs_p, w_ceil, x_mask, g = encode_text(
        p, hp, ids, x_lengths, dur_noise, noise_w=noise_w,
        length_scale=length_scale, sid=sid)
    z, _y_mask, y_lengths = acoustics(
        p, hp, m_p, logs_p, w_ceil, x_mask, prior_noise,
        noise_scale=noise_scale, max_frames=max_frames, g=g)
    wav = decode(p, hp, z, g=g)
    return wav, y_lengths * hp.hop_length
