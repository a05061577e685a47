"""Neural building blocks for VITS, as PyTorch functions over parameter
modules.

Port of ``sonata_tpu/models/modules.py``.  Parameters live in the
``nn.Module`` tree built by :mod:`.weights` (a convolution is a
:class:`~.weights.Conv` holding ``weight`` in torch's ``[C_out, C_in, K]``
layout and ``bias``); the functions here keep the JAX package's names,
arguments and ``[B, T, C]`` layout with ``[B, T, 1]`` masks, so each can be
held against its reference.  The heavy stacks (WaveNet, HiFi-GAN) also have
``*_nct`` forms that stay in torch's ``[B, C, T]`` between convolutions;
the ``[B, T, C]`` functions wrap them with one transpose each way.

Points where the reference's exact numerics are kept on purpose:
SAME padding is ``(k_eff // 2, k_eff - 1 - k_eff // 2)``; masked attention
logits are filled with ``-1e4``; ``dds_conv`` uses the tanh-approximate
GELU (``jax.nn.gelu``'s default); ``layer_norm`` uses the population
variance with eps 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.gate import fused_gate as gate_op

LRELU_SLOPE = 0.1


# ---------------------------------------------------------------------------
# conv primitives
# ---------------------------------------------------------------------------

def conv_nct(x, p, *, dilation: int = 1, groups: int = 1):
    """SAME-padded 1-D convolution, ``x: [B, C_in, T]`` → ``[B, C_out, T]``."""
    w = p.weight  # read once: an int8 conv rescales at every read
    k_eff = (w.shape[-1] - 1) * dilation + 1
    left, right = k_eff // 2, k_eff - 1 - k_eff // 2
    if left != right:
        x = F.pad(x, (left, right))
        left = 0
    return F.conv1d(x, w, p.bias, padding=left, dilation=dilation,
                    groups=groups)


def conv1d(x, p, *, dilation: int = 1):
    """1-D convolution, ``x: [B, T, C_in]`` → ``[B, T, C_out]``."""
    if p.weight.shape[-1] == 1:  # pointwise: a matrix product over C
        return F.linear(x, p.weight[..., 0], p.bias)
    return conv_nct(x.transpose(1, 2), p, dilation=dilation).transpose(1, 2)


def conv_transpose_nct(x, p, *, stride: int, padding: int):
    """``torch.nn.ConvTranspose1d`` semantics, ``x: [B, C_in, T]``; output
    length ``(T-1)*stride - 2*padding + K``."""
    return F.conv_transpose1d(x, p.weight, p.bias, stride=stride,
                              padding=padding)


def conv_transpose1d(x, p, *, stride: int, padding: int):
    """Transposed 1-D conv, ``x: [B, T, C_in]`` → ``[B, T', C_out]``."""
    return conv_transpose_nct(x.transpose(1, 2), p, stride=stride,
                              padding=padding).transpose(1, 2)


def layer_norm(x, p, eps: float = 1e-5):
    """LayerNorm over channels (last dim), population variance."""
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], eps)


# ---------------------------------------------------------------------------
# windowed relative-position multi-head attention (VITS text encoder)
# ---------------------------------------------------------------------------

def _rel_to_abs(x):
    """[B*H, T, 2T-1] relative-indexed logits → [B*H, T, T] absolute."""
    b, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.reshape(b, t * 2 * t)
    x = F.pad(x, (0, t - 1))
    x = x.reshape(b, t + 1, 2 * t - 1)
    return x[:, :t, t - 1:]


def _abs_to_rel(x):
    """[B*H, T, T] absolute attention weights → [B*H, T, 2T-1] relative."""
    b, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x = x.reshape(b, t * (2 * t - 1))
    x = F.pad(x, (t, 0))
    x = x.reshape(b, t, 2 * t)
    return x[:, :, 1:]


def _rel_embeddings(emb, window: int, t: int):
    """Slice/pad the learned [-window, window] table to [2T-1] positions."""
    pad = max(t - window - 1, 0)
    start = max(window + 1 - t, 0)
    emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * t - 1]


def rel_attention(x, mask, p, *, n_heads: int, window: int):
    """Self-attention with learned relative position embeddings, window
    ±``window``.  ``x: [B, T, C]``, ``mask: [B, T, 1]`` (1 = valid)."""
    b, t, c = x.shape
    head = c // n_heads

    def split(u):  # [B, T, C] -> [B*H, T, head]
        return u.reshape(b, t, n_heads, head).transpose(1, 2).reshape(
            b * n_heads, t, head)

    q = split(conv1d(x, p["q"])) * head ** -0.5
    k = split(conv1d(x, p["k"]))
    v = split(conv1d(x, p["v"]))
    logits = q @ k.transpose(1, 2)
    rel_k = _rel_embeddings(p["emb_rel_k"], window, t)[0]  # [2T-1, head]
    logits = logits + _rel_to_abs(q @ rel_k.T)

    attn_mask = mask[:, None, :, 0] * mask[:, :, None, 0]  # [B, T, T]
    attn_mask = attn_mask.repeat_interleave(n_heads, dim=0)
    logits = logits.masked_fill(attn_mask <= 0, -1e4)
    weights = torch.softmax(logits, dim=-1)
    out = weights @ v
    rel_v = _rel_embeddings(p["emb_rel_v"], window, t)[0]  # [2T-1, head]
    out = out + _abs_to_rel(weights) @ rel_v

    out = out.reshape(b, n_heads, t, head).transpose(1, 2).reshape(b, t, c)
    return conv1d(out, p["o"]) * mask


# ---------------------------------------------------------------------------
# conv feed-forward and the transformer encoder stack
# ---------------------------------------------------------------------------

def ffn(x, mask, p):
    y = conv1d(x * mask, p["c1"])
    y = torch.relu(y)
    return conv1d(y * mask, p["c2"]) * mask


def transformer(x, mask, p, *, n_heads: int, window: int):
    """Post-norm transformer: x = LN(x + attn(x)); x = LN(x + ffn(x))."""
    x = x * mask
    for layer in p["layers"]:
        y = rel_attention(x, mask, layer["attn"], n_heads=n_heads,
                          window=window)
        x = layer_norm(x + y, layer["ln1"])
        y = ffn(x, mask, layer["ffn"])
        x = layer_norm(x + y, layer["ln2"])
    return x * mask


def transformer_seq_parallel(x, mask, p, *, n_heads: int, window: int,
                             mesh):
    """The same post-norm encoder stack, over the mesh's ``seq`` axis.

    Each data group's rows are cut along time into one shard per seq
    position, and the positions run the stack in lockstep
    (:meth:`~sonata_tpu_torch.parallel.mesh.Mesh.spmd`): attention is a
    ring (:func:`~sonata_tpu_torch.parallel.ring.ring_rel_attention_sharded`,
    exact, the windowed relative embeddings included, which couple only
    ring-adjacent blocks since |s−t| ≤ window), and the FFN's kernel-3
    convs take their neighbours' boundary columns by a halo exchange.
    Every other op is per position and stays local.  The numerics match
    :func:`transformer` (the same math, a blockwise softmax).

    ``x: [B, T, C]`` with ``T`` divisible by the seq-axis size."""
    from ..parallel.mesh import SEQ_AXIS, map_rows
    from ..parallel.ring import (
        halo_exchange,
        ring_rel_attention_sharded,
        split_time,
    )

    def attn_local(x_loc, mask_loc, lp):
        b, t, c = x_loc.shape
        head = c // n_heads

        def split(u):  # [B, T, C] → [B, H, T, head]
            return u.reshape(b, t, n_heads, head).transpose(1, 2)

        out = ring_rel_attention_sharded(
            split(conv1d(x_loc, lp["q"])), split(conv1d(x_loc, lp["k"])),
            split(conv1d(x_loc, lp["v"])), mask_loc[..., 0],
            lp["emb_rel_k"][0], lp["emb_rel_v"][0], window=window)
        out = out.transpose(1, 2).reshape(b, t, c)
        return conv1d(out, lp["o"]) * mask_loc

    def conv_halo(x_loc, cp):  # [B, T, C], SAME padding across shards
        k = cp.weight.shape[-1]
        ext = halo_exchange(x_loc.transpose(1, 2), k // 2, k - 1 - k // 2)
        return F.conv1d(ext, cp.weight, cp.bias).transpose(1, 2)

    def inner(x_loc, mask_loc, params):
        x_loc = x_loc * mask_loc
        for layer in params["layers"]:
            y = attn_local(x_loc, mask_loc, layer["attn"])
            x_loc = layer_norm(x_loc + y, layer["ln1"])
            y = conv_halo(x_loc * mask_loc, layer["ffn"]["c1"])
            y = torch.relu(y)
            y = conv_halo(y * mask_loc, layer["ffn"]["c2"]) * mask_loc
            x_loc = layer_norm(x_loc + y, layer["ln2"])
        return x_loc * mask_loc

    def group(sub, x, mask):
        devs = sub.axis_devices(SEQ_AXIS)
        args = [(xs, ms, sub.put(p, d)) for xs, ms, d in zip(
            split_time(x, devs, 1), split_time(mask, devs, 1), devs)]
        outs = sub.spmd(SEQ_AXIS, inner, args)
        return torch.cat([o.to(x.device) for o in outs], dim=1)

    return map_rows(mesh, group, x, mask)


# ---------------------------------------------------------------------------
# WaveNet block (used by the coupling flow)
# ---------------------------------------------------------------------------

def wn_nct(x, mask, p, *, dilation_rate: int, n_layers: int, g=None,
           conv=None):
    """:func:`wn` in ``[B, C, T]``: ``x: [B, H, T]``, ``mask: [B, 1, T]``,
    ``g: [B, gin, 1]`` or None.  ``conv`` replaces :func:`conv_nct` for the
    dilated convolutions (the sequence-sharded flow passes a
    halo-exchange one).

    Each layer's pre-activation comes out of its convolution as a
    contiguous ``[B, 2H, T]``; the gate kernel reads it in place through
    its ``[B, T, 2H]`` view and writes a contiguous ``[B, H, T]``, so no
    layer pays a transpose."""
    conv = conv or conv_nct
    hidden = x.shape[1]
    output = torch.zeros_like(x)
    g_all = None
    if g is not None and "cond" in p:
        g_all = conv_nct(g, p["cond"])  # [B, 2*H*n_layers, 1]
    for i in range(n_layers):
        x_in = conv(x, p["in"][i], dilation=dilation_rate ** i)
        g_l = None
        if g_all is not None:
            g_l = g_all[:, i * 2 * hidden:(i + 1) * 2 * hidden].transpose(1, 2)
        acts = gate_op(x_in.transpose(1, 2), g_l).transpose(1, 2)
        rs = conv_nct(acts, p["res_skip"][i])
        if i < n_layers - 1:
            x = (x + rs[:, :hidden]) * mask
            output = output + rs[:, hidden:]
        else:
            output = output + rs
    return output * mask


def wn(x, mask, p, *, kernel: int, dilation_rate: int, n_layers: int,
       g=None, conv=None):
    """Non-causal WaveNet: dilated convs, gated tanh units, residual+skip.

    ``x: [B, T, H]``; ``g: [B, 1, gin]`` speaker conditioning or None.  The
    gate runs through :func:`sonata_tpu_torch.ops.gate.fused_gate` (the
    CUDA kernel on the GPU).  ``kernel`` is implied by the weights; it is
    kept for the reference's signature."""
    del kernel
    out = wn_nct(x.transpose(1, 2), mask.transpose(1, 2), p,
                 dilation_rate=dilation_rate, n_layers=n_layers,
                 g=None if g is None else g.transpose(1, 2), conv=conv)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# DDSConv — dilated depth-separable convs (duration predictor backbone)
# ---------------------------------------------------------------------------

def dds_conv(x, mask, p, *, kernel: int, g=None):
    if g is not None:
        x = x + g
    c = x.shape[-1]
    for i, layer in enumerate(p["layers"]):
        y = conv_nct((x * mask).transpose(1, 2), layer["dw"],
                     dilation=kernel ** i, groups=c).transpose(1, 2)
        y = F.gelu(layer_norm(y, layer["ln1"]), approximate="tanh")
        y = conv1d(y, layer["pw"])
        y = F.gelu(layer_norm(y, layer["ln2"]), approximate="tanh")
        x = x + y
    return x * mask


# ---------------------------------------------------------------------------
# rational-quadratic spline (inverse mode) — ConvFlow transform
# ---------------------------------------------------------------------------

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def rational_quadratic_spline_inverse(y, unnorm_widths, unnorm_heights,
                                      unnorm_derivs, *, tail_bound: float):
    """Inverse pass of an unconstrained monotonic rational-quadratic spline
    (Durkan et al., Neural Spline Flows).  Identity outside
    ``[-tail_bound, tail_bound]``; the boundary derivatives are pinned to 1
    (linear tails)."""
    num_bins = unnorm_widths.shape[-1]
    inside = (y >= -tail_bound) & (y <= tail_bound)

    widths = torch.softmax(unnorm_widths, dim=-1)
    widths = DEFAULT_MIN_BIN_WIDTH + (1 - DEFAULT_MIN_BIN_WIDTH * num_bins) * widths
    cumwidths = F.pad(torch.cumsum(widths, dim=-1), (1, 0))
    cumwidths = (2 * tail_bound) * cumwidths - tail_bound
    widths = cumwidths[..., 1:] - cumwidths[..., :-1]

    derivs = DEFAULT_MIN_DERIVATIVE + F.softplus(unnorm_derivs)
    pad_val = math.log(math.exp(1 - DEFAULT_MIN_DERIVATIVE) - 1)
    edge = DEFAULT_MIN_DERIVATIVE + F.softplus(
        torch.tensor(pad_val, dtype=torch.float32, device=y.device))
    edge = edge.expand(derivs[..., :1].shape)
    derivs = torch.cat([edge, derivs, edge], dim=-1)

    heights = torch.softmax(unnorm_heights, dim=-1)
    heights = DEFAULT_MIN_BIN_HEIGHT + (1 - DEFAULT_MIN_BIN_HEIGHT * num_bins) * heights
    cumheights = F.pad(torch.cumsum(heights, dim=-1), (1, 0))
    cumheights = (2 * tail_bound) * cumheights - tail_bound
    heights = cumheights[..., 1:] - cumheights[..., :-1]

    y_in = torch.clamp(y, -tail_bound, tail_bound)
    # locate the bin by cumheights (inverse mode)
    idx = (y_in[..., None] >= cumheights[..., :-1]).sum(dim=-1) - 1
    idx = torch.clamp(idx, 0, num_bins - 1)[..., None]

    def gather(t):
        return torch.gather(t, -1, idx)[..., 0]

    in_cumwidths = gather(cumwidths[..., :-1])
    in_widths = gather(widths)
    in_cumheights = gather(cumheights[..., :-1])
    in_heights = gather(heights)
    in_delta = in_heights / in_widths
    in_d = gather(derivs[..., :-1])
    in_d_plus = gather(derivs[..., 1:])

    # solve the quadratic for xi (Durkan et al. eq. 6-8, inverse)
    rel_y = y_in - in_cumheights
    term = rel_y * (in_d + in_d_plus - 2 * in_delta)
    a = in_heights * (in_delta - in_d) + term
    b = in_heights * in_d - term
    c = -in_delta * rel_y
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    xi = torch.clamp((2 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
    x_val = xi * in_widths + in_cumwidths

    # log|det d y / d x| (forward direction)
    denom = in_delta + (in_d + in_d_plus - 2 * in_delta) * xi * (1 - xi)
    nom = in_delta ** 2 * (
        in_d_plus * xi ** 2 + 2 * in_delta * xi * (1 - xi) + in_d * (1 - xi) ** 2)
    logabsdet = (torch.log(torch.clamp(nom, min=1e-12))
                 - 2 * torch.log(torch.clamp(denom, min=1e-12)))

    x_out = torch.where(inside, x_val, y)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return x_out, logabsdet
