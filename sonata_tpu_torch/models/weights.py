"""Carrying VITS parameters across: the JAX package's tree → ``nn.Module``.

The JAX package keeps a voice's parameters as nested dicts and lists of
arrays (``enc_p``, ``dp``, ``flow``, ``dec``, ``emb_g``).
:func:`params_from_numpy` turns that tree, as numpy arrays, into a
:class:`VitsModel` with the same keys, so the port's functions read
``p["enc_p"]["encoder"]["layers"][0]["attn"]["q"]`` as the reference reads
its dict.  Layouts:

- convolution ``[K, C_in, C_out]`` → ``[C_out, C_in, K]`` (depthwise
  ``[K, 1, C]`` → ``[C, 1, K]`` by the same transpose);
- transposed convolution (the decoder's ``ups``) ``[K, C_in, C_out]`` →
  ``ConvTranspose1d``'s ``[C_in, C_out, K]``;
- embeddings, relative-position tables, LayerNorm ``gamma``/``beta`` and
  the duration predictor's ``affine`` stay as they are;
- an int8 decoder conv (``w_q`` int8, ``w_scale`` float32 ``[1, 1,
  C_out]``, ``SONATA_DECODE_QUANT=int8``) → :class:`QConv`, both by the
  same transpose.

:func:`random_tree` builds a tree of the same shapes as the reference's
``vits.init_vits`` from a ``torch.Generator`` (random voices for tests,
benchmarks and the GPU smoke run); ``tashkeel.init_tashkeel`` draws the
tagger's encoder through the same :meth:`_Init.transformer`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import FailedToLoadResource
from .config import VitsHyperParams


class ParamTree(nn.Module):
    """A node of the parameter tree: children by key, as the reference's
    dicts, readable as ``p["key"]`` and testable with ``"key" in p``."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters


class Conv(nn.Module):
    """A convolution's parameters in torch layout (``weight``, ``bias``)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))


class QConv(nn.Module):
    """An int8 weight-only convolution: ``w_q`` (int8) and ``w_scale``
    (float32, one per output channel, broadcast against ``w_q``) in torch
    layout, and a float32 ``bias``.  :attr:`weight` rescales ``w_q`` to
    float32 at every read, so the device holds int8 weights and each conv
    gets its float32 weight right before it runs; activations are not
    quantized."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))

    @property
    def weight(self) -> torch.Tensor:
        return self.w_q.to(torch.float32) * self.w_scale


class VitsModel(ParamTree):
    """The whole voice: ``enc_p``, ``dp``, ``flow``, ``dec`` and, for a
    multi-speaker voice, ``emb_g``."""

    def __init__(self, hp: VitsHyperParams):
        super().__init__()
        self.hp = hp


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _build(node, path: tuple):
    if isinstance(node, dict):
        # [K, C_in, C_out] → ConvTranspose1d [C_in, C_out, K] for the
        # decoder's upsampling stack, Conv1d [C_out, C_in, K] otherwise
        axes = (1, 2, 0) if "ups" in path else (2, 1, 0)
        bias = _tensor(node["b"]) if "b" in node else None
        if "w_q" in node:
            if "dec" not in path:
                raise FailedToLoadResource(
                    f"int8 weights outside the decoder ({'/'.join(path)})")
            w_q = np.asarray(node["w_q"], np.int8).transpose(axes)
            scale = np.asarray(node["w_scale"], np.float32).transpose(axes)
            return QConv(torch.from_numpy(np.ascontiguousarray(w_q)),
                         _tensor(scale), bias)
        if "w" in node:
            w = np.asarray(node["w"], np.float32).transpose(axes)
            return Conv(_tensor(w), bias)
        tree = ParamTree()
        _fill(tree, node, path)
        return tree
    if isinstance(node, (list, tuple)):
        return nn.ModuleList(_build(v, path + (str(i),))
                             for i, v in enumerate(node))
    return nn.Parameter(_tensor(node), requires_grad=False)


def _fill(tree: ParamTree, node: dict, path: tuple) -> None:
    for key, value in node.items():
        child = _build(value, path + (key,))
        if isinstance(child, nn.Parameter):
            tree.register_parameter(key, child)
        else:
            tree.add_module(key, child)


def fill_tree(module: ParamTree, tree: dict) -> ParamTree:
    """Register a reference parameter tree (numpy leaves) on ``module``,
    key by key, in torch layouts; returns ``module``."""
    _fill(module, tree, ())
    return module


def params_from_numpy(tree: dict, hp: VitsHyperParams) -> VitsModel:
    """The reference's parameter tree (numpy leaves, same nested keys) →
    a :class:`VitsModel` on the CPU.  Move it with ``.to(device)``."""
    return fill_tree(VitsModel(hp), tree)


def build_subtree(tree, path: tuple):
    """One subtree of a reference parameter tree (e.g. the decoder at
    ``("dec",)``) → its module, in torch layouts."""
    return _build(tree, path)


def params_to_numpy(module: nn.Module, path: tuple = ()):
    """The inverse of :func:`params_from_numpy`: a parameter module (on
    any device) → the reference's tree, numpy leaves in its layouts."""
    if isinstance(module, (Conv, QConv)):
        # the inverse transposes of _build's: [C_in, C_out, K] and
        # [C_out, C_in, K] back to [K, C_in, C_out]
        axes = (2, 0, 1) if "ups" in path else (2, 1, 0)

        def back(t):
            return np.ascontiguousarray(
                t.detach().cpu().numpy().transpose(axes))

        node = ({"w_q": back(module.w_q), "w_scale": back(module.w_scale)}
                if isinstance(module, QConv) else {"w": back(module.weight)})
        if module.bias is not None:
            node["b"] = module.bias.detach().cpu().numpy()
        return node
    if isinstance(module, nn.ModuleList):
        return [params_to_numpy(m, path + (str(i),))
                for i, m in enumerate(module)]
    tree = {k: p.detach().cpu().numpy()
            for k, p in module.named_parameters(recurse=False)}
    for key, child in module.named_children():
        tree[key] = params_to_numpy(child, path + (key,))
    return tree


# ---------------------------------------------------------------------------
# random voices: the shapes of vits.init_vits, drawn from a torch.Generator
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def normal(self, shape, std):
        return (torch.randn(shape, generator=self.gen) * std).numpy()

    def uniform(self, shape, bound):
        u = torch.rand(shape, generator=self.gen)
        return ((u * 2 - 1) * bound).numpy()

    def conv(self, k, c_in, c_out):
        # fan-in scaling, like torch's conv defaults and the reference
        bound = 1.0 / math.sqrt(c_in * k)
        return {"w": self.uniform((k, c_in, c_out), bound),
                "b": self.uniform((c_out,), bound)}

    @staticmethod
    def layer_norm(c):
        return {"gamma": np.ones((c,), np.float32),
                "beta": np.zeros((c,), np.float32)}

    @staticmethod
    def zero_conv(k, c_in, c_out):
        return {"w": np.zeros((k, c_in, c_out), np.float32),
                "b": np.zeros((c_out,), np.float32)}

    def transformer(self, *, channels, filter_channels, n_heads, n_layers,
                    kernel, window):
        """The tree of the reference's ``modules.init_transformer``: per
        layer the attention's 1×1 ``q``/``k``/``v``/``o`` and its
        relative-position tables, two layer norms and the FFN's convs."""
        h, head = channels, channels // n_heads
        return {"layers": [{
            "attn": {"q": self.conv(1, h, h), "k": self.conv(1, h, h),
                     "v": self.conv(1, h, h), "o": self.conv(1, h, h),
                     "emb_rel_k": self.normal((1, 2 * window + 1, head),
                                              head ** -0.5),
                     "emb_rel_v": self.normal((1, 2 * window + 1, head),
                                              head ** -0.5)},
            "ln1": self.layer_norm(h),
            "ffn": {"c1": self.conv(kernel, h, filter_channels),
                    "c2": self.conv(kernel, filter_channels, h)},
            "ln2": self.layer_norm(h),
        } for _ in range(n_layers)]}

    def dds_conv(self, channels, kernel, n_layers):
        return {"layers": [{
            "dw": {"w": self.normal((kernel, 1, channels),
                                    1.0 / math.sqrt(kernel)),
                   "b": np.zeros((channels,), np.float32)},
            "pw": self.conv(1, channels, channels),
            "ln1": self.layer_norm(channels),
            "ln2": self.layer_norm(channels),
        } for _ in range(n_layers)]}


def random_tree(hp: VitsHyperParams, *, n_vocab: int, n_speakers: int = 1,
                generator: torch.Generator) -> dict:
    """A parameter tree with the shapes and zero-inits of the reference's
    ``vits.init_vits`` (its draws are not the reference's bits)."""
    r = _Init(generator)
    gin = hp.gin_channels if n_speakers > 1 else 0
    h = hp.hidden_channels
    enc_p = {
        "emb": r.normal((n_vocab, h), h ** -0.5),
        "encoder": r.transformer(
            channels=h, filter_channels=hp.filter_channels,
            n_heads=hp.n_heads, n_layers=hp.n_layers,
            kernel=hp.kernel_size, window=hp.attn_window),
        "proj": r.conv(1, h, 2 * hp.inter_channels),
    }
    filt = hp.dp_filter_channels
    n_out = 3 * hp.dp_num_bins - 1
    dp = {
        "pre": r.conv(1, h, filt),
        "convs": r.dds_conv(filt, hp.dp_kernel_size, 3),
        "proj": r.conv(1, filt, filt),
        "affine": {"m": np.zeros((2,), np.float32),
                   "logs": np.zeros((2,), np.float32)},
        # zero-init proj → identity start, as the reference
        "flows": [{"pre": r.conv(1, 1, filt),
                   "convs": r.dds_conv(filt, hp.dp_kernel_size, 3),
                   "proj": r.zero_conv(1, filt, n_out)}
                  for _ in range(hp.dp_n_flows)],
    }
    if gin:
        dp["cond"] = r.conv(1, gin, filt)
    half = hp.inter_channels // 2
    flow_layers = []
    for _ in range(hp.flow_n_layers):
        wn = {"in": [r.conv(hp.flow_kernel_size, h, 2 * h)
                     for _ in range(hp.flow_wn_layers)],
              "res_skip": [r.conv(1, h, 2 * h if i < hp.flow_wn_layers - 1
                                  else h)
                           for i in range(hp.flow_wn_layers)]}
        if gin:
            wn["cond"] = r.conv(1, gin, 2 * h * hp.flow_wn_layers)
        flow_layers.append({"pre": r.conv(1, half, h), "wn": wn,
                            "post": r.zero_conv(1, h, half)})
    ch0 = hp.upsample_initial_channel
    dec = {"conv_pre": r.conv(7, hp.inter_channels, ch0), "ups": [],
           "resblocks": [],
           "conv_post": r.conv(7, ch0 // (2 ** len(hp.upsample_rates)), 1)}
    if gin:
        dec["cond"] = r.conv(1, gin, ch0)
    for i, k_up in enumerate(hp.upsample_kernel_sizes):
        c_in, c_out = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        dec["ups"].append(r.conv(k_up, c_in, c_out))
        for k_res, dils in zip(hp.resblock_kernel_sizes,
                               hp.resblock_dilation_sizes):
            dec["resblocks"].append({
                "convs1": [r.conv(k_res, c_out, c_out) for _ in dils],
                "convs2": [r.conv(k_res, c_out, c_out) for _ in dils]})
    tree = {"enc_p": enc_p, "dp": dp, "flow": {"layers": flow_layers},
            "dec": dec}
    if n_speakers > 1:
        tree["emb_g"] = r.normal((n_speakers, hp.gin_channels), 0.02)
    return tree
