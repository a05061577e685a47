"""Import Piper/VITS torch checkpoints into the native param pytree.

The reference never touches checkpoints — it consumes exported ONNX.  We
support the richer source too: Piper training checkpoints (`.ckpt`
pytorch-lightning) and plain state-dict `.pt/.pth` files, mapped name-by-name
from upstream VITS module naming (``enc_p.encoder.attn_layers.0.conv_q`` …)
onto our pytree, with torch→NTC layout transposition and weight-norm fusion.

``params_to_state_dict`` is the exact inverse — used both to export native
voices back to the torch naming convention and as the round-trip importer
test (no real checkpoint needed).

The tree keeps the JAX package's layout (numpy leaves, convolutions
``[K, C_in, C_out]``); :func:`.weights.params_from_numpy` turns it into the
port's :class:`~.weights.VitsModel`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..core import FailedToLoadResource
from .config import VitsHyperParams

# lightning/piper wrap the generator under one of these prefixes
_PREFIXES = ("model_g.", "net_g.", "generator.", "model.", "")


def _t_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv1d [C_out, C_in, K] → ours [K, C_in, C_out]."""
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _t_conv_back(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _t_tconv(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose1d [C_in, C_out, K] → ours [K, C_in, C_out]."""
    return np.ascontiguousarray(w.transpose(2, 0, 1))


def _t_tconv_back(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(1, 2, 0))


def _fuse_weight_norm(sd: dict, prefix: str) -> np.ndarray:
    """Return the effective conv weight, fusing weight_g/weight_v if the
    checkpoint still carries weight norm (piper removes it for the decoder
    before ONNX export but training ckpts keep it)."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    g = np.asarray(sd[f"{prefix}.weight_g"])
    v = np.asarray(sd[f"{prefix}.weight_v"])
    norm = np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


class _Reader:
    def __init__(self, sd: dict):
        self.sd = sd
        self.used: set[str] = set()

    def raw(self, name: str) -> np.ndarray:
        if name not in self.sd:
            raise FailedToLoadResource(f"checkpoint missing tensor: {name}")
        self.used.add(name)
        return np.asarray(self.sd[name], dtype=np.float32)

    def conv(self, prefix: str) -> dict:
        if f"{prefix}.weight" not in self.sd:
            for s in ("weight_g", "weight_v"):
                self.used.add(f"{prefix}.{s}")
        else:
            self.used.add(f"{prefix}.weight")
        w = _fuse_weight_norm(self.sd, prefix).astype(np.float32)
        return {"w": _t_conv(w), "b": self.raw(f"{prefix}.bias")}

    def tconv(self, prefix: str) -> dict:
        if f"{prefix}.weight" not in self.sd:
            for s in ("weight_g", "weight_v"):
                self.used.add(f"{prefix}.{s}")
        else:
            self.used.add(f"{prefix}.weight")
        w = _fuse_weight_norm(self.sd, prefix).astype(np.float32)
        return {"w": _t_tconv(w), "b": self.raw(f"{prefix}.bias")}

    def ln(self, prefix: str) -> dict:
        return {"gamma": self.raw(f"{prefix}.gamma").reshape(-1),
                "beta": self.raw(f"{prefix}.beta").reshape(-1)}


def state_dict_to_params(sd: dict, hp: VitsHyperParams, *, n_vocab: int,
                         n_speakers: int = 1) -> dict:
    """Map a (prefix-stripped) VITS generator state dict onto our pytree."""
    r = _Reader(sd)
    gin = n_speakers > 1

    # -- text encoder ------------------------------------------------------
    enc_layers = []
    for i in range(hp.n_layers):
        enc_layers.append({
            "attn": {
                "q": r.conv(f"enc_p.encoder.attn_layers.{i}.conv_q"),
                "k": r.conv(f"enc_p.encoder.attn_layers.{i}.conv_k"),
                "v": r.conv(f"enc_p.encoder.attn_layers.{i}.conv_v"),
                "o": r.conv(f"enc_p.encoder.attn_layers.{i}.conv_o"),
                "emb_rel_k": r.raw(f"enc_p.encoder.attn_layers.{i}.emb_rel_k"),
                "emb_rel_v": r.raw(f"enc_p.encoder.attn_layers.{i}.emb_rel_v"),
            },
            "ln1": r.ln(f"enc_p.encoder.norm_layers_1.{i}"),
            "ffn": {
                "c1": r.conv(f"enc_p.encoder.ffn_layers.{i}.conv_1"),
                "c2": r.conv(f"enc_p.encoder.ffn_layers.{i}.conv_2"),
            },
            "ln2": r.ln(f"enc_p.encoder.norm_layers_2.{i}"),
        })
    params: dict = {
        "enc_p": {
            "emb": r.raw("enc_p.emb.weight"),
            "encoder": {"layers": enc_layers},
            "proj": r.conv("enc_p.proj"),
        }
    }
    if params["enc_p"]["emb"].shape[0] != n_vocab:
        raise FailedToLoadResource(
            f"embedding table has {params['enc_p']['emb'].shape[0]} symbols, "
            f"config says {n_vocab}")

    # -- stochastic duration predictor -------------------------------------
    def dds(prefix: str, n: int) -> dict:
        layers = []
        for i in range(n):
            layers.append({
                "dw": {"w": _t_conv(_fuse_weight_norm(sd, f"{prefix}.convs_sep.{i}")
                                    .astype(np.float32)),
                       "b": r.raw(f"{prefix}.convs_sep.{i}.bias")},
                "pw": r.conv(f"{prefix}.convs_1x1.{i}"),
                "ln1": r.ln(f"{prefix}.norms_1.{i}"),
                "ln2": r.ln(f"{prefix}.norms_2.{i}"),
            })
            r.used.add(f"{prefix}.convs_sep.{i}.weight")
        return {"layers": layers}

    dp: dict = {
        "pre": r.conv("dp.pre"),
        "convs": dds("dp.convs", 3),
        "proj": r.conv("dp.proj"),
        "affine": {"m": r.raw("dp.flows.0.m").reshape(-1),
                   "logs": r.raw("dp.flows.0.logs").reshape(-1)},
        "flows": [],
    }
    for i in range(hp.dp_n_flows):
        t_idx = 2 * i + 1  # ConvFlow positions in torch ModuleList (Flips interleave)
        dp["flows"].append({
            "pre": r.conv(f"dp.flows.{t_idx}.pre"),
            "convs": dds(f"dp.flows.{t_idx}.convs", 3),
            "proj": r.conv(f"dp.flows.{t_idx}.proj"),
        })
    if gin and "dp.cond.weight" in sd:
        dp["cond"] = r.conv("dp.cond")
    params["dp"] = dp

    # -- residual coupling flow --------------------------------------------
    flow_layers = []
    for i in range(hp.flow_n_layers):
        t_idx = 2 * i  # Flip modules interleave at odd indices
        wn_prefix = f"flow.flows.{t_idx}.enc"
        wn = {
            "in": [r.conv(f"{wn_prefix}.in_layers.{j}")
                   for j in range(hp.flow_wn_layers)],
            "res_skip": [r.conv(f"{wn_prefix}.res_skip_layers.{j}")
                         for j in range(hp.flow_wn_layers)],
        }
        if gin and f"{wn_prefix}.cond_layer.bias" in sd:
            wn["cond"] = r.conv(f"{wn_prefix}.cond_layer")
        flow_layers.append({
            "pre": r.conv(f"flow.flows.{t_idx}.pre"),
            "wn": wn,
            "post": r.conv(f"flow.flows.{t_idx}.post"),
        })
    params["flow"] = {"layers": flow_layers}

    # -- HiFi-GAN decoder ---------------------------------------------------
    n_kernels = len(hp.resblock_kernel_sizes)
    dec: dict = {
        "conv_pre": r.conv("dec.conv_pre"),
        "ups": [r.tconv(f"dec.ups.{i}") for i in range(len(hp.upsample_rates))],
        "resblocks": [],
        "conv_post": r.conv("dec.conv_post"),
    }
    for i in range(len(hp.upsample_rates)):
        for j in range(n_kernels):
            k = i * n_kernels + j
            n_d = len(hp.resblock_dilation_sizes[j])
            dec["resblocks"].append({
                "convs1": [r.conv(f"dec.resblocks.{k}.convs1.{d}")
                           for d in range(n_d)],
                "convs2": [r.conv(f"dec.resblocks.{k}.convs2.{d}")
                           for d in range(n_d)],
            })
    if gin and "dec.cond.weight" in sd:
        dec["cond"] = r.conv("dec.cond")
    params["dec"] = dec

    if gin:
        params["emb_g"] = r.raw("emb_g.weight")

    # diagnostic: report generator tensors the mapping did not consume
    # (training-only heads like enc_q.* / dp.post_* are expected leftovers)
    leftovers = [k for k in sd if k not in r.used
                 and not k.startswith(("enc_q.", "dp.post"))]
    if leftovers:
        import logging

        logging.getLogger("sonata.import").debug(
            "unmapped checkpoint tensors: %s",
            ", ".join(sorted(leftovers)[:20]))

    return params


def params_to_state_dict(params: dict, hp: VitsHyperParams) -> dict:
    """Inverse of :func:`state_dict_to_params` (torch naming, torch layout)."""
    sd: dict[str, np.ndarray] = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.weight"] = _t_conv_back(np.asarray(p["w"]))
        sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def put_tconv(prefix, p):
        sd[f"{prefix}.weight"] = _t_tconv_back(np.asarray(p["w"]))
        sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def put_ln(prefix, p):
        sd[f"{prefix}.gamma"] = np.asarray(p["gamma"])
        sd[f"{prefix}.beta"] = np.asarray(p["beta"])

    enc = params["enc_p"]
    sd["enc_p.emb.weight"] = np.asarray(enc["emb"])
    for i, layer in enumerate(enc["encoder"]["layers"]):
        for name in ("q", "k", "v", "o"):
            put_conv(f"enc_p.encoder.attn_layers.{i}.conv_{name}",
                     layer["attn"][name])
        sd[f"enc_p.encoder.attn_layers.{i}.emb_rel_k"] = np.asarray(
            layer["attn"]["emb_rel_k"])
        sd[f"enc_p.encoder.attn_layers.{i}.emb_rel_v"] = np.asarray(
            layer["attn"]["emb_rel_v"])
        put_ln(f"enc_p.encoder.norm_layers_1.{i}", layer["ln1"])
        put_conv(f"enc_p.encoder.ffn_layers.{i}.conv_1", layer["ffn"]["c1"])
        put_conv(f"enc_p.encoder.ffn_layers.{i}.conv_2", layer["ffn"]["c2"])
        put_ln(f"enc_p.encoder.norm_layers_2.{i}", layer["ln2"])
    put_conv("enc_p.proj", enc["proj"])

    dp = params["dp"]
    put_conv("dp.pre", dp["pre"])
    put_conv("dp.proj", dp["proj"])
    sd["dp.flows.0.m"] = np.asarray(dp["affine"]["m"]).reshape(-1, 1)
    sd["dp.flows.0.logs"] = np.asarray(dp["affine"]["logs"]).reshape(-1, 1)

    def put_dds(prefix, p):
        for i, layer in enumerate(p["layers"]):
            sd[f"{prefix}.convs_sep.{i}.weight"] = _t_conv_back(
                np.asarray(layer["dw"]["w"]))
            sd[f"{prefix}.convs_sep.{i}.bias"] = np.asarray(layer["dw"]["b"])
            put_conv(f"{prefix}.convs_1x1.{i}", layer["pw"])
            put_ln(f"{prefix}.norms_1.{i}", layer["ln1"])
            put_ln(f"{prefix}.norms_2.{i}", layer["ln2"])

    put_dds("dp.convs", dp["convs"])
    for i, flow in enumerate(dp["flows"]):
        t_idx = 2 * i + 1
        put_conv(f"dp.flows.{t_idx}.pre", flow["pre"])
        put_dds(f"dp.flows.{t_idx}.convs", flow["convs"])
        put_conv(f"dp.flows.{t_idx}.proj", flow["proj"])
    if "cond" in dp:
        put_conv("dp.cond", dp["cond"])

    for i, layer in enumerate(params["flow"]["layers"]):
        t_idx = 2 * i
        put_conv(f"flow.flows.{t_idx}.pre", layer["pre"])
        put_conv(f"flow.flows.{t_idx}.post", layer["post"])
        for j, c in enumerate(layer["wn"]["in"]):
            put_conv(f"flow.flows.{t_idx}.enc.in_layers.{j}", c)
        for j, c in enumerate(layer["wn"]["res_skip"]):
            put_conv(f"flow.flows.{t_idx}.enc.res_skip_layers.{j}", c)
        if "cond" in layer["wn"]:
            put_conv(f"flow.flows.{t_idx}.enc.cond_layer", layer["wn"]["cond"])

    dec = params["dec"]
    put_conv("dec.conv_pre", dec["conv_pre"])
    put_conv("dec.conv_post", dec["conv_post"])
    for i, up in enumerate(dec["ups"]):
        put_tconv(f"dec.ups.{i}", up)
    for k, block in enumerate(dec["resblocks"]):
        for d, c in enumerate(block["convs1"]):
            put_conv(f"dec.resblocks.{k}.convs1.{d}", c)
        for d, c in enumerate(block["convs2"]):
            put_conv(f"dec.resblocks.{k}.convs2.{d}", c)
    if "cond" in dec:
        put_conv("dec.cond", dec["cond"])

    if "emb_g" in params:
        sd["emb_g.weight"] = np.asarray(params["emb_g"])
    return sd


def strip_prefix(sd: dict) -> dict:
    """Unwrap lightning/piper module prefixes down to generator naming."""
    for prefix in _PREFIXES:
        if any(k.startswith(prefix + "enc_p.") for k in sd):
            n = len(prefix)
            return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def import_torch_checkpoint(path: Union[str, Path], hp: VitsHyperParams, *,
                            n_vocab: int, n_speakers: int = 1) -> dict:
    try:
        obj = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in obj.items()}
    return state_dict_to_params(strip_prefix(sd), hp, n_vocab=n_vocab,
                                n_speakers=n_speakers)
