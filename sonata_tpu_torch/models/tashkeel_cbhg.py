"""CBHG tashkeel tagger, the architecture family of libtashkeel's bundled
ONNX model, on PyTorch.

Port of ``sonata_tpu/models/tashkeel_cbhg.py``.  The reference auto-creates
a libtashkeel inference engine whenever a voice's eSpeak language is ``ar``
(``crates/sonata/models/piper/src/lib.rs:63-77,270-281,321-333``);
libtashkeel runs a CBHG-style sequence tagger (character embedding → conv
bank → max-pool → conv projections → residual → highway stack →
bidirectional GRU → bidirectional LSTMs → linear classifier) from the
Arabic diacritization literature.

Two halves, as in the JAX package:

- **Import** (numpy, copied from the JAX package): a torch state dict or an
  ONNX export, name-preserving or constant-folded, becomes the JAX
  package's parameter tree (``embedding``, ``bank``, ``projs``,
  ``pre_highway``, ``highways``, ``gru``, ``post``, ``out``), with the
  hyperparameters inferred from the weights present and inference-mode
  BatchNorm folded into the preceding convolution.
- **Forward**: :class:`CBHGTagger`, an ``nn.Module`` built from that tree,
  computes the JAX package's ``apply_cbhg``.  Its convolutions take the
  asymmetric "same" padding ``(k // 2, (k - 1) // 2)`` through ``F.pad``;
  its recurrences are cuDNN's ``nn.GRU`` (linear-before-reset, as the
  reference's cell) and ``nn.LSTM``, fed the state-dict layout.  Called
  with ``lengths=None`` it runs the whole row (the wrapper's call: one
  chunk, one row, at its exact length); with ``lengths`` it masks every
  convolution input beyond them and packs the recurrences, so the reverse
  direction starts at each row's last valid step, as the reference's
  ``_flip_valid`` does.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..core import FailedToLoadResource
from ..device import resolve_device
from .tashkeel import DIACRITICS, _DEFAULT_VOCAB, strip_diacritics, \
    tag_characters


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------

def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(a, dtype=np.float32)),
                        requires_grad=False)


def _to_linear(p: dict, bias: bool = True) -> nn.Linear:
    """A tree linear (``w [in, out]``, ``b``) → ``nn.Linear``."""
    w = np.asarray(p["w"]).T
    lin = nn.Linear(w.shape[1], w.shape[0], bias=bias)
    lin.weight = _param(w)
    if bias:
        lin.bias = _param(p["b"])
    return lin


def _to_conv(p: dict) -> nn.Conv1d:
    """A tree convolution (``w [K, C_in, C_out]``, ``b``) → ``nn.Conv1d``
    holding torch's ``[C_out, C_in, K]``; padding is applied by the
    caller."""
    w = np.asarray(p["w"]).transpose(2, 1, 0)
    conv = nn.Conv1d(w.shape[1], w.shape[0], w.shape[2])
    conv.weight = _param(w)
    conv.bias = _param(p["b"])
    return conv


def _to_rnn(cls, p: dict) -> nn.RNNBase:
    """A tree recurrence (``fwd``/``bwd`` of ``w_ih [in, G*H]``,
    ``w_hh [H, G*H]``, ``b_ih``, ``b_hh``) → a bidirectional one-layer
    ``nn.GRU``/``nn.LSTM`` in the state-dict layout ``[G*H, in]``."""
    w_ih = np.asarray(p["fwd"]["w_ih"])
    rnn = cls(w_ih.shape[0], np.asarray(p["fwd"]["w_hh"]).shape[0],
              batch_first=True, bidirectional=True)
    with torch.no_grad():
        for suffix, tag in (("", "fwd"), ("_reverse", "bwd")):
            for name, key, transpose in (("weight_ih", "w_ih", True),
                                         ("weight_hh", "w_hh", True),
                                         ("bias_ih", "b_ih", False),
                                         ("bias_hh", "b_hh", False)):
                a = np.asarray(p[tag][key], dtype=np.float32)
                getattr(rnn, f"{name}_l0{suffix}").copy_(
                    torch.from_numpy(np.ascontiguousarray(
                        a.T if transpose else a)))
    return rnn.requires_grad_(False)


def _same_conv(x, conv: nn.Conv1d):
    """torch ``Conv1d(padding=k//2)`` then trim-to-T ≡ pad
    ``(k//2, (k-1)//2)``: ``x [B, C, T]`` → ``[B, C_out, T]``."""
    k = conv.weight.shape[-1]
    return F.conv1d(F.pad(x, (k // 2, (k - 1) // 2)), conv.weight, conv.bias)


class CBHGTagger(nn.Module):
    """The CBHG tagger's forward pass (the JAX package's ``apply_cbhg``)
    over parameters carried across from its tree (numpy leaves, as
    :func:`state_dict_to_cbhg` and :func:`cbhg_from_onnx` return it)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embedding = _param(tree["embedding"])
        self.prenet = nn.ModuleList(_to_linear(p)
                                    for p in tree.get("prenet") or [])
        self.bank = nn.ModuleList(_to_conv(p) for p in tree["bank"])
        self.projs = nn.ModuleList(_to_conv(p) for p in tree["projs"])
        ph = tree.get("pre_highway")
        self.pre_highway = (None if ph is None
                            else _to_linear(ph, bias=False))
        self.highways = nn.ModuleList(
            nn.ModuleDict({"H": _to_linear(hw["H"]),
                           "T": _to_linear(hw["T"])})
            for hw in tree["highways"])
        self.gru = _to_rnn(nn.GRU, tree["gru"])
        self.post = nn.ModuleList(_to_rnn(nn.LSTM, p) for p in tree["post"])
        self.out = _to_linear(tree["out"])

    def rnns(self) -> list:
        return [self.gru, *self.post]

    def forward(self, ids, lengths=None):
        """``ids [B, T]`` → diacritic logits ``[B, T, n_targets]``.

        ``lengths=None``: every row is valid to ``T``.  Otherwise ``[B]``
        valid lengths, each ≥ 1: positions beyond them are zeroed before
        every convolution and in the output, and the recurrences are
        packed (one copy of ``lengths`` to the host)."""
        mask = None
        if lengths is not None:
            t = torch.arange(ids.shape[1], device=ids.device)
            mask = (t[None, :] < lengths[:, None]).to(torch.float32)[..., None]

        def ntc(x):  # mask [B, T, C]
            return x if mask is None else x * mask

        def nct(x):  # mask [B, C, T]
            return x if mask is None else x * mask.transpose(1, 2)

        x = ntc(self.embedding[ids])
        for lin in self.prenet:
            x = ntc(torch.relu(lin(x)))

        # conv bank: kernel sizes 1..K, BN folded into weight and bias
        xt = x.transpose(1, 2)
        y = nct(torch.cat([torch.relu(_same_conv(xt, c)) for c in self.bank],
                          dim=1))
        # max-pool k=2 stride=1 (left pad -inf ⇒ out[t] = max(y[t-1], y[t]))
        prev = F.pad(y[:, :, :-1], (1, 0), value=float("-inf"))
        y = nct(torch.maximum(y, prev))
        # conv projections (ReLU on all but the last), BN folded
        for i, c in enumerate(self.projs):
            y = _same_conv(y, c)
            if i + 1 < len(self.projs):
                y = torch.relu(y)
            y = nct(y)
        y = y.transpose(1, 2)

        if self.pre_highway is not None:
            y = self.pre_highway(y)
        y = ntc(y + x)  # residual onto the (pre-)bank input
        for hw in self.highways:
            h = torch.relu(hw["H"](y))
            gate = torch.sigmoid(hw["T"](y))
            y = ntc(h * gate + y * (1.0 - gate))

        for rnn in self.rnns():
            y = ntc(_bidi(rnn, y, lengths))
        return ntc(self.out(y))


def _bidi(rnn: nn.RNNBase, x, lengths):
    """Both directions of ``rnn`` over ``x [B, T, C]``, features
    concatenated; the reverse direction starts at each row's last valid
    step."""
    if lengths is None:
        return rnn(x)[0]
    packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)
    out, _ = rnn(packed)
    return pad_packed_sequence(out, batch_first=True,
                               total_length=x.shape[1])[0]


# ---------------------------------------------------------------------------
# weight import (state-dict names → pytree), BN folding
# ---------------------------------------------------------------------------

_BN_EPS = 1e-5


def _fold_bn(w_oik: np.ndarray, bias: Optional[np.ndarray],
             gamma, beta, mean, var) -> tuple[np.ndarray, np.ndarray]:
    """Fold inference-mode BatchNorm into the preceding conv.

    ``w_oik`` is torch layout ``[Cout, Cin, K]``; returns NTC layout
    ``[K, Cin, Cout]`` plus a folded bias.
    """
    scale = gamma / np.sqrt(var + _BN_EPS)  # [Cout]
    w = w_oik * scale[:, None, None]
    b = (bias if bias is not None else 0.0) * scale + beta - mean * scale
    return np.transpose(w, (2, 1, 0)).astype(np.float32), b.astype(np.float32)


def _linear(sd, name) -> dict:
    w = sd[f"{name}.weight"]
    out = {"w": np.ascontiguousarray(w.T).astype(np.float32)}
    if f"{name}.bias" in sd:
        out["b"] = sd[f"{name}.bias"].astype(np.float32)
    else:
        out["b"] = np.zeros(w.shape[0], np.float32)
    return out


def _rnn_direction(sd, prefix: str, suffix: str) -> dict:
    try:
        w_ih = sd[f"{prefix}.weight_ih_l0{suffix}"].astype(np.float32)
        w_hh = sd[f"{prefix}.weight_hh_l0{suffix}"].astype(np.float32)
    except KeyError as e:
        raise FailedToLoadResource(
            f"tashkeel CBHG import: missing recurrent weights "
            f"{prefix}.*_l0{suffix} — unidirectional exports are not part "
            "of the CBHG family (its recurrences are bidirectional)") from e
    b_ih = sd.get(f"{prefix}.bias_ih_l0{suffix}")
    b_hh = sd.get(f"{prefix}.bias_hh_l0{suffix}")
    G = w_ih.shape[0]
    return {
        "w_ih": np.ascontiguousarray(w_ih.T),
        "w_hh": np.ascontiguousarray(w_hh.T),
        "b_ih": (b_ih if b_ih is not None else np.zeros(G)).astype(
            np.float32),
        "b_hh": (b_hh if b_hh is not None else np.zeros(G)).astype(
            np.float32),
    }


def _strip_wrappers(sd: dict) -> dict:
    """Drop common wrapper prefixes (``model.``, ``cbhg_model.``,
    ``module.``) when every key carries the same one."""
    for prefix in ("model.", "cbhg_model.", "module."):
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def state_dict_to_cbhg(sd: dict) -> dict:
    """Map a torch CBHG state dict (or ONNX initializers preserving those
    names) onto the JAX package's ``apply_cbhg`` tree (numpy leaves).  Hyperparameters are inferred
    from the keys/shapes present."""
    sd = _strip_wrappers({k: np.asarray(v) for k, v in sd.items()})
    if "embedding.weight" not in sd:
        raise FailedToLoadResource(
            "tashkeel CBHG import: no 'embedding.weight' initializer "
            f"(found {sorted(sd)[:8]}…)")
    params: dict = {"embedding": sd["embedding.weight"].astype(np.float32)}

    # optional prenet: prenet.layers.{i}.weight or prenet.fc{i}.weight
    prenet = []
    for i in range(8):
        for cand in (f"prenet.layers.{i}", f"prenet.fc{i + 1}"):
            if f"{cand}.weight" in sd:
                prenet.append(_linear(sd, cand))
                break
    params["prenet"] = prenet

    def conv_block(base: str) -> Optional[dict]:
        for conv_name in (f"{base}.conv1d", f"{base}.conv", base):
            if f"{conv_name}.weight" in sd:
                break
        else:
            return None
        w = sd[f"{conv_name}.weight"].astype(np.float32)
        bias = sd.get(f"{conv_name}.bias")
        for bn_name in (f"{base}.bn", f"{base}.batch_norm"):
            if f"{bn_name}.weight" in sd:
                wf, bf = _fold_bn(
                    w, bias, sd[f"{bn_name}.weight"].astype(np.float32),
                    sd[f"{bn_name}.bias"].astype(np.float32),
                    sd[f"{bn_name}.running_mean"].astype(np.float32),
                    sd[f"{bn_name}.running_var"].astype(np.float32))
                return {"w": wf, "b": bf}
        b = (bias if bias is not None else np.zeros(w.shape[0])).astype(
            np.float32)
        return {"w": np.transpose(w, (2, 1, 0)).copy(), "b": b}

    bank = []
    for i in range(64):
        blk = conv_block(f"cbhg.conv1d_banks.{i}")
        if blk is None:
            break
        bank.append(blk)
    if not bank:
        raise FailedToLoadResource(
            "tashkeel CBHG import: no conv bank (cbhg.conv1d_banks.*)")
    params["bank"] = bank

    projs = []
    for i in range(16):
        blk = conv_block(f"cbhg.conv1d_projections.{i}")
        if blk is None:
            break
        projs.append(blk)
    params["projs"] = projs

    if "cbhg.pre_highway.weight" in sd:
        w = sd["cbhg.pre_highway.weight"].astype(np.float32)
        params["pre_highway"] = {"w": np.ascontiguousarray(w.T)}
    else:
        params["pre_highway"] = None

    highways = []
    for i in range(16):
        if f"cbhg.highways.{i}.H.weight" not in sd:
            break
        highways.append({"H": _linear(sd, f"cbhg.highways.{i}.H"),
                         "T": _linear(sd, f"cbhg.highways.{i}.T")})
    params["highways"] = highways

    params["gru"] = {"fwd": _rnn_direction(sd, "cbhg.gru", ""),
                     "bwd": _rnn_direction(sd, "cbhg.gru", "_reverse")}

    # post-CBHG recurrent stack: any other '<name>.weight_ih_l0' keys,
    # in sorted order (covers post_cbhg.{i}./lstm./layers.{i}. variants)
    post = []
    seen = set()
    for key in sorted(sd):
        m = re.match(r"(.+)\.weight_ih_l0$", key)
        if not m or m.group(1) == "cbhg.gru" or m.group(1) in seen:
            continue
        seen.add(m.group(1))
        post.append({"fwd": _rnn_direction(sd, m.group(1), ""),
                     "bwd": _rnn_direction(sd, m.group(1), "_reverse")})
    params["post"] = post

    for out_name in ("projections", "fc", "out", "classifier"):
        if f"{out_name}.weight" in sd:
            params["out"] = _linear(sd, out_name)
            break
    else:
        raise FailedToLoadResource(
            "tashkeel CBHG import: no output projection "
            "(projections/fc/out/classifier)")
    return params


# ---------------------------------------------------------------------------
# ONNX import, including recurrent weights folded into GRU/LSTM nodes
# ---------------------------------------------------------------------------

def _rnn_keys_from_nodes(inits: dict, nodes: list) -> dict:
    """Recover torch-style recurrent weight entries from ONNX GRU/LSTM
    *nodes* when ``torch.onnx.export`` constant folding replaced the named
    parameter initializers with anonymous reordered constants.

    ONNX gate orders: GRU ``(z, r, h)`` vs torch ``(r, z, n)``; LSTM
    ``(i, o, f, c)`` vs torch ``(i, f, g, o)``.
    """
    out: dict = {}
    n_lstm = 0
    for node in nodes:
        op = node["op_type"]
        if op not in ("GRU", "LSTM"):
            continue
        ins = node["inputs"]
        if len(ins) < 3 or ins[1] not in inits or ins[2] not in inits:
            continue
        W, R = np.asarray(inits[ins[1]]), np.asarray(inits[ins[2]])
        B = (np.asarray(inits[ins[3]])
             if len(ins) > 3 and ins[3] in inits else None)
        n_gates = 3 if op == "GRU" else 4
        H = W.shape[1] // n_gates
        if op == "GRU":
            if node["attrs"].get("linear_before_reset", 0) == 0:
                raise FailedToLoadResource(
                    "tashkeel CBHG import: GRU node without "
                    "linear_before_reset — not a torch export; unsupported")
            reorder = np.r_[H:2 * H, 0:H, 2 * H:3 * H]  # (z,r,h) → (r,z,n)
            prefix = "cbhg.gru"
        else:
            # (i,o,f,c) → (i,f,g,o)
            reorder = np.r_[0:H, 2 * H:3 * H, 3 * H:4 * H, H:2 * H]
            prefix = f"post_rnn.{n_lstm}"
            n_lstm += 1
        dirs = [""]
        if node["attrs"].get("direction") == "bidirectional" or W.shape[0] == 2:
            dirs = ["", "_reverse"]
        for d, suffix in enumerate(dirs):
            out[f"{prefix}.weight_ih_l0{suffix}"] = W[d][reorder]
            out[f"{prefix}.weight_hh_l0{suffix}"] = R[d][reorder]
            if B is not None:
                nb = n_gates * H
                out[f"{prefix}.bias_ih_l0{suffix}"] = B[d][:nb][reorder]
                out[f"{prefix}.bias_hh_l0{suffix}"] = B[d][nb:][reorder]
    return out


def _folded_linears_from_nodes(inits: dict, nodes: list) -> dict:
    """Recover ``<base>.weight`` for Linear layers whose weights were
    constant-folded into anonymous ``onnx::MatMul_*`` tensors.

    The bias initializer keeps its name, so a ``MatMul(x, W) → Add(bias)``
    (or fused ``Gemm``) pair identifies the layer: the anonymous ``W`` is
    the torch weight pre-transposed to ``[in, out]``.
    """
    out: dict = {}
    produced_by = {o: n for n in nodes for o in n["outputs"]}
    for n in nodes:
        if n["op_type"] == "Gemm" and len(n["inputs"]) >= 3:
            w_name, b_name = n["inputs"][1], n["inputs"][2]
            if (b_name in inits and b_name.endswith(".bias")
                    and w_name in inits and not b_name.startswith("onnx::")):
                w = np.asarray(inits[w_name])
                if not n["attrs"].get("transB", 0):
                    w = w.T  # → torch [out, in]
                out[b_name[:-5] + ".weight"] = w
            continue
        if n["op_type"] != "Add" or len(n["inputs"]) != 2:
            continue
        bias_name = next(
            (i for i in n["inputs"]
             if i in inits and i.endswith(".bias")
             and not i.startswith("onnx::")), None)
        if bias_name is None:
            continue
        other = (n["inputs"][1] if n["inputs"][0] == bias_name
                 else n["inputs"][0])
        mm = produced_by.get(other)
        if mm is None or mm["op_type"] != "MatMul" or len(mm["inputs"]) != 2:
            continue
        w_name = mm["inputs"][1]
        if w_name in inits and w_name not in (bias_name,):
            w = np.asarray(inits[w_name])
            if w.ndim == 2:
                out[bias_name[:-5] + ".weight"] = np.ascontiguousarray(w.T)
    return out


def cbhg_from_onnx(path) -> dict:
    """Load CBHG params from an ONNX export (name-preserving or
    constant-folded)."""
    from .import_onnx import read_onnx_graph, resolve_identity_aliases

    inits, nodes = read_onnx_graph(path)
    inits = resolve_identity_aliases(inits, nodes)
    sd = {k: v for k, v in inits.items()}
    stripped = _strip_wrappers(dict(sd))
    if not any(k.endswith("gru.weight_ih_l0") for k in stripped):
        sd.update(_rnn_keys_from_nodes(inits, nodes))
    for name, w in _folded_linears_from_nodes(inits, nodes).items():
        sd.setdefault(name, w)
    # bias-less pre_highway can't be recovered via its bias; when the
    # projection width differs from the embedding width one is required —
    # match the unique anonymous [proj_out, emb] MatMul weight
    if "cbhg.pre_highway.weight" not in sd and "embedding.weight" in sd:
        emb_dim = int(np.asarray(sd["embedding.weight"]).shape[1])
        last_proj = None
        for i in range(16):
            key = f"cbhg.conv1d_projections.{i}.conv1d.weight"
            if key in sd:
                last_proj = int(np.asarray(sd[key]).shape[0])
        if last_proj is not None and last_proj != emb_dim:
            cands = {
                n["inputs"][1]
                for n in nodes
                if n["op_type"] == "MatMul" and len(n["inputs"]) == 2
                and n["inputs"][1] in inits
                and np.asarray(inits[n["inputs"][1]]).shape
                == (last_proj, emb_dim)}
            if len(cands) == 1:
                w = np.asarray(inits[cands.pop()])
                sd["cbhg.pre_highway.weight"] = np.ascontiguousarray(w.T)
    from .import_onnx import to_f32

    return state_dict_to_cbhg(to_f32(sd))


# ---------------------------------------------------------------------------
# inference wrapper
# ---------------------------------------------------------------------------

class TashkeelCBHGModel:
    """Diacritization wrapper over :class:`CBHGTagger`, on one device.

    Character/target id maps default to the package's Arabic vocab and
    diacritic class list; a real artifact's own maps load from a JSON
    sidecar ``<model>.json`` with ``input_id_map`` (char → id) and
    ``target_id_map`` (diacritic string → id) — the same maps libtashkeel
    keeps as JSON resources beside its model.  Long inputs are chunked at
    ``max_len`` on whitespace (libtashkeel caps input length the same way);
    each chunk is one row at its exact length, so the recurrences need no
    packing, and its classes are the one copy to the host.
    """

    def __init__(self, params, *,
                 input_id_map: Optional[dict] = None,
                 target_id_map: Optional[dict] = None,
                 max_len: int = 315, device=None):
        self.device = resolve_device(device)
        module = params if isinstance(params, CBHGTagger) else \
            CBHGTagger(params)
        self.module = module.to(self.device).eval()
        for rnn in self.module.rnns():
            rnn.flatten_parameters()  # cuDNN's packed weights, once
        self._char_to_id = (dict(input_id_map) if input_id_map else
                            {c: i + 1 for i, c in enumerate(_DEFAULT_VOCAB)})
        n_rows = self.module.embedding.shape[0]
        top = max(self._char_to_id.values(), default=0)
        if top >= n_rows:
            # the JAX package's gather clamps such ids silently; on the
            # card an out-of-range index is a device-side assert
            raise FailedToLoadResource(
                f"tashkeel CBHG: the input id map reaches id {top} but the "
                f"embedding has {n_rows} rows (a sidecar <model>.json must "
                "give the model's own input_id_map)")
        tmap = (dict(target_id_map) if target_id_map else
                {d: i for i, d in enumerate(DIACRITICS)})
        n_targets = self.module.out.weight.shape[0]
        self._id_to_target = [""] * n_targets
        for diac, i in tmap.items():
            if 0 <= int(i) < n_targets:
                self._id_to_target[int(i)] = diac
        self.max_len = max_len

    @classmethod
    def from_path(cls, path, *, device=None) -> "TashkeelCBHGModel":
        path = Path(path)
        params = cbhg_from_onnx(path)
        meta = {}
        sidecar = path.with_suffix(".json")
        if sidecar.exists():
            try:
                meta = json.loads(sidecar.read_text(encoding="utf-8"))
            except (OSError, ValueError) as e:
                raise FailedToLoadResource(
                    f"bad tashkeel sidecar {sidecar}: {e}") from e
        return cls(params,
                   input_id_map=meta.get("input_id_map"),
                   target_id_map=meta.get("target_id_map"),
                   max_len=int(meta.get("max_len", 315)), device=device)

    @torch.inference_mode()
    def logits(self, base: str) -> torch.Tensor:
        """Logits ``[len(base), n_targets]`` of one chunk, on the model's
        device."""
        ids = torch.tensor([[self._char_to_id.get(ch, 0) for ch in base]],
                           dtype=torch.long, device=self.device)
        return self.module(ids)[0]

    def chunks(self, base: str) -> list[str]:
        """``base`` cut on whitespace near ``max_len``; a pathological
        single token is hard-split."""
        if len(base) <= self.max_len:
            return [base]
        chunks, start = [], 0
        while start < len(base):
            end = min(start + self.max_len, len(base))
            if end < len(base):
                cut = base.rfind(" ", start, end)
                if cut > start:
                    end = cut + 1
            chunks.append(base[start:end])
            start = end
        return chunks

    def _tag_chunk(self, base: str) -> str:
        classes = self.logits(base).argmax(dim=-1).cpu().numpy()
        return tag_characters(base, classes, self._id_to_target)

    def diacritize(self, text: str) -> str:
        base = strip_diacritics(text)
        if not base.strip():
            return text
        return "".join(self._tag_chunk(c) if c.strip() else c
                       for c in self.chunks(base))
