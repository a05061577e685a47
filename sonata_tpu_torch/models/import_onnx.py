"""Import Piper ONNX voice files without an ONNX runtime or the ``onnx``
package.

The reference hands the whole file to onnxruntime
(``crates/sonata/models/piper/src/lib.rs:79-86``).  We only need the
*weights*: ONNX is protobuf, and protobuf's wire format is simple enough to
parse directly — varint-keyed fields, length-delimited submessages.  This
module implements a minimal wire reader, walks ``ModelProto.graph`` (field
7) → ``GraphProto.initializer`` (field 5), decodes each ``TensorProto``, and
maps the torch-style initializer names that ``torch.onnx.export`` preserves
onto our pytree via :func:`.import_torch.state_dict_to_params`.

Field numbers follow the public ONNX schema (onnx/onnx.proto):
``TensorProto``: dims=1, data_type=2, float_data=4, int64_data=7, name=8,
raw_data=9.  Data types: FLOAT=1, INT64=7, FLOAT16=10, DOUBLE=11.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

from ..core import FailedToLoadResource
from ..utils.protowire import (
    WIRE_32BIT as _WIRE_32BIT,
    WIRE_LEN as _WIRE_LEN,
    WIRE_VARINT as _WIRE_VARINT,
    WireError,
    iter_fields as _iter_fields,
    read_varint as _read_varint,
)
from .config import VitsHyperParams


def iter_fields(buf):
    """protowire field iterator with errors mapped to resource failures."""
    try:
        yield from _iter_fields(buf)
    except WireError as e:
        raise FailedToLoadResource(f"malformed protobuf: {e}") from e


_DTYPE = {1: np.float32, 7: np.int64, 10: np.float16, 11: np.float64,
          6: np.int32, 9: np.bool_}


def _varints(value) -> list[int]:
    """Decode a packed-varint payload, mapping wire errors to load errors."""
    out: list[int] = []
    pos = 0
    mv = memoryview(value)
    try:
        while pos < len(mv):
            v, pos = _read_varint(mv, pos)
            out.append(v)
    except WireError as e:
        raise FailedToLoadResource(f"malformed packed varints: {e}") from e
    return out


def _decode_tensor(buf) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None  # memoryview into the file buffer — zero-copy until np
    float_data: list[float] = []
    int64_data: list[int] = []
    for field, wire, value in iter_fields(buf):
        if field == 1:  # dims
            if wire == _WIRE_VARINT:
                dims.append(int(value))
            else:  # packed
                dims.extend(_varints(value))
        elif field == 2 and wire == _WIRE_VARINT:
            data_type = int(value)
        elif field == 8:
            name = bytes(value).decode("utf-8", errors="replace")
        elif field == 9:
            raw = value
        elif field == 4:  # float_data (packed or repeated)
            if wire == _WIRE_LEN:
                float_data.extend(
                    struct.unpack(f"<{len(value) // 4}f", value))
            else:
                float_data.append(struct.unpack("<f", value)[0])
        elif field == 7:  # int64_data
            if wire == _WIRE_LEN:
                int64_data.extend(_varints(value))
            else:
                int64_data.append(int(value))
    dtype = _DTYPE.get(data_type)
    if dtype is None:
        raise FailedToLoadResource(
            f"initializer {name!r}: unsupported ONNX data type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).copy()
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def read_onnx_initializers(path: Union[str, Path]) -> dict[str, np.ndarray]:
    """Extract ``{initializer name: ndarray}`` from an ONNX file.

    Initializer-only walk — skips node decoding entirely (a ~100 MB voice
    file has thousands of nodes the plain weight path never needs); use
    :func:`read_onnx_graph` when node topology matters.
    """
    data = Path(path).read_bytes()
    out: dict[str, np.ndarray] = {}
    for field, wire, value in iter_fields(memoryview(data)):
        if field == 7 and wire == _WIRE_LEN:  # ModelProto.graph
            for gfield, gwire, gvalue in iter_fields(value):
                if gfield == 5 and gwire == _WIRE_LEN:  # initializer
                    name, arr = _decode_tensor(gvalue)
                    out[name] = arr
    if not out:
        raise FailedToLoadResource(
            f"{path}: no initializers found (not an ONNX model?)")
    return out


def to_f32(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Upcast/downcast half/double tensors to float32 (shared by every
    ONNX import path)."""
    return {k: v.astype(np.float32) if v.dtype in (np.float16, np.float64)
            else v for k, v in sd.items()}


def _decode_attribute(buf) -> tuple[str, object]:
    """AttributeProto → (name, value) for the subset importers need.

    Fields (onnx.proto): name=1, f=2, i=3, s=4, t=5, ints=8.
    """
    name = ""
    value: object = None
    ints: list[int] = []

    def _signed(v: int) -> int:
        return v - (1 << 64) if v >= (1 << 63) else v

    for field, wire, raw in iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            name = bytes(raw).decode("utf-8", errors="replace")
        elif field == 2 and wire == _WIRE_32BIT:
            value = struct.unpack("<f", raw)[0]
        elif field == 3 and wire == _WIRE_VARINT:
            value = _signed(int(raw))
        elif field == 4 and wire == _WIRE_LEN:
            value = bytes(raw).decode("utf-8", errors="replace")
        elif field == 5 and wire == _WIRE_LEN:
            value = _decode_tensor(raw)[1]
        elif field == 8:
            if wire == _WIRE_VARINT:
                ints.append(_signed(int(raw)))
            else:
                ints.extend(_signed(v) for v in _varints(raw))
    if ints:
        value = ints
    return name, value


def _decode_node(buf) -> dict:
    """NodeProto → {op_type, inputs, outputs, attrs} (fields 1,2,4,5)."""
    node = {"op_type": "", "inputs": [], "outputs": [], "attrs": {}}
    for field, wire, raw in iter_fields(buf):
        if field == 1 and wire == _WIRE_LEN:
            node["inputs"].append(
                bytes(raw).decode("utf-8", errors="replace"))
        elif field == 2 and wire == _WIRE_LEN:
            node["outputs"].append(
                bytes(raw).decode("utf-8", errors="replace"))
        elif field == 4 and wire == _WIRE_LEN:
            node["op_type"] = bytes(raw).decode("utf-8", errors="replace")
        elif field == 5 and wire == _WIRE_LEN:
            k, v = _decode_attribute(raw)
            node["attrs"][k] = v
    return node


def read_onnx_graph(
        path: Union[str, Path],
) -> tuple[dict[str, np.ndarray], list[dict]]:
    """Extract ``({initializer name: ndarray}, [node dicts])`` from an ONNX
    file.  Nodes are returned in graph (topological) order; ``Constant``
    nodes contribute their tensor to the initializer map under their output
    name — ``torch.onnx.export`` with constant folding emits transformed
    weights (e.g. recurrent ``W/R/B``) this way.
    """
    data = Path(path).read_bytes()
    inits: dict[str, np.ndarray] = {}
    nodes: list[dict] = []
    for field, wire, value in iter_fields(memoryview(data)):
        if field == 7 and wire == _WIRE_LEN:  # ModelProto.graph
            for gfield, gwire, gvalue in iter_fields(value):
                if gfield == 5 and gwire == _WIRE_LEN:  # initializer
                    name, arr = _decode_tensor(gvalue)
                    inits[name] = arr
                elif gfield == 1 and gwire == _WIRE_LEN:  # node
                    node = _decode_node(gvalue)
                    nodes.append(node)
                    if (node["op_type"] == "Constant"
                            and node["outputs"]
                            and isinstance(node["attrs"].get("value"),
                                           np.ndarray)):
                        inits[node["outputs"][0]] = node["attrs"]["value"]
    if not inits:
        raise FailedToLoadResource(
            f"{path}: no initializers found (not an ONNX model?)")
    return inits, nodes


def recover_folded_conv_weights(inits: dict, nodes: list) -> dict:
    """Name anonymous folded conv weights after their conv's named bias.

    Graph optimizers (onnxsim, ORT offline optimization, newer
    ``torch.onnx.export`` folding) precompute the weight-norm
    ``g*v/||v||`` product into a single anonymous constant
    (``onnx::Conv_123``, ``/Mul_7_output_0``) and drop the named
    ``weight_g``/``weight_v`` initializers — but the conv's *bias* is not
    part of weight norm, so it keeps its parameter name.  For every
    Conv/ConvTranspose node whose weight input is an anonymous tensor and
    whose bias is a named ``{prefix}.bias``, register the weight tensor
    under ``{prefix}.weight`` so the state-dict mapper sees the layout it
    expects (ONNX Conv/ConvTranspose weight layouts equal torch's).
    """
    out = dict(inits)
    for n in nodes:
        if n["op_type"] not in ("Conv", "ConvTranspose"):
            continue
        ins = n["inputs"]
        if len(ins) < 3:
            continue
        w_name, b_name = ins[1], ins[2]
        if not b_name.endswith(".bias"):
            continue
        prefix = b_name[: -len(".bias")]
        if f"{prefix}.weight" in out or f"{prefix}.weight_v" in out:
            continue  # named weight (or recoverable g/v pair) already there
        anonymous = (w_name.startswith("/") or "::" in w_name
                     or not w_name.endswith((".weight", ".weight_v")))
        if anonymous and w_name in out:
            out[f"{prefix}.weight"] = out[w_name]
    return out


def resolve_identity_aliases(inits: dict, nodes: list) -> dict:
    """Materialize tensors routed through ``Identity`` nodes.

    ``torch.onnx.export`` deduplicates value-identical tensors: only one
    copy becomes an initializer and the other names are produced by
    ``Identity`` nodes (e.g. a fresh BatchNorm's ``running_mean`` aliasing
    its zero ``bias``).  Returns ``inits`` extended with one entry per
    resolvable Identity output.
    """
    out = dict(inits)
    pending = [n for n in nodes if n["op_type"] == "Identity"
               and n["inputs"] and n["outputs"]]
    progress = True
    while pending and progress:
        progress = False
        rest = []
        for n in pending:
            if n["inputs"][0] in out:
                out[n["outputs"][0]] = out[n["inputs"][0]]
                progress = True
            else:
                rest.append(n)
        pending = rest
    return out


def _merge_initializers(dicts: "list[tuple[str, dict]]") -> dict:
    """Merge per-file initializer maps (the streaming encoder/decoder
    split).  Real parameter names must agree when repeated; anonymous
    scope-generated names ("/Constant_output_0", "onnx::MatMul_12")
    legitimately collide across independent exports and are last-wins.
    """
    merged: dict = {}
    for label, d in dicts:
        for name, arr in d.items():
            prev = merged.get(name)
            anonymous = name.startswith("/") or "::" in name
            if (prev is not None and not anonymous
                    and (prev.shape != arr.shape
                         or not np.array_equal(prev, arr))):
                raise FailedToLoadResource(
                    f"initializer {name!r} differs between the merged "
                    f"ONNX files (last: {label})")
            merged[name] = arr
    return merged


def import_onnx_weights(path: Union[str, Path, "tuple", "list"],
                        hp: VitsHyperParams, *,
                        n_vocab: int, n_speakers: int = 1) -> dict:
    """ONNX initializers → native param pytree.

    ``torch.onnx.export`` keeps parameter names for initializers, so the
    state-dict mapper applies directly.  Weight-norm is usually already
    fused in exports (piper removes it); if ``weight_g/v`` pairs survive,
    the mapper fuses them.

    ``path`` may be a sequence of files whose initializer sets partition
    one model — the streaming voice layout's ``encoder.onnx`` +
    ``decoder.onnx`` (``piper/src/lib.rs:90-96``).
    """
    from .import_torch import state_dict_to_params, strip_prefix

    paths = list(path) if isinstance(path, (tuple, list)) else [path]
    sd = to_f32(_merge_initializers(
        [(str(p), read_onnx_initializers(p)) for p in paths]))
    try:
        return state_dict_to_params(strip_prefix(sd), hp, n_vocab=n_vocab,
                                    n_speakers=n_speakers)
    except FailedToLoadResource:
        # torch.onnx.export deduplicates value-identical tensors behind
        # Identity nodes (e.g. untouched LayerNorm gammas), and graph
        # optimizers fold weight-norm products into anonymous constants;
        # retry with the full graph walk resolving both
        resolved = []
        for p in paths:
            inits, nodes = read_onnx_graph(p)
            inits = resolve_identity_aliases(inits, nodes)
            inits = recover_folded_conv_weights(inits, nodes)
            resolved.append((str(p), inits))
        sd = to_f32(_merge_initializers(resolved))
        return state_dict_to_params(strip_prefix(sd), hp, n_vocab=n_vocab,
                                    n_speakers=n_speakers)
