"""Native parameter serialization: flat-keyed ``.npz`` archives.

The port's copy of the JAX package's format, written with numpy alone: a
voice's ``<stem>.npz`` holds the parameter tree flattened to ``/``-joined
keys (``enc_p/encoder/layers/0/attn/q/w``), list indices as decimal path
segments.  The tree stays in the JAX package's layout (convolution weights
``[K, C_in, C_out]``); :mod:`.weights` turns it into torch tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

SEP = "/"


def flatten_params(params, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of arrays → flat ``{"a/0/w": array}``."""
    if isinstance(params, dict):
        items = ((str(k), v) for k, v in params.items())
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: np.asarray(params)}
    flat: dict[str, np.ndarray] = {}
    for key, value in items:
        flat.update(flatten_params(value, f"{prefix}{SEP}{key}" if prefix
                                   else key))
    return flat


def unflatten_params(flat: dict[str, np.ndarray]):
    """Rebuild the nested dict/list tree from flat keys."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def _listify(node):
    """Convert dicts whose keys are 0..n-1 into lists (restores the tree's
    layer stacks)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    keys = list(out.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [out[str(i)] for i in idx]
    return out


def save_params(path: Union[str, Path], params) -> None:
    np.savez(Path(path), **flatten_params(params))


def load_params(path: Union[str, Path]):
    with np.load(Path(path)) as data:
        return unflatten_params({k: data[k] for k in data.files})
