"""Sharded checkpoint save/restore via ``torch.distributed.checkpoint``.

Port of ``sonata_tpu/parallel/checkpoint.py`` (which uses Orbax).  The
single-voice formats are whole files (:mod:`..models.serialization`, the
importers); across processes every rank re-reading the full archive wastes
start-up time, while ``torch.distributed.checkpoint`` writes and reads each
rank's part from the rank that owns it.  It ships with torch and runs
without a process group, as one process.

Usage::

    from sonata_tpu_torch.parallel import checkpoint

    checkpoint.save("/ckpt/voice1", voice.model)
    model = checkpoint.restore("/ckpt/voice1", like=voice.model)
"""

from __future__ import annotations

import copy
import shutil
from pathlib import Path
from typing import Any, Optional, Union

import torch

from ..core import FailedToLoadResource


def _dcp():
    try:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp
    except ImportError as e:  # pragma: no cover
        raise FailedToLoadResource(
            "torch.distributed.checkpoint is required for sharded "
            "checkpoints") from e
    return dcp, not (dist.is_available() and dist.is_initialized())


def _state(params: Any) -> Any:
    """A module's state dict; a (nested) mapping of tensors as it is."""
    if isinstance(params, torch.nn.Module):
        return params.state_dict()
    return params


def save(path: Union[str, Path], params: Any, *,
         force: bool = False) -> None:
    """Write a checkpoint of a parameter module (its state dict) or a
    nested mapping of tensors.

    ``force=False`` (the default, as the reference's) refuses to overwrite
    an existing checkpoint; ``force=True`` replaces it."""
    dcp, single = _dcp()
    p = Path(path).resolve()
    if p.exists():
        if not force:
            raise ValueError(f"checkpoint {p} already exists "
                             "(pass force=True to replace it)")
        shutil.rmtree(p)
    dcp.save(_state(params), checkpoint_id=str(p), no_dist=single)


def restore(path: Union[str, Path], *, like: Optional[Any] = None) -> Any:
    """Restore a checkpoint.

    ``like``: a parameter module (a copy of it comes back, holding the
    restored values) or a nested mapping of tensors giving the target
    structure, dtypes and devices (the same structure comes back, new
    tensors).  Without it, a flat ``{dotted key: tensor}`` dict of CPU
    tensors."""
    dcp, single = _dcp()
    p = Path(path).resolve()
    if not p.exists():
        raise FailedToLoadResource(f"checkpoint not found: {p}")
    try:
        if like is None:
            meta = dcp.FileSystemReader(str(p)).read_metadata()
            target = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                      for k, m in meta.state_dict_metadata.items()
                      if hasattr(m, "size")}
            dcp.load(target, checkpoint_id=str(p), no_dist=single)
            return target
        if isinstance(like, torch.nn.Module):
            out = copy.deepcopy(like)
            state = out.state_dict()
            dcp.load(state, checkpoint_id=str(p), no_dist=single)
            out.load_state_dict(state)
            return out
        target = _clone_tree(like)
        dcp.load(target, checkpoint_id=str(p), no_dist=single)
        return target
    except FailedToLoadResource:
        raise
    except Exception as e:  # a corrupt or partial checkpoint
        raise FailedToLoadResource(
            f"cannot restore checkpoint {p}: {e}") from e


def _clone_tree(node):
    if isinstance(node, torch.Tensor):
        return torch.empty_like(node)
    if isinstance(node, dict):
        return {k: _clone_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_clone_tree(v) for v in node)
    return copy.deepcopy(node)
