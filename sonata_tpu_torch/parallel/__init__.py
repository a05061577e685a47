"""Device-mesh parallelism: data-parallel batch sharding, sequence-parallel
ring attention and halo exchange, the tensor-parallel decoder's
placements, multi-process initialization.

Port of ``sonata_tpu/parallel``: one process drives a ``(data, seq,
model)`` grid of ``torch.device`` entries (:class:`Mesh`)."""

from . import checkpoint
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    data_sharding,
    initialize_distributed,
    make_mesh,
    param_shardings,
    replicated,
)
from .ring import ring_attention, ring_attention_sharded

__all__ = [
    "checkpoint",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "data_sharding",
    "initialize_distributed",
    "make_mesh",
    "param_shardings",
    "replicated",
    "ring_attention",
    "ring_attention_sharded",
]
