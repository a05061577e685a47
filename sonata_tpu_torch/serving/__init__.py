"""Serving helpers the batching engines stand on.

Copies of the JAX package's jax-free serving modules (made by
``tools/torch_port_copy.py``, held equal to their originals by
``tests/test_torch_isolation.py``):

- :mod:`.admission` — bounded admission; excess load fails fast with
  :class:`Overloaded`;
- :mod:`.deadlines` — per-request :class:`Deadline`, dropped before a
  device dispatch once expired or cancelled;
- :mod:`.tracing` — request-scoped span trees with coalesced-dispatch
  attribution;
- :mod:`.faults` — named failpoints (``SONATA_FAILPOINTS``);
- :mod:`.degradation` — the graceful-degradation ladder that collapses
  gather windows and forces dispatch mode under pressure;
- :mod:`.scope` — dispatch-efficiency accounting and stage quantiles
  (with :mod:`.sketches`, which it imports).

The rest of the JAX package's serving runtime (metrics plane, replicas,
caches, tenancy, ledger, mesh) is not ported yet.
"""

from . import degradation as degradation_mod
from . import faults, scope, tracing
from .admission import AdmissionController, Overloaded
from .deadlines import Deadline, DeadlineExceeded, default_timeout_s
from .degradation import DegradationLadder

__all__ = [
    "AdmissionController",
    "Deadline",
    "DeadlineExceeded",
    "DegradationLadder",
    "Overloaded",
    "default_timeout_s",
    "degradation_mod",
    "faults",
    "scope",
    "tracing",
]
