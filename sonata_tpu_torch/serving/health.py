"""Liveness and readiness for rolling restarts.

Two different questions, two different endpoints:

- **Liveness** (``/healthz``): is the process able to make progress at
  all?  True from startup; an orchestrator restarts the pod when it goes
  false (we only flip it on unrecoverable internal failure).
- **Readiness** (``/readyz``, and the ``CheckHealth`` gRPC unary): should
  a load balancer send traffic *now*?  False until the preloaded voices
  have finished loading AND each has synthesized one warmup utterance —
  the warmup forces the XLA compile of the common executables, so the
  first real request never eats a multi-second (cold cache: multi-minute)
  compile.  During a rolling restart the new replica therefore joins the
  serving set only once it can answer at steady-state latency.

Both are also exported as gauges (``sonata_up``, ``sonata_ready``) so the
scrape plane sees the same truth the probes do.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .metrics import MetricsRegistry


class HealthState:
    """Thread-safe liveness/readiness flags with a human-readable reason."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._live = True
        self._ready = threading.Event()
        self._reason = "starting: voices not loaded"
        self._ready_at: Optional[float] = None
        #: stable node identity (SONATA_NODE_ID or host:port), set by
        #: ServingRuntime.set_node_id once the frontend knows its bind
        #: address; surfaced on /readyz and CheckHealth so fleet-side
        #: logs name this process instead of an opaque channel
        self.node_id: Optional[str] = None
        #: loaded-voice ids (maintained by ServingRuntime.register_voice
        #: / unregister_voice), surfaced as the ``voices=`` line on
        #: /readyz — the ACTUAL-state signal the sonata-mesh placement
        #: reconciler diffs against its desired state.  Present even
        #: when empty: an explicit empty set ("this node holds no
        #: voices") is exactly the news a restarted node must deliver.
        self._voice_ids: set = set()
        #: named predicates evaluated at every readiness read: the
        #: process is ready only when the event is set AND every gate
        #: holds.  This is how live conditions (e.g. "this voice's
        #: replica pool has a healthy replica") flip /readyz without
        #: anyone having to call set_not_ready at the right moment —
        #: and flip it back on recovery just as automatically.
        self._gates: dict = {}
        if registry is not None:
            registry.gauge(
                "sonata_up", "Process liveness (1 = live)."
            ).set_function(lambda: 1.0 if self.live else 0.0)
            registry.gauge(
                "sonata_ready",
                "Readiness gate (1 = voices loaded and warmed)."
            ).set_function(lambda: 1.0 if self.ready else 0.0)

    # -- liveness ------------------------------------------------------------
    @property
    def live(self) -> bool:
        with self._lock:
            return self._live

    def set_unhealthy(self, reason: str) -> None:
        """Unrecoverable internal failure: ask the orchestrator for a
        restart (also drops readiness)."""
        with self._lock:
            self._live = False
            self._reason = reason
        self._ready.clear()

    # -- readiness -----------------------------------------------------------
    @property
    def ready(self) -> bool:
        return self._ready.is_set() and self._failing_gate() is None

    def _failing_gate(self) -> Optional[str]:
        """Name of the first failing readiness gate, or None.  A gate
        that raises counts as failing (fail-safe: an error evaluating
        health must read as unhealthy, never as healthy)."""
        with self._lock:
            gates = list(self._gates.items())
        for name, fn in gates:
            try:
                if not fn():
                    return name
            except Exception:
                return name
        return None

    def add_readiness_gate(self, name: str, fn) -> None:
        """Register a zero-arg predicate that must hold for readiness."""
        with self._lock:
            self._gates[name] = fn

    def remove_readiness_gate(self, name: str) -> None:
        with self._lock:
            self._gates.pop(name, None)

    @property
    def reason(self) -> str:
        gate = self._failing_gate()
        if gate is not None and self._ready.is_set():
            return f"readiness gate failing: {gate}"
        with self._lock:
            return self._reason

    def set_ready(self, reason: str = "ready") -> None:
        with self._lock:
            self._reason = reason
            if self._ready_at is None:
                self._ready_at = time.monotonic()
        self._ready.set()

    def set_not_ready(self, reason: str) -> None:
        """Drop out of the serving set (e.g. draining before shutdown)."""
        with self._lock:
            self._reason = reason
        self._ready.clear()

    # -- loaded voices (the placement reconciler's actual state) -------------
    def note_voice(self, voice_id: str) -> None:
        with self._lock:
            self._voice_ids.add(voice_id)

    def drop_voice(self, voice_id: str) -> None:
        with self._lock:
            self._voice_ids.discard(voice_id)

    def voices_view(self) -> list:
        """Sorted loaded-voice ids (what /readyz renders as
        ``voices=``)."""
        with self._lock:
            return sorted(self._voice_ids)

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return self._ready.wait(timeout)

    def snapshot(self) -> dict:
        ready = self.ready
        reason = self.reason
        with self._lock:
            return {"live": self._live, "ready": ready, "reason": reason,
                    "node_id": self.node_id}
