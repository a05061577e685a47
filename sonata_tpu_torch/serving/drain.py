"""Graceful drain: make a rolling restart a non-event.

A process that receives SIGTERM used to simply vanish mid-stream — the
only "drain logic" was a comment in the gRPC frontend's shutdown path.
At fleet scale every deploy was therefore a dropped-request event: the
load balancer kept routing to a replica that was already dying, and
every stream it was serving broke.

This module is the state machine both frontends drain through:

- :class:`Draining` — the **typed** refusal for work arriving during a
  drain.  It maps to gRPC ``UNAVAILABLE`` (with a ``draining`` detail),
  deliberately *not* ``RESOURCE_EXHAUSTED``: clients, the degradation
  ladder, and dashboards must be able to tell a deploy from overload
  (a shed is pressure; a drain is routine).
- :class:`DrainCoordinator` — one per process (owned by
  :class:`~sonata_tpu_torch.serving.ServingRuntime`), holding the drain flag,
  the per-phase structured log lines, and the bounded wait for in-flight
  work.  The pinned phase order is :data:`DRAIN_PHASES`:

  1. ``readiness-off`` — every readiness gate flips *first*, so the
     balancer stops routing here before anything else changes;
  2. ``reject-admissions`` — new requests fail fast with
     :class:`Draining` (in-flight ones are untouched);
  3. ``wait-in-flight`` — in-flight streams and queued scheduler
     dispatches finish, bounded by ``SONATA_DRAIN_TIMEOUT_S``;
  4. ``voices`` — replica pools → schedulers → models tear down
     (the pool refuses breaker resubmission and half-open probes
     *typed* once it is draining — no work re-enters a closing
     scheduler, no probe builds a worker thread nobody will join);
  5. ``runtime`` — tracer/scope, then the metrics plane;
  6. ``done``.

The ``sonata_draining`` gauge mirrors the flag on the scrape plane, so
a dashboard can overlay deploys on every other signal.  Size the
orchestrator's ``terminationGracePeriodSeconds`` *above*
``SONATA_DRAIN_TIMEOUT_S`` (docs/DEPLOY.md "Rolling restarts") or the
kernel's SIGKILL wins the race this module exists to lose gracefully.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..core import OperationError

log = logging.getLogger("sonata.serving")

DRAIN_TIMEOUT_ENV = "SONATA_DRAIN_TIMEOUT_S"
DEFAULT_DRAIN_TIMEOUT_S = 30.0

#: the pinned shutdown order; every phase logs exactly one structured
#: line (``drain: phase=<name> ...``) so an operator can read a restart
#: end to end from the log stream, and the chaos smoke can assert the
#: order never regresses
DRAIN_PHASES = ("readiness-off", "reject-admissions", "wait-in-flight",
                "voices", "runtime", "done")

#: how often the wait-in-flight phase re-checks the idle predicate
_IDLE_POLL_S = 0.02


class Draining(OperationError):
    """New work refused because the process is draining for a restart.

    Typed (and mapped to gRPC ``UNAVAILABLE``) so callers can tell a
    routine deploy from overload: a client retries against another
    replica immediately; the degradation ladder does **not** count it
    as shed pressure."""


def resolve_drain_timeout_s(timeout_s: Optional[float] = None) -> float:
    """Explicit arg > ``SONATA_DRAIN_TIMEOUT_S`` > 30 s."""
    if timeout_s is not None:
        return max(0.0, float(timeout_s))
    try:
        return max(0.0, float(os.environ.get(DRAIN_TIMEOUT_ENV,
                                             DEFAULT_DRAIN_TIMEOUT_S)))
    except ValueError:
        return DEFAULT_DRAIN_TIMEOUT_S


class DrainCoordinator:
    """Process drain state: flag, phase log, bounded in-flight wait.

    The flag is sticky — a drain never un-happens — and ``begin`` is
    first-caller-wins, so a second SIGTERM (or a drain racing an
    explicit shutdown) is a no-op rather than a second teardown.
    """

    def __init__(self, *, timeout_s: Optional[float] = None):
        self.timeout_s = resolve_drain_timeout_s(timeout_s)
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._reason: Optional[str] = None
        self._started_at: Optional[float] = None
        #: (phase, monotonic seconds since begin) in emission order
        self.phases: list = []

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def reason(self) -> Optional[str]:
        with self._lock:
            return self._reason

    def begin(self, reason: str = "shutdown") -> bool:
        """Enter the drain state.  Returns True for the first caller
        (who owns running the phases), False for everyone after."""
        with self._lock:
            if self._draining.is_set():
                return False
            self._reason = reason
            self._started_at = time.monotonic()
            self._draining.set()
        return True

    def raise_if_draining(self) -> None:
        """Admission-path hook: typed refusal for new work mid-drain."""
        if self._draining.is_set():
            raise Draining(
                f"draining: server is shutting down for a restart "
                f"({self.reason}); retry against another replica")

    def note_phase(self, phase: str, **fields) -> None:
        """One structured log line per phase, in :data:`DRAIN_PHASES`
        order (the order itself is the caller's contract — this method
        just records and logs)."""
        started = self._started_at
        elapsed_ms = (round((time.monotonic() - started) * 1e3, 1)
                      if started is not None else 0.0)
        with self._lock:
            self.phases.append((phase, elapsed_ms))
        detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        log.warning("drain: phase=%s elapsed_ms=%s reason=%s%s",
                    phase, elapsed_ms, self._reason,
                    f" {detail}" if detail else "")

    def wait_idle(self, idle: Callable[[], bool],
                  timeout_s: Optional[float] = None) -> bool:
        """Poll ``idle()`` until it holds or the drain budget expires.

        Returns True when the process went idle inside the budget,
        False on expiry (the caller proceeds to teardown regardless —
        stragglers fail typed when their scheduler shuts down, which
        beats being SIGKILLed mid-dispatch by the orchestrator)."""
        budget = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + budget
        while True:
            try:
                if idle():
                    return True
            except Exception:
                # a health probe racing teardown must not abort the
                # drain: treat an unreadable predicate as not-idle
                log.exception("drain idle predicate failed; retrying")
            if time.monotonic() >= deadline:
                return False
            time.sleep(_IDLE_POLL_S)
