"""Bounded admission control: fail fast instead of queueing unboundedly.

The reference gives every request its own blocking thread and lets the
thread pool's backlog grow without limit (``grpc/src/main.rs:381-409``);
our ``BatchScheduler`` queue was likewise unbounded.  Under overload that
turns into collapse: every request eventually times out, but only after
holding memory and queue slots for the full wait.

:class:`AdmissionController` enforces the standard two-tier bound:

- up to ``max_in_flight`` admitted requests actively execute;
- up to ``max_queue_depth`` more may wait (in practice inside the batch
  scheduler's queue or on the synthesis pool);
- everything beyond is **shed immediately** with a typed
  :class:`Overloaded` error the gRPC layer maps to
  ``RESOURCE_EXHAUSTED`` — the client can retry against another replica
  instead of waiting on a queue that will never drain in time.

The controller is a single counter against the sum of the two limits;
the split into "executing" vs "waiting" is carried by the scheduler
itself (whose own queue is also bounded, as defense in depth).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Iterator, Optional

from ..core import SonataError

MAX_IN_FLIGHT_ENV = "SONATA_MAX_IN_FLIGHT"
MAX_QUEUE_DEPTH_ENV = "SONATA_MAX_QUEUE_DEPTH"
DEFAULT_MAX_IN_FLIGHT = 32
DEFAULT_MAX_QUEUE_DEPTH = 128


class Overloaded(SonataError):
    """The server is at capacity; the request was shed, not queued."""


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class AdmissionController:
    """Thread-safe admitted-request counter with a hard ceiling."""

    def __init__(self, max_in_flight: Optional[int] = None,
                 max_queue_depth: Optional[int] = None):
        self.max_in_flight = (max_in_flight if max_in_flight is not None
                              else _env_int(MAX_IN_FLIGHT_ENV,
                                            DEFAULT_MAX_IN_FLIGHT))
        self.max_queue_depth = (max_queue_depth if max_queue_depth is not None
                                else _env_int(MAX_QUEUE_DEPTH_ENV,
                                              DEFAULT_MAX_QUEUE_DEPTH))
        if self.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if self.max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0")
        self._lock = threading.Lock()
        self._in_flight = 0
        self._shed = 0
        #: optional per-shed callback (the serving runtime points this at
        #: the degradation ladder); called outside the counter lock
        self.on_shed: Optional[Callable[[], None]] = None

    @property
    def capacity(self) -> int:
        return self.max_in_flight + self.max_queue_depth

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self._shed

    def try_acquire(self) -> bool:
        """Admit one request, or count a shed and return False."""
        with self._lock:
            if self._in_flight >= self.capacity:
                self._shed += 1
                shed = True
            else:
                self._in_flight += 1
                shed = False
        if shed and self.on_shed is not None:
            try:
                self.on_shed()
            except Exception:
                pass  # pressure accounting must never fail an RPC
        return not shed

    def release(self) -> None:
        with self._lock:
            if self._in_flight > 0:
                self._in_flight -= 1

    @contextlib.contextmanager
    def admit(self, what: str = "request") -> Iterator[None]:
        """Hold one admission slot for the duration of the block.

        Raises :class:`Overloaded` without blocking when the server is at
        ``max_in_flight + max_queue_depth`` admitted requests.
        """
        if not self.try_acquire():
            raise Overloaded(
                f"server at capacity ({self.capacity} admitted "
                f"{what}s: {self.max_in_flight} in flight + "
                f"{self.max_queue_depth} queued); shedding")
        try:
            yield
        finally:
            self.release()

    def snapshot(self) -> dict:
        with self._lock:
            return {"in_flight": self._in_flight, "shed": self._shed,
                    "max_in_flight": self.max_in_flight,
                    "max_queue_depth": self.max_queue_depth}
