"""Per-request deadlines and client-disconnect propagation.

The reference server has no deadline story at all: ``SynthesizeUtterance``
blocks on the session run until it finishes, however long that takes
(``grpc/src/main.rs:321-355``), and a client that hangs up leaves the
synthesis running to completion.  Under overload that is how queues grow
without bound — work is still performed for callers that stopped waiting
for it.

A :class:`Deadline` travels with a request from the frontend into the
batch scheduler.  It answers two questions any stage can ask cheaply:

- *has this request run out of time?* (``expired()``) — derived from the
  gRPC context deadline when the client set one, else from the server
  default ``SONATA_REQUEST_TIMEOUT_S``;
- *does anyone still want the answer?* (``cancelled``) — flipped by the
  gRPC ``context.add_callback`` hook when the client disconnects.

Stages drop dead requests *before* spending device time on them: the
scheduler's gather loop filters expired/cancelled items out of a batch
before it is packed into a dispatch, and streaming loops check between
chunks.  Expired work fails with :class:`DeadlineExceeded`, which the
gRPC layer maps to ``DEADLINE_EXCEEDED``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..core import SonataError

#: Server-side default request timeout (seconds) when the client set no
#: gRPC deadline.  ``<= 0`` disables the server default (requests may
#: then only expire via an explicit client deadline).
TIMEOUT_ENV = "SONATA_REQUEST_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 120.0


class DeadlineExceeded(SonataError):
    """The request ran out of time before (or while) being served."""


def default_timeout_s() -> Optional[float]:
    """The configured server-side default timeout, or None if disabled."""
    raw = os.environ.get(TIMEOUT_ENV)
    if raw is None:
        return DEFAULT_TIMEOUT_S
    try:
        value = float(raw)
    except ValueError:
        return DEFAULT_TIMEOUT_S
    return value if value > 0 else None


class Deadline:
    """An absolute point on the monotonic clock plus a cancellation flag.

    Immutable except for :meth:`cancel`; safe to share across the gRPC
    handler thread, the scheduler worker, and callback threads.
    """

    __slots__ = ("_expires_at", "_cancelled")

    def __init__(self, expires_at: Optional[float] = None):
        self._expires_at = expires_at  # monotonic seconds, None = never
        self._cancelled = threading.Event()

    # -- constructors --------------------------------------------------------
    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        if seconds is None:
            return cls(None)
        return cls(time.monotonic() + seconds)

    @classmethod
    def none(cls) -> "Deadline":
        """A deadline that never expires (still cancellable)."""
        return cls(None)

    @classmethod
    def from_grpc_context(cls, context,
                          default_s: Optional[float] = None) -> "Deadline":
        """Client deadline when set, else the server default.

        Also registers the context's termination callback (client
        disconnect / cancellation) when the context supports it, so a
        hung-up client stops costing device time.  Works with both real
        ``grpc.ServicerContext`` objects and the bare test doubles the
        suite uses (which may lack either attribute).
        """
        remaining = None
        time_remaining = getattr(context, "time_remaining", None)
        if time_remaining is not None:
            remaining = time_remaining()
        # "no client deadline" surfaces as None on some grpcio versions
        # and as int64-max-epoch seconds (~3e11) on others; both mean
        # "use the server default" (anything past a year is not a real
        # deadline, and huge values overflow C timestamp conversions in
        # downstream waits)
        if remaining is None or remaining > 365 * 24 * 3600:
            remaining = (default_s if default_s is not None
                         else default_timeout_s())
        dl = cls.after(remaining)
        add_callback = getattr(context, "add_callback", None)
        if add_callback is not None:
            # fires on client disconnect AND on normal completion; a
            # cancel after the response is finished is harmless
            try:
                add_callback(dl.cancel)
            except Exception:
                pass  # context already terminated
        return dl

    # -- queries -------------------------------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    def remaining(self) -> Optional[float]:
        """Seconds left, None if unbounded.  May be negative once expired."""
        if self._expires_at is None:
            return None
        return self._expires_at - time.monotonic()

    def expired(self) -> bool:
        return (self._expires_at is not None
                and time.monotonic() >= self._expires_at)

    def alive(self) -> bool:
        """Still worth working on: neither expired nor cancelled."""
        return not self.expired() and not self.cancelled

    def raise_if_expired(self, what: str = "request") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} deadline exceeded")

    def __repr__(self) -> str:
        rem = self.remaining()
        state = "cancelled" if self.cancelled else (
            "expired" if self.expired() else "alive")
        return (f"Deadline({state}, remaining="
                f"{'inf' if rem is None else f'{rem:.3f}s'})")
