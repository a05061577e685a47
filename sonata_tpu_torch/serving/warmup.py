"""Bucket-lattice AOT warmup: zero cold compiles after a restart.

Tracing measured the cliff this module removes: the same request
costs 4556 ms with ``compile=cold`` and 30 ms ``cached``.  The old
readiness warmup synthesized exactly **one utterance per replica**, so
after every rolling restart the first real request on every *other*
(batch, text, frame) bucket paid that cliff — a multi-second p999 stall
per bucket, at the worst possible moment (right after a deploy, on
every replica at once).

This module drives the replacement:

- the model enumerates its bucket lattice (``lattice_shapes(mode)``,
  derived from :mod:`sonata_tpu_torch.utils.buckets`) and compiles each shape
  ahead of traffic (``warm_shape`` — a synthetic dummy-argument
  dispatch through the same jit cache real traffic uses, which also
  lands every executable in the persistent compile cache so the
  *second* boot warms from disk in a fraction of cold time);
- ``SONATA_WARMUP_LATTICE=full|minimal|off`` picks coverage: ``full``
  adds the canonical coalesced batch size and the frame-bucket
  neighbors (estimator drift headroom), ``minimal`` is batch-1 with the
  estimated frame bucket per text bucket, ``off`` keeps the legacy
  one-utterance warmup only;
- the whole pass is bounded by ``SONATA_WARMUP_BUDGET_S``.  **Budget
  expiry keeps readiness false** (typed :class:`WarmupBudgetExceeded`,
  one loud log line): a replica that cannot warm inside its budget must
  not join the serving set half-cold — the orchestrator retries or
  rolls back instead of sending users into compiles;
- progress is exported as the ``sonata_warmup_progress`` gauge
  (:class:`WarmupProgress`), so a stuck warmup is a flat line on a
  dashboard, not a silent boot hang.

Models without the lattice contract (no ``lattice_shapes``) fall back
to the one-utterance warmup — the protocol is additive.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from ..core import OperationError

log = logging.getLogger("sonata.serving")

WARMUP_LATTICE_ENV = "SONATA_WARMUP_LATTICE"
WARMUP_BUDGET_ENV = "SONATA_WARMUP_BUDGET_S"
WARMUP_WORKERS_ENV = "SONATA_WARMUP_WORKERS"
MODES = ("full", "minimal", "off")
DEFAULT_MODE = "full"
DEFAULT_WARMUP_BUDGET_S = 600.0
#: concurrent compile workers per model — the same constant the prewarm
#: path uses ("4 workers roughly quarter a cold boot's multi-minute
#: warm"): distinct shapes' XLA compiles are independent and release
#: the GIL.  Warm (cache-hit) boots are tracing-bound and gain little;
#: the CI smoke pins 1 so its cold/warm A/B isolates the cache effect.
DEFAULT_WARM_WORKERS = 4


class WarmupBudgetExceeded(OperationError):
    """The bucket-lattice warmup ran past ``SONATA_WARMUP_BUDGET_S``.

    Readiness stays false: joining the serving set half-warm would hand
    real users the exact compile stalls the lattice exists to prevent."""


def resolve_mode(mode: Optional[str] = None) -> str:
    """Explicit arg > ``SONATA_WARMUP_LATTICE`` > ``full``.  A typo'd
    mode fails loudly at boot (same contract as the SLO table): a fleet
    silently falling back to one-utterance warmup is a p999 regression
    nobody would see until the next deploy."""
    raw = (mode if mode is not None
           else os.environ.get(WARMUP_LATTICE_ENV, "")).strip().lower()
    if not raw:
        return DEFAULT_MODE
    if raw not in MODES:
        raise OperationError(
            f"{WARMUP_LATTICE_ENV}={raw!r} is not one of "
            f"{'/'.join(MODES)}")
    return raw


def resolve_budget_s(budget_s: Optional[float] = None) -> float:
    """Explicit arg > ``SONATA_WARMUP_BUDGET_S`` > 600 s."""
    if budget_s is not None:
        return max(0.0, float(budget_s))
    try:
        return max(0.0, float(os.environ.get(WARMUP_BUDGET_ENV,
                                             DEFAULT_WARMUP_BUDGET_S)))
    except ValueError:
        return DEFAULT_WARMUP_BUDGET_S


class WarmupProgress:
    """Thread-safe warmup progress, driving the ``sonata_warmup_progress``
    gauge: 0.0 at boot, ``done/total`` while warming, 1.0 once every
    enumerated shape compiled.  A gauge that stops moving below 1.0 IS
    the stuck-warmup signal."""

    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
        self.done = 0
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.failed_reason: Optional[str] = None

    def reset(self) -> None:
        with self._lock:
            self.total = 0
            self.done = 0
            self.started_at = time.monotonic()
            self.finished_at = None
            self.failed_reason = None

    def add_total(self, n: int) -> None:
        with self._lock:
            self.total += n

    def note_done(self, n: int = 1) -> None:
        with self._lock:
            self.done += n

    def finish(self, failed_reason: Optional[str] = None) -> None:
        with self._lock:
            self.finished_at = time.monotonic()
            self.failed_reason = failed_reason

    def fraction(self) -> float:
        with self._lock:
            if self.total <= 0:
                # no lattice enumerated (mode off / legacy models): a
                # *finished* warmup still reads 1.0 so dashboards can
                # alert on "boot finished but progress < 1"
                return 1.0 if self.finished_at is not None else 0.0
            return min(1.0, self.done / self.total)

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self.total, "done": self.done,
                    "failed_reason": self.failed_reason,
                    "finished": self.finished_at is not None}


def resolve_workers(workers: Optional[int] = None) -> int:
    """Explicit arg > ``SONATA_WARMUP_WORKERS`` > 4, floored at 1."""
    if workers is not None:
        return max(1, int(workers))
    try:
        return max(1, int(os.environ.get(WARMUP_WORKERS_ENV,
                                         DEFAULT_WARM_WORKERS)))
    except ValueError:
        return DEFAULT_WARM_WORKERS


def warm_model_lattice(model, *, mode: str, deadline: float,
                       progress: Optional[WarmupProgress] = None,
                       label: str = "",
                       workers: Optional[int] = None) -> int:
    """Compile one model's bucket lattice ahead of traffic.

    ``model`` supplies ``lattice_shapes(mode) -> [(b, t, f), ...]`` and
    ``warm_shape((b, t, f))``; models without the contract return 0
    shapes (the caller keeps its one-utterance warmup).  Shapes compile
    ``workers``-wide (independent XLA compiles, the prewarm pattern).
    ``deadline`` is a ``time.monotonic()`` instant shared across every
    model in the boot (one budget covers the whole process, not one per
    replica); each queued shape re-checks it before compiling, so a
    blown budget stops the lattice at the next shape boundary and
    raises :class:`WarmupBudgetExceeded` — readiness stays false.
    Returns the number of shapes warmed for this model.
    """
    from concurrent.futures import ThreadPoolExecutor

    shapes_fn = getattr(model, "lattice_shapes", None)
    if shapes_fn is None:
        return 0
    shapes = list(shapes_fn(mode))
    if progress is not None:
        progress.add_total(len(shapes))
    if not shapes:
        return 0
    workers = resolve_workers(workers)

    def warm_one(shape) -> None:
        # checked per shape ON the worker: all shapes are queued up
        # front, so a submit-time check would pass for every one of
        # them at t=0 and bound nothing
        if time.monotonic() >= deadline:
            raise WarmupBudgetExceeded(
                f"warmup lattice {label or 'model'} ran past the "
                f"{WARMUP_BUDGET_ENV} budget; readiness stays false")
        model.warm_shape(shape)
        if progress is not None:
            progress.note_done()

    warmed = 0
    expired: Optional[WarmupBudgetExceeded] = None
    with ThreadPoolExecutor(max(1, min(workers, len(shapes))),
                            thread_name_prefix="sonata_lattice") as ex:
        for fut in [ex.submit(warm_one, s) for s in shapes]:
            try:
                fut.result()
                warmed += 1
            except WarmupBudgetExceeded as e:
                expired = e  # keep draining: remaining futures fail fast
    if expired is not None:
        raise WarmupBudgetExceeded(
            f"warmup lattice {label or 'model'} ran past the "
            f"{WARMUP_BUDGET_ENV} budget with {warmed}/{len(shapes)} "
            f"shapes warm; readiness stays false") from expired
    log.info("warmup lattice %s: %d shape(s) warm (mode=%s, "
             "%d workers)", label or "model", warmed, mode,
             min(workers, len(shapes)))
    return warmed
