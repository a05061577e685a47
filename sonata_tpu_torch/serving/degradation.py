"""Graceful-degradation ladder: named pressure levels with hysteresis.

Admission shedding and the hung-dispatch watchdog tell the process it is
in trouble; until now nothing *acted* on that signal — the server kept
its full coalescing windows, kept accepting batch work, and kept
advertising readiness while drowning.  The ladder turns sustained
pressure into staged, reversible load-shedding policy:

====  ================  =====================================================
lvl   name              effect
====  ================  =====================================================
0     normal            —
1     shrink-coalesce   batch-gather windows collapse to zero
                        (:func:`gather_scale`): dispatches go out
                        per-request, trading throughput for latency and
                        queue drain
2     reject-batch      batch/long-form synthesis (PARALLEL/BATCHED modes)
                        sheds with ``Overloaded`` before interactive work
                        is touched
3     readiness-off     the ``degradation`` readiness gate fails —
                        ``/readyz`` goes 503 and the balancer routes
                        around the whole process
====  ================  =====================================================

Stepping **up**: each recorded pressure event (a shed, a watchdog fire)
lands in a sliding window; when the window holds
``SONATA_DEGRADE_SHED_THRESHOLD`` sheds or
``SONATA_DEGRADE_WATCHDOG_THRESHOLD`` watchdog fires, the level rises by
one and the window restarts (another full window of pressure is needed
for the next step — no instant 0→3 jumps from one burst).

Stepping **down** (hysteresis): a level is held until the process has
been quiet — no pressure events — for ``SONATA_DEGRADE_RECOVER_S``, then
recovery descends one level per quiet period.  Evaluation is lazy, on
reads (every request and every metrics scrape call
:meth:`DegradationLadder.current_level`), so no timer thread exists.

Every transition is one log line and a move of the
``sonata_degradation_level`` gauge (exported by ``ServingRuntime``).
The process-global install (:func:`install`) lets deep layers — the
batch scheduler's gather loop, its watchdog — consult and feed the
ladder without threading the runtime through the model protocol.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

log = logging.getLogger("sonata.serving")

WINDOW_ENV = "SONATA_DEGRADE_WINDOW_S"
SHED_THRESHOLD_ENV = "SONATA_DEGRADE_SHED_THRESHOLD"
WATCHDOG_THRESHOLD_ENV = "SONATA_DEGRADE_WATCHDOG_THRESHOLD"
BURN_THRESHOLD_ENV = "SONATA_DEGRADE_BURN_THRESHOLD"
RECOVER_ENV = "SONATA_DEGRADE_RECOVER_S"

DEFAULT_WINDOW_S = 30.0
DEFAULT_SHED_THRESHOLD = 20
DEFAULT_WATCHDOG_THRESHOLD = 2
#: SLO-burn pressure events (the scope's 1 Hz tick emits one per second
#: of sustained over-threshold fast-window burn, when
#: SONATA_DEGRADE_ON_BURN enables the coupling) per window per step
DEFAULT_BURN_THRESHOLD = 10
DEFAULT_RECOVER_S = 15.0

#: level names, index == level (also the gauge's documented scale)
LEVEL_NAMES = ("normal", "shrink-coalesce", "reject-batch",
               "readiness-off")
MAX_LEVEL = len(LEVEL_NAMES) - 1


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class DegradationLadder:
    """Pressure-event windows + the current level, with hysteresis."""

    def __init__(self, *, window_s: Optional[float] = None,
                 shed_threshold: Optional[int] = None,
                 watchdog_threshold: Optional[int] = None,
                 burn_threshold: Optional[int] = None,
                 recover_s: Optional[float] = None,
                 on_change: Optional[Callable[[int, str], None]] = None):
        self.window_s = max(0.1, window_s if window_s is not None
                            else _env_float(WINDOW_ENV, DEFAULT_WINDOW_S))
        #: 0 disables the corresponding trigger
        self.shed_threshold = max(0, (
            shed_threshold if shed_threshold is not None
            else _env_int(SHED_THRESHOLD_ENV, DEFAULT_SHED_THRESHOLD)))
        self.watchdog_threshold = max(0, (
            watchdog_threshold if watchdog_threshold is not None
            else _env_int(WATCHDOG_THRESHOLD_ENV,
                          DEFAULT_WATCHDOG_THRESHOLD)))
        self.burn_threshold = max(0, (
            burn_threshold if burn_threshold is not None
            else _env_int(BURN_THRESHOLD_ENV, DEFAULT_BURN_THRESHOLD)))
        self.recover_s = max(0.05, (
            recover_s if recover_s is not None
            else _env_float(RECOVER_ENV, DEFAULT_RECOVER_S)))
        self.on_change = on_change
        self._lock = threading.Lock()
        self._sheds: "deque[float]" = deque()
        self._watchdogs: "deque[float]" = deque()
        self._burns: "deque[float]" = deque()
        self._level = 0
        self._peak_level = 0
        self._transitions = 0
        self._last_change = time.monotonic()
        self._last_event = 0.0

    # -- event intake ---------------------------------------------------------
    def record_shed(self) -> None:
        """One request shed for capacity (admission, scheduler queue, or
        a pool with no healthy replica)."""
        self._event(self._sheds)

    def record_watchdog(self) -> None:
        """One dispatch killed by the hung-dispatch watchdog."""
        self._event(self._watchdogs)

    def record_burn(self) -> None:
        """One second of sustained SLO fast-window burn over the page
        threshold (fed by the scope's recorder tick when
        ``SONATA_DEGRADE_ON_BURN`` couples the two) — the ladder reacts
        to user-visible latency, not just sheds."""
        self._event(self._burns)

    def _event(self, dq: "deque[float]") -> None:
        now = time.monotonic()
        stepped_to = None
        with self._lock:
            dq.append(now)
            self._last_event = now
            self._prune_locked(now)
            if self._pressure_locked() and self._level < MAX_LEVEL:
                self._level += 1
                self._peak_level = max(self._peak_level, self._level)
                self._transitions += 1
                self._last_change = now
                # a full fresh window of pressure is needed per step
                self._sheds.clear()
                self._watchdogs.clear()
                self._burns.clear()
                stepped_to = self._level
        if stepped_to is not None:
            self._announce(stepped_to, "pressure")

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        for dq in (self._sheds, self._watchdogs, self._burns):
            while dq and dq[0] < horizon:
                dq.popleft()

    def _pressure_locked(self) -> bool:
        return ((self.shed_threshold > 0
                 and len(self._sheds) >= self.shed_threshold)
                or (self.watchdog_threshold > 0
                    and len(self._watchdogs) >= self.watchdog_threshold)
                or (self.burn_threshold > 0
                    and len(self._burns) >= self.burn_threshold))

    # -- level ----------------------------------------------------------------
    def current_level(self) -> int:
        """The level after lazy hysteresis decay (one step down per quiet
        ``recover_s``); called on every request and metrics scrape."""
        now = time.monotonic()
        stepped_to = None
        with self._lock:
            if (self._level > 0
                    and now - self._last_event >= self.recover_s
                    and now - self._last_change >= self.recover_s):
                self._level -= 1
                self._transitions += 1
                self._last_change = now
                stepped_to = self._level
            level = self._level
        if stepped_to is not None:
            self._announce(stepped_to, "recovery")
        return level

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self.current_level()]

    def reject_heavy(self) -> bool:
        """Level >= 2: batch/long-form work sheds before interactive."""
        return self.current_level() >= 2

    def _announce(self, level: int, why: str) -> None:
        msg = ("degradation level %d (%s) via %s: window=%gs "
               "shed_threshold=%d watchdog_threshold=%d recover=%gs")
        args = (level, LEVEL_NAMES[level], why, self.window_s,
                self.shed_threshold, self.watchdog_threshold,
                self.recover_s)
        (log.warning if why == "pressure" else log.info)(msg, *args)
        cb = self.on_change
        if cb is not None:
            try:
                cb(level, LEVEL_NAMES[level])
            except Exception:
                log.exception("degradation on_change callback failed")

    def snapshot(self) -> dict:
        level = self.current_level()
        with self._lock:
            return {"level": level, "name": LEVEL_NAMES[level],
                    "peak_level": self._peak_level,
                    "transitions": self._transitions,
                    "window_sheds": len(self._sheds),
                    "window_watchdogs": len(self._watchdogs),
                    "window_burns": len(self._burns)}


# ---------------------------------------------------------------------------
# process-global install: deep layers consult/feed the ladder without a
# runtime reference (mirrors tracing's default-tracer pattern)
# ---------------------------------------------------------------------------

_installed: Optional[DegradationLadder] = None


def install(ladder: DegradationLadder) -> None:
    global _installed
    _installed = ladder


def uninstall(ladder: DegradationLadder) -> None:
    """Remove ``ladder`` if it is the installed one (a newer runtime's
    ladder is never clobbered by an older runtime's close)."""
    global _installed
    if _installed is ladder:
        _installed = None


def installed() -> Optional[DegradationLadder]:
    return _installed


def note_shed() -> None:
    ladder = _installed
    if ladder is not None:
        ladder.record_shed()


def note_watchdog() -> None:
    ladder = _installed
    if ladder is not None:
        ladder.record_watchdog()


def note_burn() -> None:
    ladder = _installed
    if ladder is not None:
        ladder.record_burn()


def gather_scale() -> float:
    """Batch-gather window multiplier for the scheduler: 1.0 at normal,
    0.0 at level >= 1 (shrink-coalesce and above dispatch per request)."""
    ladder = _installed
    if ladder is None:
        return 1.0
    return 0.0 if ladder.current_level() >= 1 else 1.0


def force_dispatch_mode() -> bool:
    """Iteration-mode override: at level >= 1 (the same threshold that
    collapses gather windows) new streams fall back from the persistent
    iteration loop to dispatch-granular batching — under pressure the
    simpler wave path sheds predictably, and recovery (hysteresis)
    re-admits iteration mode with no operator action."""
    ladder = _installed
    if ladder is None:
        return False
    return ladder.current_level() >= 1
