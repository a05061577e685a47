"""Bounded-bucket histograms for serving metrics.

The histogram half of the JAX package's ``utils/profiling.py``, copied as
it is (the batch scheduler's queue-wait histogram uses it); its profiler
capture is not ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

#: Default latency buckets (seconds): 5 ms .. 30 s, roughly 2.5x apart.
#: Spans a TTFB on a warm accelerator (~tens of ms) through a cold-compile
#: first request (tens of seconds); everything beyond lands in +Inf.
DEFAULT_LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                             1.0, 2.5, 5.0, 10.0, 30.0)

#: Queue-wait buckets (seconds): a request's time in the batch scheduler
#: queue is normally sub-millisecond (the gather window) but stretches to
#: seconds when the voice is backed up — the low end needs resolution the
#: latency buckets don't have.
QUEUE_WAIT_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


@dataclass
class HistogramSnapshot:
    """Point-in-time copy of a :class:`Histogram` (cumulative counts)."""

    buckets: tuple  # upper bounds, seconds (excluding +Inf)
    counts: tuple   # cumulative count per bound, then the +Inf total last
    total: int
    sum: float


class Histogram:
    """Thread-safe bounded-bucket histogram (Prometheus-style cumulative).

    Fixed bucket bounds chosen at construction keep memory constant no
    matter how many observations arrive — the property that makes it safe
    as an always-on serving metric (vs. recording raw samples).
    """

    def __init__(self, buckets=None):
        bounds = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS_S))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    @property
    def bounds(self) -> tuple:
        return self._bounds

    def observe(self, value: float) -> None:
        # linear scan: bucket lists are ~a dozen entries, and the scan is
        # cheaper than bisect's function-call overhead at this size
        idx = len(self._bounds)
        for i, b in enumerate(self._bounds):
            if value <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._total += 1

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            counts = list(self._counts)
            total, s = self._total, self._sum
        # cumulative counts, Prometheus exposition semantics
        cum = []
        running = 0
        for c in counts:
            running += c
            cum.append(running)
        return HistogramSnapshot(buckets=self._bounds, counts=tuple(cum),
                                 total=total, sum=s)
