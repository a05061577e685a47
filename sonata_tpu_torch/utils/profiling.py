"""Observability: RTF counters, histograms and profiler trace capture.

Port of ``sonata_tpu/utils/profiling.py``.  The RTF counters, the
histograms and :func:`timed` are the JAX module's; :func:`trace` and
:func:`capture_profile` capture a ``torch.profiler`` trace (host activity,
and the card's kernels when CUDA is available) into a Chrome trace file in
``log_dir`` (view it in Perfetto or ``chrome://tracing``), where the JAX
module captured a ``jax.profiler`` device trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class RtfStats:
    utterances: int = 0
    audio_ms: float = 0.0
    inference_ms: float = 0.0

    @property
    def rtf(self) -> float:
        return self.inference_ms / self.audio_ms if self.audio_ms else 0.0

    @property
    def audio_seconds_per_second(self) -> float:
        return 1.0 / self.rtf if self.rtf else 0.0


class RtfCounter:
    """Thread-safe aggregate RTF accounting (e.g. one per gRPC server)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats = RtfStats()

    def record(self, audio) -> None:
        """Record one synthesized :class:`~sonata_tpu_torch.audio.Audio`."""
        with self._lock:
            self._stats.utterances += 1
            self._stats.audio_ms += audio.duration_ms()
            self._stats.inference_ms += audio.inference_ms

    def snapshot(self) -> RtfStats:
        with self._lock:
            return RtfStats(self._stats.utterances, self._stats.audio_ms,
                            self._stats.inference_ms)

    def reset(self) -> None:
        with self._lock:
            self._stats = RtfStats()


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


#: the file :func:`trace` writes into its ``log_dir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (Chrome trace format): host activity, and the
    card's kernels and copies when CUDA is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


#: the torch profiler cannot nest captures; serialize /debug/profile hits
_PROFILE_LOCK = threading.Lock()


def capture_profile(seconds: float, log_dir: Optional[str] = None) -> str:
    """Capture a ``torch.profiler`` trace for ``seconds`` and return the
    log directory (``trace.json`` inside; view with Perfetto).

    What the metrics plane's ``/debug/profile?seconds=`` endpoint runs:
    the tracing layer answers *where a request's wall time went*; this
    answers *what the device was doing meanwhile*.  Raises
    ``RuntimeError`` when a capture is already running (the profiler
    cannot nest).
    """
    import tempfile

    seconds = min(max(float(seconds), 0.1), 60.0)
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="sonata_profile_")
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running")
    try:
        with trace(log_dir):
            time.sleep(seconds)
    finally:
        _PROFILE_LOCK.release()
    return log_dir


@contextlib.contextmanager
def timed(label: str, sink: Optional[list] = None) -> Iterator[None]:
    """Wall-clock a block; append ``(label, seconds)`` to ``sink`` or log."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, dt))
        else:
            import logging

            logging.getLogger("sonata.profiling").debug(
                "%s: %.1f ms", label, dt * 1e3)
