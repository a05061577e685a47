"""Streaming quantile sketches with rolling time windows.

The serving plane's histograms (:mod:`~sonata_tpu_torch.utils.profiling`) are
cumulative-forever: they answer "what was TTFB p99 *since boot*", which
goes stale the moment traffic changes.  The aggregation layer
(:mod:`.scope`) needs "p99 over the last five minutes" — a windowed
quantile — without keeping raw samples.  This module provides the two
primitives:

- :class:`QuantileSketch` — a DDSketch-style log-bucketed sketch
  (Masson et al., VLDB '19): values map to geometric buckets
  ``gamma**i``, so any reported quantile is within a configurable
  *relative* error (default 1%) of the true value, memory is bounded
  (lowest buckets collapse past ``max_bins``), and two sketches
  **merge** by adding bucket counts — the property that makes rolling
  windows cheap.
- :class:`RollingSketch` — a ring of per-slot sketches covering one
  time window (e.g. 12 × 5 s slots = 1 minute).  ``add`` writes the
  current slot; ``merged`` combines the live slots, so expiry is
  O(slots) bookkeeping, never a rescan of observations.
- :class:`RollingCounter` — the same ring for plain good/bad counts
  (what the SLO burn-rate math consumes).

Everything takes an injectable ``clock`` so the window-expiry tests run
on a fake clock instead of sleeping.

**Cross-process export**: every container serializes to a
compact versioned payload — bucket *bins* and slot *epochs*, never raw
samples — via ``export()``, and imports fold back with
:func:`merged_from_export` / :func:`totals_from_export`.  Because merge
is bucket-wise addition, a fleet sketch merged from N nodes' exports is
*identical* to the sketch of the pooled observations, so fleet
quantiles inherit the same relative-error guarantee (the pinned
cross-process bound in tests/test_fleetscope.py).  Slot epochs are
re-based to the importer's clock through the exporter's own
``now_epoch`` (monotonic clocks are not comparable across hosts, ages
are), and a version or accuracy mismatch raises the typed
:class:`SketchImportError` — folding incompatible bins silently would
corrupt every fleet quantile downstream.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

#: smallest value (seconds) the sketch distinguishes from zero; serving
#: latencies below a microsecond are all "instant" for SLO purposes
MIN_TRACKED = 1e-6

DEFAULT_RELATIVE_ACCURACY = 0.01
DEFAULT_MAX_BINS = 512

#: version stamp on every export payload; importers reject anything else
#: (typed, loud) instead of folding bins whose meaning may have changed
EXPORT_VERSION = 1


class SketchImportError(ValueError):
    """An export payload this build cannot import: unknown version,
    incompatible relative accuracy (bucket keys are only comparable
    between sketches sharing one gamma), or a malformed document.
    Typed so cross-process importers (the sonata-mesh fleet scraper)
    fail loudly per node instead of quietly merging garbage into
    fleet-wide quantiles."""


def _check_version(data, what: str) -> None:
    if not isinstance(data, dict):
        raise SketchImportError(
            f"{what} export must be a dict, got {type(data).__name__}")
    v = data.get("v")
    if v != EXPORT_VERSION:
        raise SketchImportError(
            f"{what} export version {v!r} is not importable by this "
            f"build (speaks version {EXPORT_VERSION})")


class QuantileSketch:
    """Fixed-memory mergeable quantile sketch (relative-error bound).

    Not thread-safe by itself: callers (:class:`RollingSketch`, tests)
    hold their own lock.  ``quantile(q)`` returns a value within
    ``relative_accuracy`` of the true q-quantile of everything added.
    """

    __slots__ = ("relative_accuracy", "_gamma", "_log_gamma", "_max_bins",
                 "_bins", "_zero_count", "count", "sum", "min", "max")

    def __init__(self, relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
                 max_bins: int = DEFAULT_MAX_BINS):
        if not 0.0 < relative_accuracy < 1.0:
            raise ValueError("relative_accuracy must be in (0, 1)")
        self.relative_accuracy = relative_accuracy
        self._gamma = (1.0 + relative_accuracy) / (1.0 - relative_accuracy)
        self._log_gamma = math.log(self._gamma)
        self._max_bins = max(8, int(max_bins))
        self._bins: Dict[int, int] = {}
        self._zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording -----------------------------------------------------------
    def _key(self, value: float) -> int:
        return math.ceil(math.log(value) / self._log_gamma)

    def add(self, value: float, count: int = 1) -> None:
        if count <= 0:
            return
        value = float(value)
        self.count += count
        self.sum += value * count
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value < MIN_TRACKED:
            self._zero_count += count
            return
        key = self._key(value)
        self._bins[key] = self._bins.get(key, 0) + count
        if len(self._bins) > self._max_bins:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the lowest buckets together until within ``max_bins``.

        Collapsing the *low* end sacrifices resolution where SLO math
        never looks (the fast tail), keeping the p9x buckets exact."""
        keys = sorted(self._bins)
        while len(keys) > self._max_bins:
            lowest = keys.pop(0)
            self._bins[keys[0]] = (self._bins.get(keys[0], 0)
                                   + self._bins.pop(lowest))

    def merge(self, other: "QuantileSketch") -> None:
        """Fold ``other`` into self (bucket-wise addition)."""
        if other.count == 0:
            return
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self._zero_count += other._zero_count
        for key, c in other._bins.items():
            self._bins[key] = self._bins.get(key, 0) + c
        if len(self._bins) > self._max_bins:
            self._collapse()

    # -- queries -------------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (0 <= q <= 1), or None while empty."""
        if self.count == 0:
            return None
        q = min(max(q, 0.0), 1.0)
        rank = q * (self.count - 1)
        if rank < self._zero_count:
            return 0.0
        running = self._zero_count
        for key in sorted(self._bins):
            running += self._bins[key]
            if running > rank:
                # geometric bucket midpoint: within relative_accuracy of
                # anything that mapped into bucket ``key``
                return (2.0 * self._gamma ** key) / (self._gamma + 1.0)
        return self.max if self.max > -math.inf else None

    def count_above(self, threshold: float) -> int:
        """How many observations exceeded ``threshold`` (bucket-granular:
        accurate to the sketch's relative error)."""
        if threshold < MIN_TRACKED:
            return self.count - self._zero_count
        cut = self._key(threshold)
        return sum(c for key, c in self._bins.items() if key > cut)

    def to_dict(self) -> dict:
        return {"count": self.count,
                "sum": round(self.sum, 6),
                "min": None if self.count == 0 else round(self.min, 6),
                "max": None if self.count == 0 else round(self.max, 6),
                "p50": _round(self.quantile(0.5)),
                "p90": _round(self.quantile(0.9)),
                "p99": _round(self.quantile(0.99))}

    # -- cross-process export --------------------------------------------------
    def export(self) -> dict:
        """Versioned, JSON-safe payload: bins + counts, never samples.
        Bin keys serialize as strings (JSON object keys)."""
        return export_quantile_sketch(self)

    @classmethod
    def from_export(cls, data) -> "QuantileSketch":
        """Rebuild from :meth:`export` output; raises the typed
        :class:`SketchImportError` on version mismatch or malformed
        payloads."""
        _check_version(data, "QuantileSketch")
        try:
            sk = cls(float(data["ra"]))
            for k, c in dict(data["bins"]).items():
                sk._bins[int(k)] = int(c)
            sk._zero_count = int(data["zero"])
            sk.count = int(data["count"])
            sk.sum = float(data["sum"])
            if sk.count > 0:
                sk.min = float(data["min"])
                sk.max = float(data["max"])
        except (KeyError, TypeError, ValueError) as e:
            raise SketchImportError(
                f"malformed QuantileSketch export: {e}") from None
        if len(sk._bins) > sk._max_bins:
            sk._collapse()
        return sk

    def merge_export(self, data) -> None:
        """Fold an exported sketch into self.  Accuracy must match:
        bucket key ``i`` means ``gamma**i`` and gammas differing means
        the same key names a different value — silently adding such bins
        would shift every downstream quantile."""
        other = QuantileSketch.from_export(data)
        if abs(other.relative_accuracy - self.relative_accuracy) > 1e-12:
            raise SketchImportError(
                f"cannot merge sketch with relative_accuracy="
                f"{other.relative_accuracy} into one with "
                f"{self.relative_accuracy}: bucket keys are incompatible")
        self.merge(other)


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)


def export_quantile_sketch(sk: "QuantileSketch") -> dict:
    """Serialize one sketch (the :meth:`QuantileSketch.export` body).

    A module function — not a method call — so the ring containers can
    serialize their slot sketches while holding their slot lock without
    the serializer sharing a bare name with the lock-taking ring
    ``export`` methods (the repo-wide lock-order pass resolves calls by
    bare name, like the mesh ``view()``/``snapshot()`` note)."""
    return {"v": EXPORT_VERSION,
            "ra": sk.relative_accuracy,
            "bins": {str(k): c for k, c in sk._bins.items()},
            "zero": sk._zero_count,
            "count": sk.count,
            "sum": sk.sum,
            "min": None if sk.count == 0 else sk.min,
            "max": None if sk.count == 0 else sk.max}


class _SlotRing:
    """Shared slot bookkeeping for the rolling containers.

    The ring holds ``slots + 1`` entries: the write slot plus a full
    window of read slots, so a query never includes observations older
    than ``window_s`` by more than one slot duration."""

    def __init__(self, window_s: float, slots: int, clock=None):
        if window_s <= 0 or slots <= 0:
            raise ValueError("window_s and slots must be positive")
        self.window_s = float(window_s)
        self.slots = int(slots)
        self.slot_s = self.window_s / self.slots
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        #: slot index -> (epoch, payload); epoch = int(now / slot_s)
        self._ring: Dict[int, tuple] = {}

    def _epoch(self) -> int:
        return int(self._clock() / self.slot_s)

    def _current(self, factory):
        """The (epoch, payload) pair for the write slot, creating or
        recycling it as the clock advances.  Caller holds the lock."""
        epoch = self._epoch()
        idx = epoch % (self.slots + 1)
        entry = self._ring.get(idx)
        if entry is None or entry[0] != epoch:
            entry = (epoch, factory())
            self._ring[idx] = entry
        return entry

    def _live(self):
        """Payloads of every non-expired slot.  Caller holds the lock."""
        now_epoch = self._epoch()
        return [payload for epoch, payload in self._ring.values()
                if now_epoch - epoch <= self.slots]


class RollingSketch(_SlotRing):
    """A :class:`QuantileSketch` over a rolling time window."""

    def __init__(self, window_s: float, slots: int = 12, *,
                 relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY,
                 clock=None):
        super().__init__(window_s, slots, clock=clock)
        self._accuracy = relative_accuracy
        #: bumped on every add — lets consumers (the scope's per-scrape
        #: merge memo) invalidate on new data instead of guessing a TTL
        self.generation = 0

    def _factory(self) -> QuantileSketch:
        return QuantileSketch(self._accuracy)

    def add(self, value: float) -> None:
        with self._lock:
            self.generation += 1
            self._current(self._factory)[1].add(value)

    def merged(self) -> QuantileSketch:
        """One sketch combining every live slot (cheap: bucket adds).

        The whole merge runs under the ring lock: a live slot's bin dict
        is still being written by concurrent ``add`` calls, and merging
        it unlocked races dict iteration against insertion."""
        out = QuantileSketch(self._accuracy)
        with self._lock:
            for sketch in self._live():
                out.merge(sketch)
        return out

    def export(self) -> dict:
        """Versioned ring payload: per-slot bins + slot epochs, plus the
        exporter's ``now_epoch`` so the importer can turn epochs into
        *ages* (monotonic epochs are process-local; ages cross hosts).
        Runs wholly under the ring lock for the same reason as
        :meth:`merged`."""
        with self._lock:
            now_epoch = self._epoch()
            ring = [{"epoch": epoch,
                     "sketch": export_quantile_sketch(payload)}
                    for epoch, payload in self._ring.values()
                    if now_epoch - epoch <= self.slots]
        return {"v": EXPORT_VERSION, "kind": "sketch",
                "window_s": self.window_s, "slots": self.slots,
                "ra": self._accuracy, "now_epoch": now_epoch,
                "ring": ring}


class RollingCounter(_SlotRing):
    """Good/bad event counts over a rolling time window (SLO feed)."""

    def __init__(self, window_s: float, slots: int = 12, *, clock=None):
        super().__init__(window_s, slots, clock=clock)

    @staticmethod
    def _factory() -> list:
        return [0, 0]  # [good, bad]

    def record(self, *, bad: bool, count: int = 1) -> None:
        with self._lock:
            self._current(self._factory)[1][1 if bad else 0] += count

    def totals(self) -> tuple:
        """(good, bad) over the live window (summed under the lock so
        the pair can't tear against a concurrent ``record``)."""
        with self._lock:
            live = self._live()
            good = sum(slot[0] for slot in live)
            bad = sum(slot[1] for slot in live)
        return good, bad

    def bad_fraction(self) -> Optional[float]:
        """bad / (good + bad), or None with no observations."""
        good, bad = self.totals()
        total = good + bad
        if total == 0:
            return None
        return bad / total

    def export(self) -> dict:
        """Versioned ring payload (good/bad per slot + slot epochs) —
        the counter twin of :meth:`RollingSketch.export`."""
        with self._lock:
            now_epoch = self._epoch()
            ring = [{"epoch": epoch, "good": payload[0], "bad": payload[1]}
                    for epoch, payload in self._ring.values()
                    if now_epoch - epoch <= self.slots]
        return {"v": EXPORT_VERSION, "kind": "counter",
                "window_s": self.window_s, "slots": self.slots,
                "now_epoch": now_epoch, "ring": ring}


# ---------------------------------------------------------------------------
# ring-export importers (the router side of the fleet hop)
# ---------------------------------------------------------------------------

def _ring_meta(data, what: str) -> tuple:
    _check_version(data, what)
    try:
        window_s = float(data["window_s"])
        slots = int(data["slots"])
        now_epoch = int(data["now_epoch"])
        ring = list(data["ring"])
    except (KeyError, TypeError, ValueError) as e:
        raise SketchImportError(f"malformed {what} export: {e}") from None
    if window_s <= 0 or slots <= 0:
        raise SketchImportError(
            f"malformed {what} export: window_s={window_s} slots={slots}")
    return window_s, slots, now_epoch, ring


def ring_from_export(data) -> Tuple[float, float, List[tuple]]:
    """Parse a :meth:`RollingSketch.export` payload into
    ``(window_s, slot_s, [(age_s, QuantileSketch), ...])`` where
    ``age_s`` is the slot's age *at export time*.  The caller adds its
    own scrape age before expiring slots against the window.  Raises
    :class:`SketchImportError` (typed, loud) on any malformed entry —
    validation happens at import, not lazily at query time."""
    window_s, slots, now_epoch, ring = _ring_meta(data, "RollingSketch")
    slot_s = window_s / slots
    out: List[tuple] = []
    for entry in ring:
        try:
            age_s = (now_epoch - int(entry["epoch"])) * slot_s
            sketch = QuantileSketch.from_export(entry["sketch"])
        except (KeyError, TypeError, ValueError) as e:
            raise SketchImportError(
                f"malformed RollingSketch slot: {e}") from None
        if age_s <= window_s:  # anything older exports as expired: no-op
            out.append((age_s, sketch))
    return window_s, slot_s, out


def merged_from_export(data, *, extra_age_s: float = 0.0,
                       relative_accuracy: Optional[float] = None
                       ) -> QuantileSketch:
    """One sketch folding a :meth:`RollingSketch.export` payload,
    expiring slots whose export-time age plus ``extra_age_s`` (the
    importer's scrape staleness) exceeds the window.  An empty or
    fully-expired export merges as a no-op (count 0)."""
    window_s, slot_s, ring = ring_from_export(data)
    ra = (relative_accuracy if relative_accuracy is not None
          else float(data.get("ra", DEFAULT_RELATIVE_ACCURACY)))
    out = QuantileSketch(ra)
    for age_s, sketch in ring:
        if age_s + extra_age_s > window_s:
            continue
        if abs(sketch.relative_accuracy - ra) > 1e-12:
            raise SketchImportError(
                f"slot relative_accuracy {sketch.relative_accuracy} != "
                f"ring accuracy {ra}")
        out.merge(sketch)
    return out


def counter_ring_from_export(data) -> Tuple[float, float, List[tuple]]:
    """Parse a :meth:`RollingCounter.export` payload into
    ``(window_s, slot_s, [(age_s, good, bad), ...])`` — the counter
    twin of :func:`ring_from_export`, validated whole at import."""
    window_s, slots, now_epoch, ring = _ring_meta(data, "RollingCounter")
    slot_s = window_s / slots
    out: List[tuple] = []
    for entry in ring:
        try:
            age_s = (now_epoch - int(entry["epoch"])) * slot_s
            g, b = int(entry["good"]), int(entry["bad"])
        except (KeyError, TypeError, ValueError) as e:
            raise SketchImportError(
                f"malformed RollingCounter slot: {e}") from None
        if age_s <= window_s:
            out.append((age_s, g, b))
    return window_s, slot_s, out


def totals_from_export(data, *, extra_age_s: float = 0.0) -> tuple:
    """(good, bad) folding a :meth:`RollingCounter.export` payload with
    the same age-expiry contract as :func:`merged_from_export`."""
    window_s, _slot_s, ring = counter_ring_from_export(data)
    good = bad = 0
    for age_s, g, b in ring:
        if age_s + extra_age_s > window_s:
            continue
        good += g
        bad += b
    return good, bad
