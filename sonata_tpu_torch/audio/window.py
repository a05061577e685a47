"""Hann window with a lazy lookup table for power-of-two lengths.

Parity with the reference's ``crates/audio/ops/src/hanning_window.rs``:
lengths {64, 128, 256, 512, 1024, 2048, 4096} are cached on first use
(``hanning_window.rs:4-13``); other lengths are computed on demand.  The
reference computes half the window and mirrors it (``:54-78``) — numpy's
vectorized cosine makes that micro-optimization unnecessary, but we keep the
symmetric ("periodic=False") definition it produces.
"""

from __future__ import annotations

import threading

import numpy as np

_CACHED_LENGTHS = frozenset({64, 128, 256, 512, 1024, 2048, 4096})
_cache: dict[int, np.ndarray] = {}
_lock = threading.Lock()


def _compute(n: int) -> np.ndarray:
    if n <= 1:
        return np.ones(max(n, 0), dtype=np.float32)
    k = np.arange(n, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / (n - 1)))
    return w.astype(np.float32)


def get_hann_window(n: int) -> np.ndarray:
    """Return a Hann window of length ``n`` (``hanning_window.rs:31``)."""
    if n in _CACHED_LENGTHS:
        w = _cache.get(n)
        if w is None:
            with _lock:
                w = _cache.get(n)
                if w is None:
                    w = _compute(n)
                    _cache[n] = w
        return w
    return _compute(n)
