"""Backend-adaptive dispatch policy: probe-driven coalescing defaults.

Port of ``sonata_tpu/utils/dispatch_policy.py`` to PyTorch.  The stream
coalescers, the iteration loop and the batch scheduler pay off where a
batched dispatch costs about what batch 1 costs, as on a GPU: N concurrent
requests funneled into ONE padded device call turn contention into
throughput.  On the CPU the same machinery loses: the rows of a batch run
about serially, the canonical-batch padding is real compute, and the gather
window is pure added latency.  So:

- :func:`probe_dispatch_scaling` — a one-time, process-cached probe per
  (backend, device, voice shape): time ``tanh(x @ w)`` four times over
  ``[1|n, 32, C]`` on the voice's device, both shapes warmed first (cuBLAS
  handle creation and the allocator's first touch excluded), each timed call
  bracketed by ``torch.cuda.synchronize()`` on a CUDA device; the cost splits
  into per-dispatch overhead and per-item scaling.
- :func:`resolve_policy` — concrete knobs for both stream coalescers
  (``models/piper.py``), the iteration loop, the
  :class:`~sonata_tpu_torch.synth.scheduler.BatchScheduler`, and the
  canonical stream batch (:mod:`.buckets`).  The backend is the voice
  device's type: ``"cpu"`` takes the per-request fast path (batch 1, no
  gather window) with no probe; ``"cuda"`` takes the coalescing defaults,
  with the probe refining the gather windows.

Env overrides always win over the probe:

- ``SONATA_STREAM_COALESCE=0|1`` (legacy knob, highest precedence;
  honored only when explicitly set): 0 → per-request dispatch, 1 →
  force the coalescing defaults.
- ``SONATA_DISPATCH_POLICY=auto|on|off``: ``on``/``off`` force the
  corresponding shape; ``auto`` (default) applies the backend fast path
  + probe.

The JAX module's ``should_donate`` (XLA buffer donation) has no PyTorch
counterpart: eager PyTorch frees a dead input when its last reference
drops, so it is left out.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

import torch

from ..device import resolve_device
from .buckets import canonical_dispatch_batch

log = logging.getLogger("sonata.dispatch")

#: Tuned accelerator defaults — the constants the JAX package's coalescers
#: and scheduler ship with; unit-test-pinned against its table.
COALESCING_DEFAULTS = {
    "stream_decode_max_batch": 8,
    "stream_decode_max_wait_ms": 2.0,
    "stream_stage_max_batch": 8,
    "stream_stage_max_wait_ms": 8.0,
    "scheduler_max_batch": 16,
    "scheduler_max_wait_ms": 5.0,
}

#: Below this measured parallel speedup at the probe batch, batching N
#: items into one dispatch costs about what N serial dispatches cost —
#: coalescing then buys nothing and its padding/gather-window overhead
#: makes it a net loss.
MIN_BATCH_SPEEDUP = 1.5


@dataclass(frozen=True)
class ProbeResult:
    """One dispatch-scaling measurement on a backend.

    ``t1_ms``/``tn_ms``: best-of-reps wall time of the probe program at
    batch 1 and batch ``n``.  The linear split ``t(b) ≈ per_dispatch_ms
    + b * per_item_ms`` is what the policy consumes: ``batch_speedup =
    n * t1 / tn`` is the parallel efficiency of batching (n on an ideal
    accelerator, →1.0 on a serial backend).
    """

    backend: str
    n: int
    t1_ms: float
    tn_ms: float

    @property
    def per_item_ms(self) -> float:
        return max((self.tn_ms - self.t1_ms) / max(self.n - 1, 1), 0.0)

    @property
    def per_dispatch_ms(self) -> float:
        return max(self.t1_ms - self.per_item_ms, 0.0)

    @property
    def batch_speedup(self) -> float:
        return self.n * self.t1_ms / max(self.tn_ms, 1e-9)

    def as_dict(self) -> dict:
        d = asdict(self)
        d.update(per_item_ms=round(self.per_item_ms, 4),
                 per_dispatch_ms=round(self.per_dispatch_ms, 4),
                 batch_speedup=round(self.batch_speedup, 3))
        return d


@dataclass(frozen=True)
class DispatchPolicy:
    """Concrete dispatch knobs for one (backend, voice-shape).

    ``coalesce`` is the headline decision; the per-subsystem knobs are
    what :class:`~sonata_tpu_torch.models.piper.PiperVoice`, the stream
    coalescers, and the batch scheduler actually consume.  ``source``
    records *why* (env override / backend fast path / probe).
    """

    backend: str
    coalesce: bool
    source: str
    stream_decode_max_batch: int = 8
    stream_decode_max_wait_ms: float = 2.0
    stream_stage_max_batch: int = 8
    stream_stage_max_wait_ms: float = 8.0
    scheduler_max_batch: int = 16
    scheduler_max_wait_ms: float = 5.0
    probe: Optional[ProbeResult] = field(default=None, compare=False)

    # -- consumer views --------------------------------------------------
    def stream_decode_kwargs(self) -> dict:
        return {"max_batch": self.stream_decode_max_batch,
                "max_wait_ms": self.stream_decode_max_wait_ms}

    def stream_stage_kwargs(self) -> dict:
        return {"max_batch": self.stream_stage_max_batch,
                "max_wait_ms": self.stream_stage_max_wait_ms}

    def scheduler_kwargs(self) -> dict:
        return {"max_batch": self.scheduler_max_batch,
                "max_wait_ms": self.scheduler_max_wait_ms}

    def as_dict(self) -> dict:
        """Observability view (logs, smoke lines)."""
        d = asdict(self)
        d["probe"] = self.probe.as_dict() if self.probe else None
        return d

    def describe(self) -> str:
        """One log line: the decision and where it came from."""
        return (f"dispatch policy [{self.backend}]: "
                f"coalesce={'on' if self.coalesce else 'off'} "
                f"(decode b{self.stream_decode_max_batch}/"
                f"{self.stream_decode_max_wait_ms:g}ms, "
                f"stage b{self.stream_stage_max_batch}/"
                f"{self.stream_stage_max_wait_ms:g}ms, "
                f"sched b{self.scheduler_max_batch}/"
                f"{self.scheduler_max_wait_ms:g}ms) via {self.source}")


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

_PROBE_CACHE: dict = {}
_PROBE_LOCK = threading.Lock()


def _default_backend(device=None) -> str:
    """The voice device's type: ``"cuda"`` or ``"cpu"``."""
    return resolve_device(device).type


def _time_best(fn, reps: int, sync: Callable[[], None]) -> float:
    """Best-of-``reps`` wall time of one call, ms, the device drained
    before and after each."""
    best = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best * 1000.0


@torch.inference_mode()
def probe_dispatch_scaling(shape_key: tuple = (), *, n: int = 8,
                           reps: int = 5, backend: Optional[str] = None,
                           device=None) -> ProbeResult:
    """Measure per-dispatch overhead vs per-item scaling on ``device``,
    once per (backend, device, voice shape, n); later calls return the
    cached result.

    The probe program is a tiny decode-shaped stack (four matmul + tanh
    layers over [b, 32, C]).  ``shape_key``'s first element (the voice's
    latent channel count) sizes C, bounded, so distinct voice shapes
    measure distinct programs.  Both shapes run once before timing, and
    best-of-``reps`` suppresses scheduler noise on loaded hosts.
    """
    device = resolve_device(device)
    backend = backend or device.type
    key = (backend, str(device), tuple(shape_key), n)
    with _PROBE_LOCK:
        cached = _PROBE_CACHE.get(key)
    if cached is not None:
        return cached

    T = 32
    C = 64
    if shape_key and isinstance(shape_key[0], int):
        C = max(16, min(int(shape_key[0]), 512))

    def tick(x, w):
        for _ in range(4):
            x = torch.tanh(x @ w)
        return x

    if device.type == "cuda":
        def sync():
            torch.cuda.synchronize(device)
    else:
        def sync():
            pass

    w = torch.eye(C, dtype=torch.float32, device=device) * 0.5
    x1 = torch.ones((1, T, C), dtype=torch.float32, device=device)
    xn = torch.ones((n, T, C), dtype=torch.float32, device=device)
    # warm both shapes (cuBLAS handle creation, first allocation excluded)
    tick(x1, w)
    tick(xn, w)
    sync()
    result = ProbeResult(backend=backend, n=n,
                         t1_ms=_time_best(lambda: tick(x1, w), reps, sync),
                         tn_ms=_time_best(lambda: tick(xn, w), reps, sync))
    with _PROBE_LOCK:
        # first writer wins; a concurrent duplicate probe is harmless
        cached = _PROBE_CACHE.setdefault(key, result)
    log.debug("dispatch probe %s: t1=%.3fms tn=%.3fms speedup=%.2fx",
              key, cached.t1_ms, cached.tn_ms, cached.batch_speedup)
    return cached


def _clear_probe_cache() -> None:
    """Test hook."""
    with _PROBE_LOCK:
        _PROBE_CACHE.clear()


# ---------------------------------------------------------------------------
# policy resolution
# ---------------------------------------------------------------------------

def _per_request_policy(backend: str, source: str,
                        probe: Optional[ProbeResult] = None
                        ) -> DispatchPolicy:
    """The reference's thread-per-stream shape (grpc/src/main.rs:381-409):
    batch 1, zero gather window, scheduler pass-through."""
    return DispatchPolicy(
        backend=backend, coalesce=False, source=source, probe=probe,
        stream_decode_max_batch=1, stream_decode_max_wait_ms=0.0,
        stream_stage_max_batch=1, stream_stage_max_wait_ms=0.0,
        scheduler_max_batch=1, scheduler_max_wait_ms=0.0)


def _clamp(x: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, x))


def _coalescing_policy(backend: str, source: str,
                       probe: Optional[ProbeResult] = None
                       ) -> DispatchPolicy:
    """The accelerator defaults; with a probe, the gather windows scale
    with measured per-dispatch overhead, floored at the pinned defaults
    so a fast local card keeps the exact shipped constants."""
    d = dict(COALESCING_DEFAULTS)
    if probe is not None:
        ovh = probe.per_dispatch_ms
        d["stream_decode_max_wait_ms"] = _clamp(
            2.0 * ovh, d["stream_decode_max_wait_ms"], 10.0)
        d["stream_stage_max_wait_ms"] = _clamp(
            4.0 * ovh, d["stream_stage_max_wait_ms"], 25.0)
        d["scheduler_max_wait_ms"] = _clamp(
            2.0 * ovh, d["scheduler_max_wait_ms"], 15.0)
    # canonical-batch rule: the coalescers pad every multi-request group
    # to ONE batch size, which must be a batch bucket
    for k in ("stream_decode_max_batch", "stream_stage_max_batch",
              "scheduler_max_batch"):
        d[k] = canonical_dispatch_batch(int(d[k]))
    return DispatchPolicy(backend=backend, coalesce=True, source=source,
                          probe=probe, **d)


def resolve_policy(shape_key: tuple = (), *,
                   backend: Optional[str] = None,
                   device=None,
                   env: Optional[dict] = None,
                   probe_fn: Optional[Callable[..., ProbeResult]] = None
                   ) -> DispatchPolicy:
    """Resolve the dispatch policy for one voice on ``device``.

    Precedence (each layer wins over everything below it):

    1. ``SONATA_STREAM_COALESCE`` **explicitly set** — ``0`` →
       per-request dispatch, anything else → coalescing defaults.
    2. ``SONATA_DISPATCH_POLICY=on|off`` — forced shape, no probe.
    3. ``auto`` (default): backend fast path — ``"cpu"`` serves
       per-request without paying a probe; ``"cuda"`` runs the cached
       :func:`probe_dispatch_scaling` on ``device`` and keeps coalescing
       only if the measured batch speedup clears
       :data:`MIN_BATCH_SPEEDUP`.

    ``backend`` (default: ``device``'s type), ``env`` and ``probe_fn``
    exist for tests (stubbed devices, counted probes).
    """
    env = os.environ if env is None else env
    backend = backend or _default_backend(device)
    probe_fn = probe_fn or probe_dispatch_scaling

    legacy = env.get("SONATA_STREAM_COALESCE")
    if legacy is not None:
        if legacy == "0":
            return _per_request_policy(
                backend, "env:SONATA_STREAM_COALESCE=0")
        return _coalescing_policy(
            backend, f"env:SONATA_STREAM_COALESCE={legacy}")

    mode = env.get("SONATA_DISPATCH_POLICY", "auto").lower()
    if mode not in ("auto", "on", "off"):
        log.warning("invalid SONATA_DISPATCH_POLICY=%r (use auto|on|off); "
                    "falling back to auto", mode)
        mode = "auto"
    if mode == "on":
        return _coalescing_policy(backend, "env:SONATA_DISPATCH_POLICY=on")
    if mode == "off":
        return _per_request_policy(backend, "env:SONATA_DISPATCH_POLICY=off")

    # -- auto ------------------------------------------------------------
    if backend == "cpu":
        # fast path: no probe; the CPU runs batch rows about serially, so
        # the coalescers' padding + gather window are pure overhead
        return _per_request_policy(backend, "auto:cpu-backend")
    try:
        probe = probe_fn(shape_key, backend=backend, device=device)
    except Exception as e:  # a broken probe must never block serving
        log.warning("dispatch probe failed (%s); keeping coalescing "
                    "defaults", e)
        return _coalescing_policy(backend, "auto:probe-failed")
    if probe.batch_speedup < MIN_BATCH_SPEEDUP:
        return _per_request_policy(
            backend, f"auto:probe-speedup-{probe.batch_speedup:.2f}x",
            probe=probe)
    return _coalescing_policy(
        backend, f"auto:probe-speedup-{probe.batch_speedup:.2f}x",
        probe=probe)
