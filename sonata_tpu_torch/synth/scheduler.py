"""Continuous batching: coalesce concurrent synthesis requests into shared
device dispatches.

The reference serves concurrent gRPC requests by giving each its own
blocking thread (``grpc/src/main.rs:381-409``) — each utterance runs its
own ONNX session call.  On TPU that wastes the device: a single dispatch
for 16 sentences costs nearly the same wall time as for one (latency-bound;
see SURVEY §7 step 5 "continuous batching across concurrent requests").

:class:`BatchScheduler` keeps a queue of (sentence, speaker, scales,
deadline, future) tuples; a worker collects up to ``max_batch`` sentences
— waiting at most ``max_wait_ms`` after the first — and issues one
``speak_batch`` with the per-row speakers and scales.  Under load,
throughput approaches full-batch efficiency; idle, a lone request pays
only the wait window.

Since the batching-core unification this class is a thin owner over
:class:`~sonata_tpu_torch.synth.batching.BatchingCore` — the queueing, gather,
deadline-drop-before-pack, crash-containment, and drain contracts live
there (shared with the streaming coalescers); this module keeps only the
scheduler's policy: request validation, the model call with its
trace/scope attribution, and the watchdog conviction handling.

Serving-runtime integration (:mod:`sonata_tpu_torch.serving`):

- the queue is **bounded** (``max_queue``, default
  ``SONATA_SCHED_MAX_QUEUE`` or 1024); a full queue sheds with
  :class:`~sonata_tpu_torch.serving.Overloaded` instead of growing without
  limit — defense in depth behind the frontend admission controller;
- items may carry a :class:`~sonata_tpu_torch.serving.Deadline`; the gather
  loop drops expired or client-cancelled items *before* packing a device
  dispatch (their futures fail with
  :class:`~sonata_tpu_torch.serving.DeadlineExceeded`, or are cancelled), so a
  backed-up queue never spends accelerator time on answers nobody will
  read.

Requests may carry their own speaker id and synthesis scales; the batch
forwards both per row, so coalescing never flattens per-request settings.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import Future
from typing import Optional

from ..audio import Audio
from ..core import Model, OperationError
from ..serving import degradation, faults, scope, tracing
from ..serving.deadlines import Deadline, DeadlineExceeded
from ..utils.profiling import QUEUE_WAIT_BUCKETS_S, Histogram
from .batching import (
    BatchingCore,
    DispatchStuck,
    DispatchSupervisor,
    SchedulerCrashed,
    WorkItem,
    try_set_exception,
    try_set_result,
)

__all__ = ["BatchScheduler", "DispatchStuck", "SchedulerCrashed",
           "MAX_QUEUE_ENV", "DISPATCH_TIMEOUT_ENV"]

log = logging.getLogger("sonata.serving")

MAX_QUEUE_ENV = "SONATA_SCHED_MAX_QUEUE"
DEFAULT_MAX_QUEUE = 1024
#: hung-dispatch watchdog: wall-clock bound per device dispatch; <= 0 or
#: unset disables (the default — a cold XLA compile happens *inside* a
#: dispatch, so operators must size this past their worst cold compile
#: or pair it with --prewarm + the persistent compile cache)
DISPATCH_TIMEOUT_ENV = "SONATA_DISPATCH_TIMEOUT_S"


class BatchScheduler:
    def __init__(self, model: Model, *, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 queue_wait_hist: Optional[Histogram] = None,
                 trace_attrs: Optional[dict] = None,
                 dispatch_timeout_s: Optional[float] = None):
        self._model = model
        # knobs default from the model's backend-adaptive dispatch policy
        # (utils/dispatch_policy): on a CPU backend that degrades to
        # per-request pass-through (batch 1, zero wait) — batching buys
        # nothing when the backend runs rows serially, while the gather
        # window and bucket padding cost real latency.  Explicit kwargs
        # (and models without a policy) keep the accelerator defaults.
        if max_batch is None or max_wait_ms is None:
            policy = getattr(model, "dispatch_policy", None)
            defaults = (policy.scheduler_kwargs() if policy is not None
                        else {"max_batch": 16, "max_wait_ms": 5.0})
            max_batch = defaults["max_batch"] if max_batch is None \
                else max_batch
            max_wait_ms = defaults["max_wait_ms"] if max_wait_ms is None \
                else max_wait_ms
        if max_queue is None:
            try:
                max_queue = int(os.environ.get(MAX_QUEUE_ENV,
                                               DEFAULT_MAX_QUEUE))
            except ValueError:
                max_queue = DEFAULT_MAX_QUEUE
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._max_queue = max_queue
        if dispatch_timeout_s is None:
            try:
                dispatch_timeout_s = float(
                    os.environ.get(DISPATCH_TIMEOUT_ENV, 0.0))
            except ValueError:
                dispatch_timeout_s = 0.0
        #: hung-dispatch watchdog bound (seconds); <= 0 disables, and the
        #: disabled path is exactly the pre-watchdog direct call
        self._dispatch_timeout_s = dispatch_timeout_s
        self._supervisor = DispatchSupervisor()
        #: a ReplicaPool's _BreakerModel owns the dispatch failpoint so
        #: injected errors count toward the breaker; bare models get the
        #: hook here
        self._fire_dispatch_failpoint = not getattr(
            model, "owns_dispatch_failpoint", False)
        #: time-in-queue (submit → gather) per item, including items the
        #: gather loop dropped — the queue-wait half of the coalescing
        #: latency story the aggregate shed/expired counters cannot tell.
        #: A ReplicaPool passes one shared histogram to all its replicas'
        #: schedulers so the per-voice view aggregates.
        self.queue_wait = (queue_wait_hist if queue_wait_hist is not None
                           else Histogram(QUEUE_WAIT_BUCKETS_S))
        #: merged into every dispatch span (voice, replica index,
        #: device, ...).  The model's pinned device rides along unless
        #: the caller already named one.
        self._trace_attrs = dict(trace_attrs or {})
        if "device" not in self._trace_attrs:
            device = getattr(model, "device", None)
            if device is not None:
                self._trace_attrs["device"] = str(device)
        self._core = BatchingCore(
            dispatch=self._dispatch,
            max_batch=max_batch,
            max_wait_s=self._max_wait,
            max_queue=max_queue,
            name="sonata_batcher",
            drop_dead=True,
            degradation_scaled=True,
            failpoint_site="scheduler.gather",
            on_drop=self._on_drop,
            on_crash=self._on_crash,
            closed_reason="scheduler shut down",
            shed_reason=(f"scheduler queue full ({max_queue} items); "
                         "shedding"))
        #: per-dispatch observability, same shape as the stream
        #: coalescers': coalescing ratio = requests / dispatches; plus the
        #: serving-runtime drop counters (shed = queue full at submit,
        #: expired/cancelled = dropped by the gather loop pre-dispatch)
        #: and stuck = dispatches killed by the watchdog.  The dict is
        #: the core's (one set of counters, no mirroring).
        self.stats = self._core.stats

    # the submit/shutdown race pin replaces the scheduler's queue with a
    # wrapper; the property aliases the core's so both sides see it
    @property
    def _queue(self):
        return self._core._queue

    @_queue.setter
    def _queue(self, q) -> None:
        self._core._queue = q

    def _bump(self, key: str, n: int = 1) -> None:
        self._core.bump(key, n)

    # -- public API ----------------------------------------------------------
    def queue_depth(self) -> int:
        """Items currently waiting (approximate; for metrics)."""
        return self._core.queue_depth()

    def set_dispatch_timeout(self, seconds: Optional[float]) -> None:
        """(Re)arm the hung-dispatch watchdog at runtime (<= 0 or None
        disables).  Lets operators and the chaos smoke warm up without a
        bound — cold compiles happen inside a dispatch — then clamp."""
        self._dispatch_timeout_s = seconds if seconds is not None else 0.0

    def stats_view(self) -> dict:
        """Stats snapshot plus the derived coalescing ratio (requests per
        device dispatch; 1.0 = no coalescing) — the one place the ratio
        formula lives for every consumer (server log line, benches)."""
        s = self._core.stats_snapshot()
        s["coalescing_ratio"] = round(
            s["requests"] / max(s["dispatches"], 1), 3)
        return s

    def submit(self, phonemes: str,
               speaker: Optional[int] = None,
               scales=None,
               deadline: Optional[Deadline] = None,
               trace_ctx=None) -> "Future[Audio]":
        """``trace_ctx``: (trace, parent span) for callers submitting off
        the request thread (the replica pool's resubmit path); defaults
        to the ambient :func:`tracing.current` context."""
        if self._core.closed:
            raise OperationError("scheduler is shut down")
        if deadline is not None and not deadline.alive():
            # no point occupying a queue slot for work that is already
            # dead — fail at the door with the accurate error
            if deadline.cancelled:
                raise OperationError("request cancelled before submit")
            self._bump("expired")
            raise DeadlineExceeded("request deadline exceeded before submit")
        if speaker is not None:
            # validate here, per request: a bad speaker id inside a
            # coalesced dispatch would otherwise fail every request in
            # the batch
            speakers = self._model.get_speakers()
            if speakers is None:
                if speaker != 0:
                    raise OperationError(
                        f"speaker id {speaker} on a single-speaker voice")
            elif speaker not in speakers:
                raise OperationError(f"unknown speaker id {speaker}")
        if scales is not None:
            # same rationale: a malformed scales object must fail THIS
            # request at submit time, not the whole coalesced dispatch
            import numbers

            for attr in ("noise_w", "length_scale", "noise_scale"):
                value = getattr(scales, attr, None)
                if not isinstance(value, numbers.Real):
                    raise OperationError(
                        f"scales.{attr} missing or non-numeric")
        item = WorkItem((phonemes, speaker, scales), deadline=deadline,
                        tctx=trace_ctx if trace_ctx is not None
                        else tracing.current())
        self._core.put(item)
        return item.future

    def speak(self, phonemes: str, timeout: Optional[float] = None,
              speaker: Optional[int] = None, scales=None,
              deadline: Optional[Deadline] = None) -> Audio:
        return self.submit(phonemes, speaker=speaker, scales=scales,
                           deadline=deadline).result(timeout)

    def shutdown(self) -> None:
        self._core.shutdown()
        self._supervisor.shutdown()

    # -- hooks from the core -------------------------------------------------
    def _on_drop(self, item: WorkItem, outcome: str, now: float) -> None:
        # a dropped item still spent real time in the queue: both the
        # histogram and the trace must say so, or the slowest traces
        # would be exactly the ones with a hole where the wait went.
        # The core records this span BEFORE resolving the future (same
        # invariant as _dispatch): the waiter may export the trace the
        # instant its future resolves
        self.queue_wait.observe(now - item.t_submit)
        if item.tctx is not None:
            trace, parent = item.tctx
            trace.new_span("queue-wait", parent=parent,
                           start=item.t_submit, end=now,
                           attrs={"outcome": outcome})

    def _on_crash(self, err: Exception, items: list) -> None:
        # a pool replica rebuilds itself (breaker trip + drain + probe)
        report = getattr(self._model, "report_scheduler_fault", None)
        if report is not None:
            report(err)

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, batch: list) -> None:
        sentences = [i.payload[0] for i in batch]
        speakers = [i.payload[1] for i in batch]
        scales = [i.payload[2] for i in batch]
        futures = [i.future for i in batch]
        self._bump("requests", len(batch))
        self._bump("dispatches")
        t0 = time.monotonic()
        for item in batch:
            self.queue_wait.observe(t0 - item.t_submit)
        # dispatch attribution (the Orca question: which batch did this
        # request ride in, with whom, at what padding cost): ONE shared
        # span per device dispatch, recorded into every participating
        # trace under the same dispatch_id.  The model fills bucket shape
        # / padding / compile-vs-cached through the annotation channel.
        traced = [i for i in batch if i.tctx is not None]
        attrs: dict = {}
        if traced:
            attrs = {"dispatch_id": tracing.new_id(),
                     "batch_size": len(batch),
                     "request_ids": [i.tctx[0].request_id for i in traced],
                     **self._trace_attrs}
        err: Optional[Exception] = None
        audios = None
        stuck = False
        timeout = self._dispatch_timeout_s
        try:
            with tracing.dispatch_scope(attrs):
                if timeout and timeout > 0:
                    audios = self._supervised_call(sentences, speakers,
                                                   scales, timeout)
                else:
                    audios = self._call_model(sentences, speakers, scales)
        except DispatchStuck as e:
            err = e
            stuck = True
        except Exception as e:
            err = e
        if err is None and len(audios) != len(batch):
            # a corrupted device result (wrong row count) must fail the
            # batch loudly, never zip-truncate into wrong-audio answers
            err = OperationError(
                f"device dispatch returned {len(audios)} results for "
                f"{len(batch)} requests (shape corrupted)")
        # record spans BEFORE resolving the futures: the waiting request
        # thread may finish (and export) its trace the instant its future
        # resolves, and the dispatch attribution must already be there
        t1 = time.monotonic()
        if err is None:
            # dispatch-efficiency accounting (scope plane): one device
            # dispatch counts ONCE, with the same bucket/padding attrs
            # the trace attribution carries — traced or not, the model
            # filled them through the dispatch_scope channel above
            scope.note_dispatch(t1 - t0, {**self._trace_attrs, **attrs})
        if err is not None and traced:
            attrs["error"] = f"{type(err).__name__}: {err}"
        for item in traced:
            trace, parent = item.tctx
            trace.new_span("queue-wait", parent=parent,
                           start=item.t_submit, end=t0)
            trace.new_span("dispatch", parent=parent, start=t0, end=t1,
                           attrs=attrs)
            if stuck:
                # the watchdog interval, visible in every affected trace
                trace.new_span("watchdog", parent=parent, start=t0,
                               end=t1, attrs={"timeout_s": timeout,
                                              "error": str(err)})
        if err is not None:
            for fut in futures:
                try_set_exception(fut, err)
        else:
            for fut, audio in zip(futures, audios):
                try_set_result(fut, audio)

    def _call_model(self, sentences, speakers, scales):
        """One device call, with the dispatch failpoint for bare models
        (pool replicas fire it inside the breaker wrapper instead, so
        injected faults count toward the breaker like real ones)."""
        action = (faults.fire("dispatch.device_call")
                  if self._fire_dispatch_failpoint else None)
        # speakers/scales are part of the Model protocol
        audios = self._model.speak_batch(sentences, speakers=speakers,
                                         scales=scales)
        return faults.corrupt_result(action, audios)

    def _supervised_call(self, sentences, speakers, scales,
                         timeout: float):
        """Run the device call under the hung-dispatch watchdog
        (:class:`~sonata_tpu_torch.synth.batching.DispatchSupervisor`): on
        conviction the helper thread is quarantined, the batch's futures
        fail typed :class:`DispatchStuck` instead of hanging, the
        breaker counts the fault, and the pool resubmits."""

        def on_stuck(helper) -> None:
            self._bump("stuck")
            degradation.note_watchdog()
            # a convicted wedge is an incident: ship the flight
            # recorder's preceding minutes with it
            scope.note_watchdog()
            log.error("device dispatch stuck past the %gs watchdog; "
                      "thread %s quarantined, failing %d request(s)",
                      timeout, helper.thread.ident, len(sentences))
            report = getattr(self._model, "report_dispatch_stuck", None)
            if report is not None:
                try:
                    report()
                except Exception:
                    log.exception("dispatch-stuck report hook failed")

        return self._supervisor.call(
            lambda: self._call_model(sentences, speakers, scales),
            timeout, timeout_env=DISPATCH_TIMEOUT_ENV, on_stuck=on_stuck)
