"""Multi-device replica pool: route, batch, and fail over across chips.

Port of ``sonata_tpu/serving/replicas.py``, line for line but for the two
functions that count devices: :func:`resolve_replica_count` and
:func:`resolve_replica_devices` count ``torch.cuda.device_count()`` cards
(``cuda:0``, ``cuda:1``, ...), and a caller that asks for the CPU
(``device="cpu"``) gets its replicas on ``cpu``, as many as it asks for.
Each replica is ``voice.replica_for_device(device, seed_offset=i)``; the
JAX wording below ("chip", ``jax.device_put``) reads "card" and
``.to(device)`` here.

A host with 4 or 8 accelerator chips serving through one
:class:`~sonata_tpu_torch.synth.scheduler.BatchScheduler` uses exactly one chip
— the scheduler owns a single worker issuing ``speak_batch`` against
whatever device JAX picked by default — and a single device fault kills
the whole voice.  This module is the standard next step for an inference
stack (cf. Orca's iteration-level scheduling, OSDI '22; AlpaServe's
replica placement, OSDI '23): **replica-pool serving**.

- :class:`ReplicaPool` owns one :class:`Replica` per JAX local device
  (or a ``SONATA_REPLICAS=N`` prefix subset).  Each replica holds its
  own device-placed copy of the model (``jax.device_put`` of the params
  at pool construction pins every dispatch to that replica's chip — a
  committed operand places the whole XLA computation) and its own
  ``BatchScheduler``, so continuous batching happens *per chip*.
- The **router** submits each request to the healthy replica with the
  least outstanding work.  Deadlines and admission compose unchanged:
  the pool exposes the scheduler's ``submit/speak/queue_depth/stats``
  surface, so everything upstream (gRPC deadline propagation, admission
  shedding, metrics) works identically with or without a pool.
- **Fault isolation**: a replica whose device dispatches fail
  ``SONATA_REPLICA_BREAKER_THRESHOLD`` consecutive times (default 3) is
  circuit-broken — drained (its scheduler shut down; queued work fails
  out and is resubmitted), and every request that failed on it is
  resubmitted **exactly once** to a healthy replica, so a single sick
  chip degrades capacity instead of failing requests.  After
  ``SONATA_REPLICA_PROBE_INTERVAL_S`` (default 5 s) the breaker goes
  **half-open**: the router hands the replica one trial request; success
  closes the breaker, failure re-opens it with the probe interval
  **doubled** (plus jitter, capped at ``SONATA_REPLICA_PROBE_MAX_S``,
  default 60 s) — a persistently sick device is probed ever more
  rarely, not stormed.  Wedge-class faults (a dispatch stuck past the
  ``SONATA_DISPATCH_TIMEOUT_S`` watchdog, a crashed scheduler worker)
  trip the breaker immediately and recycle the replica's scheduler.
- **Health integration**: ``healthy_count()`` backs a readiness gate —
  a pool with zero healthy replicas flips ``/readyz`` (see
  :meth:`~sonata_tpu_torch.serving.health.HealthState.add_readiness_gate`)
  so the load balancer routes around the whole host.

Everything is testable on CPU: ``XLA_FLAGS
=--xla_force_host_platform_device_count=4`` gives four independent host
devices, and the pool behaves identically (tests/test_replicas.py).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Callable, Optional, Sequence

from ..core import OperationError
from ..utils.profiling import QUEUE_WAIT_BUCKETS_S, Histogram
from . import degradation, faults, tracing
from .admission import Overloaded
from .deadlines import Deadline, DeadlineExceeded
from .drain import Draining

log = logging.getLogger("sonata.serving")

REPLICAS_ENV = "SONATA_REPLICAS"
BREAKER_THRESHOLD_ENV = "SONATA_REPLICA_BREAKER_THRESHOLD"
PROBE_INTERVAL_ENV = "SONATA_REPLICA_PROBE_INTERVAL_S"
#: cap for the exponential probe backoff: a replica whose trials keep
#: failing doubles its probe interval (plus jitter) up to this bound,
#: instead of probe-storming a persistently sick device every interval
PROBE_MAX_ENV = "SONATA_REPLICA_PROBE_MAX_S"
DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_PROBE_INTERVAL_S = 5.0
DEFAULT_PROBE_MAX_S = 60.0
#: fractional jitter on every probe delay, so a fleet of replicas (or
#: hosts) tripped by one event does not re-probe in lockstep
PROBE_JITTER = 0.1

# breaker states; exported as the numeric value of the
# sonata_replica_breaker_state gauge (0 = serving, 1 = probing, 2 = out)
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_replica_count() -> int:
    """``SONATA_REPLICAS`` parsed as a count: 0 when unset, non-positive,
    or garbage — the one place frontends ask "did the env turn the pool
    on?" (string truthiness would read the documented ``0 = off`` as
    on)."""
    return max(0, _env_int(REPLICAS_ENV, 0))


def resolve_replica_count(replicas: Optional[int] = None,
                          n_devices: Optional[int] = None) -> int:
    """How many replicas to run: explicit arg > ``SONATA_REPLICAS`` >
    one per card; always clamped to [1, card count]."""
    if n_devices is None:
        import torch

        n_devices = max(torch.cuda.device_count(), 1)
    if replicas is None or replicas <= 0:
        replicas = _env_int(REPLICAS_ENV, 0)
    if replicas <= 0:
        replicas = n_devices
    return max(1, min(replicas, n_devices))


def resolve_replica_devices(replicas: Optional[int] = None,
                            device=None) -> list:
    """The device prefix the pool will occupy (deterministic order, so
    two pools in one process stack onto the same cards predictably).

    ``device``: the voice's device.  A CPU voice gets ``replicas`` (or
    ``SONATA_REPLICAS``, else 1) replicas on ``cpu``; otherwise the
    cards ``cuda:0..n-1``, and no card raises."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        want = replicas if replicas is not None and replicas > 0 \
            else _env_int(REPLICAS_ENV, 0)
        return [torch.device("cpu")] * max(1, want)
    n = torch.cuda.device_count()
    if n == 0:
        raise OperationError(
            "no CUDA device is available for a replica pool; load the "
            "voice with device='cpu' to pool it on the CPU")
    return [torch.device("cuda", i)
            for i in range(resolve_replica_count(replicas, n))]


class _BreakerModel:
    """Model wrapper that reports dispatch outcomes to its replica.

    Failure counting must happen at *dispatch* granularity — K requests
    sharing one failed ``speak_batch`` are one fault, not K — so the
    breaker taps the model call itself rather than the per-request
    futures.  Everything else delegates to the wrapped model.
    """

    #: tells the scheduler this wrapper fires the dispatch failpoint
    #: itself, inside the failure accounting — an injected device fault
    #: must count toward the breaker exactly like a real one
    owns_dispatch_failpoint = True

    def __init__(self, model, replica: "Replica"):
        self._model = model
        self._replica = replica

    def speak_batch(self, sentences, *args, **kwargs):
        # capture the breaker generation BEFORE the call: a dispatch
        # thread the watchdog quarantined may complete arbitrarily late,
        # and its tap must not close a HALF_OPEN breaker (no trial ran)
        # or re-count a wedge the watchdog already accounted
        generation = self._replica.generation
        try:
            action = faults.fire("dispatch.device_call")
            out = faults.corrupt_result(
                action, self._model.speak_batch(sentences, *args, **kwargs))
        except Exception:
            self._replica._record_dispatch(ok=False, generation=generation)
            raise
        # a device answering the wrong number of rows is a DEVICE fault:
        # count it here, where the breaker can see it — the scheduler
        # fails the batch with the typed shape error downstream, after
        # this tap has run, and the pool resubmits off the sick replica
        ok = len(out) == len(sentences)
        self._replica._record_dispatch(ok=ok, generation=generation)
        return out

    # -- watchdog / crash hooks (called by the replica's scheduler) ----------
    def report_dispatch_stuck(self) -> None:
        """The watchdog convicted a dispatch that never returned: its
        breaker tap inside ``speak_batch`` runs only if the quarantined
        thread ever completes — and by then carries a stale generation
        and is ignored — so the scheduler reports the wedge here and the
        replica recycles now."""
        self._replica._report_fault("dispatch stuck past the watchdog")

    def report_scheduler_fault(self, exc: Exception) -> None:
        """The replica's scheduler worker crashed; recycle the replica so
        queued work resubmits and a probe rebuilds the scheduler."""
        self._replica._report_fault(f"scheduler worker crashed: {exc}")

    def __getattr__(self, name):
        return getattr(self._model, name)


class Replica:
    """One device's serving lane: model copy + scheduler + breaker."""

    def __init__(self, index: int, model, device=None,
                 scheduler_kwargs: Optional[dict] = None,
                 pool: "Optional[ReplicaPool]" = None):
        self.index = index
        self.device = device
        self.model = _BreakerModel(model, self)
        self._scheduler_kwargs = dict(scheduler_kwargs or {})
        if pool is not None:
            # one pool-shared queue-wait histogram: the per-voice metric
            # aggregates across replicas (and survives breaker-driven
            # scheduler recycling, which would reset a per-scheduler one)
            self._scheduler_kwargs.setdefault("queue_wait_hist",
                                              pool.queue_wait)
        attrs = {"replica": index}
        if pool is not None:
            # the pool is named after its voice (for_voice passes the
            # voice id): dispatch spans and the scope's padding-waste
            # accounting both key on it
            attrs["voice"] = pool.name
        if device is not None:
            attrs["device"] = str(device)
        self._scheduler_kwargs.setdefault("trace_attrs", attrs)
        self._pool = pool
        self.state = CLOSED
        self.consecutive_failures = 0
        self.dispatches = 0        # successful device dispatches
        self.dispatch_failures = 0  # failed device dispatches
        self.submitted = 0         # requests routed here (lifetime)
        self.outstanding = 0       # routed, not yet resolved
        self.resubmits = 0         # requests that failed here and were
        #                            retried on another replica
        self.opened_at: Optional[float] = None
        self.next_probe_at: Optional[float] = None
        #: current probe backoff (seconds, pre-jitter): reset to the pool
        #: base on a fresh trip, doubled (capped) on every failed trial,
        #: cleared when the breaker closes
        self.probe_backoff_s: Optional[float] = None
        #: breaker generation, bumped on every trip: dispatches started
        #: before a trip (e.g. a watchdog-quarantined thread finishing
        #: late) carry a stale generation and their breaker tap is
        #: ignored — the trip already accounted them
        self.generation = 0
        self.scheduler = self._new_scheduler()

    def _new_scheduler(self):
        from ..synth.scheduler import BatchScheduler

        return BatchScheduler(self.model, **self._scheduler_kwargs)

    @property
    def device_id(self) -> int:
        # a card's index; the replica's own index on the CPU
        index = getattr(self.device, "index", None)
        return self.index if index is None else index

    def _record_dispatch(self, *, ok: bool,
                         generation: Optional[int] = None) -> None:
        pool = self._pool
        if pool is not None:
            pool._on_dispatch(self, ok, generation=generation)

    def _report_fault(self, reason: str) -> None:
        """A wedge-class fault (stuck dispatch, crashed worker): recycle
        immediately — the scheduler/thread state is unusable regardless
        of how many consecutive failures came before."""
        pool = self._pool
        if pool is not None:
            pool._recycle_replica(self, reason)

    def snapshot(self) -> dict:
        return {"index": self.index, "device": str(self.device),
                "state": _STATE_NAMES[self.state],
                "outstanding": self.outstanding,
                "submitted": self.submitted,
                "dispatches": self.dispatches,
                "dispatch_failures": self.dispatch_failures,
                "resubmits": self.resubmits,
                "probe_backoff_s": self.probe_backoff_s,
                "queue_depth": self.scheduler.queue_depth()}


class ReplicaPool:
    """Route requests across per-device replicas with fault isolation.

    Duck-type-compatible with :class:`BatchScheduler` (``submit`` /
    ``speak`` / ``queue_depth`` / ``stats`` / ``stats_view`` /
    ``shutdown``), so frontends swap a pool in wherever a scheduler went.
    """

    def __init__(self, models: Sequence, devices: Optional[Sequence] = None,
                 *, breaker_threshold: Optional[int] = None,
                 probe_interval_s: Optional[float] = None,
                 probe_max_s: Optional[float] = None,
                 scheduler_kwargs: Optional[dict] = None,
                 on_health_change: Optional[Callable[[int], None]] = None,
                 name: str = "pool"):
        if not models:
            raise OperationError("a replica pool needs at least one model")
        if devices is not None and len(devices) != len(models):
            raise OperationError(
                f"{len(models)} models for {len(devices)} devices")
        self.name = name
        self.breaker_threshold = max(1, (
            breaker_threshold if breaker_threshold is not None
            else _env_int(BREAKER_THRESHOLD_ENV, DEFAULT_BREAKER_THRESHOLD)))
        self.probe_interval_s = max(0.01, (
            probe_interval_s if probe_interval_s is not None
            else _env_float(PROBE_INTERVAL_ENV, DEFAULT_PROBE_INTERVAL_S)))
        # never below the base: a pinned-long base interval (the CI
        # smoke's 600 s) must not be clipped by the default cap
        self.probe_max_s = max(self.probe_interval_s, (
            probe_max_s if probe_max_s is not None
            else _env_float(PROBE_MAX_ENV, DEFAULT_PROBE_MAX_S)))
        self._lock = threading.RLock()
        self._closed = False
        #: drain state (terminal, always followed by shutdown): the pool
        #: refuses new submits, breaker resubmission, and half-open
        #: probe rebuilds FAST and TYPED instead of racing the teardown
        self._draining = False
        self._on_health_change = on_health_change
        #: pool-level counters (replica-level ones live on each Replica)
        self.stats = {"routed": 0, "resubmitted": 0, "failed": 0,
                      "breaker_opens": 0, "recovered": 0}
        #: shared across every replica's scheduler (see Replica.__init__)
        self.queue_wait = Histogram(QUEUE_WAIT_BUCKETS_S)
        self.replicas = [
            Replica(i, m, device=(devices[i] if devices else None),
                    scheduler_kwargs=scheduler_kwargs, pool=self)
            for i, m in enumerate(models)]
        self._probe_wake = threading.Event()
        self._prober = threading.Thread(target=self._probe_loop,
                                        name="sonata_replica_probe",
                                        daemon=True)
        self._prober.start()

    # -- construction ---------------------------------------------------------
    @classmethod
    def for_voice(cls, voice, replicas: Optional[int] = None,
                  **kwargs) -> "ReplicaPool":
        """One replica per local device (or the ``SONATA_REPLICAS`` /
        ``replicas`` prefix), each with the voice's params
        ``jax.device_put`` onto its chip."""
        devices = resolve_replica_devices(
            replicas, device=getattr(voice, "device", None))
        models = [voice.replica_for_device(d, seed_offset=i)
                  for i, d in enumerate(devices)]
        return cls(models, devices, **kwargs)

    # -- scheduler-compatible surface ----------------------------------------
    def submit(self, phonemes: str, speaker: Optional[int] = None,
               scales=None,
               deadline: Optional[Deadline] = None) -> "Future":
        """Route one request to the least-loaded healthy replica.

        Returns a pool-level future.  A dispatch-level failure on the
        chosen replica resubmits the request exactly once to a different
        healthy replica before the client sees an error; request-level
        errors (bad speaker, expired deadline, full queue) propagate
        unchanged — they would fail identically anywhere.
        """
        if self._closed:
            raise OperationError("replica pool is shut down")
        if self._draining:
            raise Draining(
                f"draining: replica pool {self.name!r} is shutting down "
                "for a restart; not accepting new work")
        outer: "Future" = Future()
        with self._lock:
            self.stats["routed"] += 1
        # captured here, on the request thread: the resubmit path runs on
        # a future-callback thread where the ambient context is gone, yet
        # its spans must land in THIS request's trace
        self._route(outer, phonemes, speaker, scales, deadline,
                    resubmits_left=1, exclude=(),
                    tctx=tracing.current(), t_first=time.monotonic())
        return outer

    def speak(self, phonemes: str, timeout: Optional[float] = None,
              speaker: Optional[int] = None, scales=None,
              deadline: Optional[Deadline] = None):
        return self.submit(phonemes, speaker=speaker, scales=scales,
                           deadline=deadline).result(timeout)

    def speak_many(self, phoneme_list: Sequence[str], *, speaker=None,
                   scales=None, deadline: Optional[Deadline] = None,
                   timeout: Optional[float] = None) -> list:
        """Submit a batch of sentences across the pool and gather results
        in order (the CLI's / batched stream's fan-out)."""
        futures = [self.submit(p, speaker=speaker, scales=scales,
                               deadline=deadline) for p in phoneme_list]
        return [f.result(timeout) for f in futures]

    def warmup(self, phoneme_list: Sequence[str]) -> None:
        """Run the given sentences through EVERY healthy replica (not the
        router) and wait.  Readiness warmup must compile each chip's
        executables — routed traffic would warm only the least-loaded
        replica and leave the rest to pay cold XLA compiles under real
        load."""
        futures = [r.scheduler.submit(p)
                   for r in self.replicas if r.state == CLOSED
                   for p in phoneme_list]
        for fut in futures:
            fut.result()

    def queue_depth(self) -> int:
        return sum(r.scheduler.queue_depth() for r in self.replicas)

    def set_dispatch_timeout(self, seconds: Optional[float]) -> None:
        """(Re)arm the hung-dispatch watchdog on every replica's
        scheduler, including ones the probe loop rebuilds later (the
        kwarg is recorded so ``_new_scheduler`` inherits it).  None
        means *disable*, so it is recorded as 0.0 — a raw None kwarg
        would make a rebuilt scheduler fall back to the env value and
        silently resurrect a watchdog the operator turned off.

        Runs under the pool lock, and replaces the kwargs dict wholesale
        rather than mutating it: ``_new_scheduler`` unpacks the dict
        OUTSIDE the lock in the probe loop, so an in-place first-time
        key insert could resize it mid-unpack.  A rebuild racing this
        call may still have snapshotted the old kwargs — the probe loop
        re-applies the recorded value at install time to close that."""
        resolved = seconds if seconds is not None else 0.0
        with self._lock:
            for r in self.replicas:
                r._scheduler_kwargs = dict(r._scheduler_kwargs,
                                           dispatch_timeout_s=resolved)
                # a plain attribute store on the scheduler: safe (and
                # race-free with the rebuild install) under the lock
                r.scheduler.set_dispatch_timeout(resolved)

    def stats_view(self) -> dict:
        """Aggregate scheduler stats across replicas plus the pool's own
        routing/breaker counters — same keys a lone ``BatchScheduler``
        exposes, so log lines and benches read either transparently."""
        agg = {"requests": 0, "dispatches": 0, "shed": 0, "expired": 0,
               "cancelled": 0, "stuck": 0}
        for r in self.replicas:
            for k, v in r.scheduler.stats_view().items():
                if k in agg:
                    agg[k] += v
        agg["coalescing_ratio"] = round(
            agg["requests"] / max(agg["dispatches"], 1), 3)
        with self._lock:
            agg.update(self.stats)
            agg["replicas"] = len(self.replicas)
            agg["healthy_replicas"] = self._healthy_count_locked()
        return agg

    def start_draining(self) -> None:
        """Enter the drain state ahead of :meth:`shutdown` (the frontend
        calls this once its in-flight wait is over, just before voice
        teardown).  From here on: new submits, breaker resubmission, and
        half-open probe rebuilds all refuse fast with a typed
        :class:`~sonata_tpu_torch.serving.drain.Draining` — a breaker trip
        racing the teardown must not feed work into a closing scheduler,
        and a probe must not build a worker thread nobody will join.
        Queued and in-flight dispatches are untouched; they finish (or
        fail out) through their schedulers as usual."""
        with self._lock:
            if self._draining or self._closed:
                return
            self._draining = True
        log.info("pool %s: draining (no new submits, no resubmission, "
                 "no probe rebuilds)", self.name)
        self._probe_wake.set()  # the prober exits instead of rebuilding

    @property
    def draining(self) -> bool:
        return self._draining

    def shutdown(self) -> None:
        """Drain the whole pool: every replica's scheduler shuts down and
        fails its queued work (no resubmission — the pool is closing)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._draining = True
        self._probe_wake.set()
        for r in self.replicas:
            r.scheduler.shutdown()
        self._prober.join(timeout=5.0)

    # -- health ---------------------------------------------------------------
    def _healthy_count_locked(self) -> int:
        return sum(1 for r in self.replicas if r.state != OPEN)

    def healthy_count(self) -> int:
        """Replicas currently accepting traffic (closed or probing)."""
        with self._lock:
            return self._healthy_count_locked()

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "closed": self._closed,
                    "draining": self._draining,
                    "healthy": self._healthy_count_locked(),
                    "stats": dict(self.stats),
                    "replicas": [r.snapshot() for r in self.replicas]}

    def _notify_health(self) -> None:
        cb = self._on_health_change
        if cb is not None:
            try:
                cb(self.healthy_count())
            except Exception:
                log.exception("replica-pool health callback failed")

    # -- routing --------------------------------------------------------------
    def _pick(self, exclude: tuple) -> Replica:
        with self._lock:
            # a half-open replica with nothing in flight gets the next
            # request as its trial — that's how the breaker closes again
            for r in self.replicas:
                if (r.state == HALF_OPEN and r.outstanding == 0
                        and r not in exclude):
                    r.outstanding += 1
                    r.submitted += 1
                    return r
            closed = [r for r in self.replicas
                      if r.state == CLOSED and r not in exclude]
            if not closed:
                raise Overloaded(
                    f"replica pool {self.name!r}: no healthy replica "
                    f"available ({self._healthy_count_locked()} of "
                    f"{len(self.replicas)} non-open)")
            best = min(closed, key=lambda r: r.outstanding)
            best.outstanding += 1
            best.submitted += 1
            return best

    def _release(self, replica: Replica) -> None:
        with self._lock:
            if replica.outstanding > 0:
                replica.outstanding -= 1

    def _route(self, outer: "Future", phonemes, speaker, scales, deadline,
               *, resubmits_left: int, exclude: tuple,
               tctx=None, t_first: Optional[float] = None) -> None:
        tried = list(exclude)
        try:
            faults.fire("pool.route")
        except OperationError as e:
            # an injected routing fault fails the request like any other
            # pool-level refusal (never crashes a resubmit callback)
            self._fail(outer, e)
            return
        while True:
            try:
                replica = self._pick(tuple(tried))
            except Overloaded as e:
                degradation.note_shed()  # capacity shed: no healthy replica
                self._fail(outer, e)
                return
            try:
                inner = replica.scheduler.submit(
                    phonemes, speaker=speaker, scales=scales,
                    deadline=deadline, trace_ctx=tctx)
            except (Overloaded, DeadlineExceeded) as e:
                # request-level refusal: a full per-replica queue or an
                # already-dead deadline would refuse anywhere — surface it
                self._release(replica)
                self._fail(outer, e)
                return
            except OperationError as e:
                self._release(replica)
                if ("shut down" in str(e) and not self._closed
                        and not self._draining):
                    # raced a concurrent breaker-open drain on this
                    # replica: no dispatch happened, so retrying another
                    # replica does not spend the resubmit budget
                    tried.append(replica)
                    continue
                if self._draining:
                    # the teardown is what closed the scheduler under
                    # us: surface the drain, not the raced internals
                    self._fail(outer, Draining(
                        f"draining: replica pool {self.name!r} is "
                        f"shutting down ({type(e).__name__}: {e})"))
                    return
                self._fail(outer, e)
                return
            break
        inner.add_done_callback(
            lambda fut, r=replica: self._on_done(
                outer, fut, r, phonemes, speaker, scales, deadline,
                resubmits_left, tctx, t_first))

    def _on_done(self, outer: "Future", inner: "Future", replica: Replica,
                 phonemes, speaker, scales, deadline,
                 resubmits_left: int, tctx=None,
                 t_first: Optional[float] = None) -> None:
        self._release(replica)
        try:
            result = inner.result()
        except CancelledError:
            outer.cancel()
            return
        except (DeadlineExceeded, Overloaded) as e:
            self._fail(outer, e)  # the request's own fault, not the chip's
            return
        except Exception as e:
            # replica-fault path (device dispatch error, or the replica
            # was drained under us): fail over — once
            if self._draining:
                # drain-vs-resubmission race class: a breaker trip while
                # the pool is draining must NOT resubmit into a closing
                # scheduler — fail fast and typed so the client (and the
                # ladder) sees a deploy, not a fault or overload
                self._fail(outer, Draining(
                    f"draining: replica pool {self.name!r} is shutting "
                    f"down; not resubmitting after "
                    f"{type(e).__name__}: {e}"))
                return
            if (resubmits_left > 0 and not self._closed
                    and (deadline is None or deadline.alive())):
                now = time.monotonic()
                added_ms = (round((now - t_first) * 1e3, 3)
                            if t_first is not None else None)
                with self._lock:
                    self.stats["resubmitted"] += 1
                    replica.resubmits += 1
                hop = 1 + (1 - resubmits_left)  # 1 resubmit budget today
                request_id = tctx[0].request_id if tctx else None
                if tctx is not None:
                    # make the failover visible to the request itself:
                    # without this span the retried request's trace shows
                    # a clean dispatch and silently absorbs the latency
                    trace, parent = tctx
                    trace.new_span(
                        "resubmit", parent=parent, start=now, end=now,
                        attrs={"failed_replica": replica.index,
                               "retry_hop": hop,
                               "latency_before_retry_ms": added_ms,
                               "error": f"{type(e).__name__}: {e}"})
                log.warning(
                    "pool %s: resubmitting request off replica %d "
                    "(hop %d, %.1f ms already spent: %s)", self.name,
                    replica.index, hop, added_ms or 0.0, e,
                    extra={"replica": replica.index,
                           "request_id": request_id})
                self._route(outer, phonemes, speaker, scales, deadline,
                            resubmits_left=resubmits_left - 1,
                            exclude=(replica,), tctx=tctx, t_first=t_first)
                return
            self._fail(outer, e)
            return
        try:
            outer.set_result(result)
        except Exception:
            pass  # outer was cancelled; tolerated like the scheduler does

    def _fail(self, outer: "Future", exc: Exception) -> None:
        with self._lock:
            self.stats["failed"] += 1
        try:
            outer.set_exception(exc)
        except Exception:
            pass

    # -- breaker --------------------------------------------------------------
    def _open_locked(self, replica: Replica, *, failed_trial: bool) -> None:
        """Flip a replica OPEN and schedule its next probe (pool lock
        held).  Backoff: a fresh trip probes after the base interval; a
        failed half-open trial doubles the interval up to
        ``probe_max_s`` — plus jitter — so a persistently sick device is
        probed ever more rarely instead of stormed."""
        replica.state = OPEN
        replica.opened_at = time.monotonic()
        replica.generation += 1  # in-flight dispatches are now stale
        if failed_trial and replica.probe_backoff_s is not None:
            replica.probe_backoff_s = min(replica.probe_backoff_s * 2,
                                          self.probe_max_s)
        else:
            replica.probe_backoff_s = self.probe_interval_s
        replica.next_probe_at = (replica.opened_at
                                 + self._jittered(replica.probe_backoff_s))
        self.stats["breaker_opens"] += 1

    @staticmethod
    def _jittered(seconds: float) -> float:
        return seconds * (1.0 + PROBE_JITTER * random.random())

    def _drain_off_thread(self, scheduler, index: int) -> None:
        """Shut a scheduler down on a helper thread: ``shutdown()`` joins
        the scheduler's worker — which may be the very thread running the
        breaker callback — and must never run under the pool lock."""
        threading.Thread(target=scheduler.shutdown,
                         name=f"sonata_replica_drain_{index}",
                         daemon=True).start()

    def _on_dispatch(self, replica: Replica, ok: bool,
                     generation: Optional[int] = None) -> None:
        """Dispatch-granular breaker bookkeeping (called by the
        replica's :class:`_BreakerModel` around every ``speak_batch``)."""
        to_drain = None
        with self._lock:
            if (generation is not None
                    and generation != replica.generation):
                # a dispatch from before a breaker trip finishing late —
                # a watchdog-quarantined thread, typically.  The trip
                # already accounted it: a late success must not close a
                # HALF_OPEN breaker (no trial ran), a late failure must
                # not double-count the wedge.
                log.info("pool %s: replica %d ignoring stale dispatch "
                         "result (generation %d != %d)", self.name,
                         replica.index, generation, replica.generation)
                return
            if ok:
                replica.dispatches += 1
                replica.consecutive_failures = 0
                if replica.state == HALF_OPEN:
                    replica.state = CLOSED
                    replica.probe_backoff_s = None  # backoff resets
                    self.stats["recovered"] += 1
                    log.info("pool %s: replica %d trial dispatch "
                             "succeeded; breaker closed", self.name,
                             replica.index)
                    notify = True
                else:
                    notify = False
            else:
                replica.dispatch_failures += 1
                replica.consecutive_failures += 1
                failed_trial = replica.state == HALF_OPEN
                trip = (failed_trial
                        or (replica.state == CLOSED
                            and replica.consecutive_failures
                            >= self.breaker_threshold))
                notify = trip
                if trip:
                    self._open_locked(replica, failed_trial=failed_trial)
                    to_drain = replica.scheduler
                    log.error(
                        "pool %s: replica %d circuit-broken after %d "
                        "consecutive dispatch failures; draining "
                        "(next probe in %.1fs)", self.name, replica.index,
                        replica.consecutive_failures,
                        replica.probe_backoff_s)
        if to_drain is not None:
            # drain off-thread: shutdown() joins the scheduler worker —
            # the very thread this callback may be running on
            self._drain_off_thread(to_drain, replica.index)
            self._probe_wake.set()  # re-arm the prober's timer
        if notify:
            self._notify_health()

    def force_open(self, index: int, reason: str = "operator") -> None:
        """Trip one replica's breaker by hand (ops escape hatch; also
        what the CI smoke uses to prove readiness survives a dead chip)."""
        with self._lock:
            replica = self.replicas[index]
            if replica.state == OPEN:
                return
            self._open_locked(replica, failed_trial=False)
            sched = replica.scheduler
        log.warning("pool %s: replica %d force-opened (%s)", self.name,
                    index, reason)
        self._drain_off_thread(sched, index)
        self._probe_wake.set()
        self._notify_health()

    def _recycle_replica(self, replica: Replica, reason: str) -> None:
        """Immediate trip for wedge-class faults (stuck dispatch, crashed
        scheduler worker): the replica's scheduler state is unusable, so
        it drains now — queued work fails out and resubmits — and the
        probe loop rebuilds a fresh scheduler for the half-open trial.
        Runs on the replica's own scheduler worker thread, so the drain
        must (and does) happen off-thread."""
        with self._lock:
            if replica.state == OPEN:
                # the trip that opened the breaker already accounted the
                # wedge — a second conviction racing the drain must not
                # re-count it (mirrors _on_dispatch's generation guard)
                return
            replica.dispatch_failures += 1
            replica.consecutive_failures += 1
            self._open_locked(replica,
                              failed_trial=replica.state == HALF_OPEN)
            sched = replica.scheduler
        log.error("pool %s: replica %d recycling (%s); draining and "
                  "rebuilding (next probe in %.1fs)", self.name,
                  replica.index, reason, replica.probe_backoff_s)
        self._drain_off_thread(sched, replica.index)
        self._probe_wake.set()
        self._notify_health()

    def _probe_loop(self) -> None:
        """Flip OPEN replicas to HALF_OPEN once their probe time comes;
        the router then hands each exactly one trial request."""
        while not self._closed:
            if self._draining:
                # a draining pool never comes back from OPEN: building a
                # fresh scheduler now would orphan its worker thread in
                # the teardown (the drain-vs-probe race class).  The
                # drain is terminal, so the prober simply exits.
                log.info("pool %s: probe loop exiting (pool draining)",
                         self.name)
                return
            with self._lock:
                due = [r for r in self.replicas
                       if r.state == OPEN and r.next_probe_at is not None]
                now = time.monotonic()
                wait = min((r.next_probe_at - now for r in due),
                           default=self.probe_interval_s)
            if wait > 0:
                self._probe_wake.wait(timeout=wait)
                self._probe_wake.clear()
                continue
            with self._lock:
                if self._closed or self._draining:
                    # shutdown()/start_draining() may have raced the
                    # wait above — installing a fresh scheduler now
                    # would leak its worker thread
                    return
                now = time.monotonic()
                ripe = []
                for r in self.replicas:
                    if (r.state == OPEN and r.next_probe_at is not None
                            and now >= r.next_probe_at):
                        # Push the next probe out now (at the replica's
                        # current backoff), so a trial that fails before
                        # its own _on_dispatch runs cannot re-probe in a
                        # tight loop.
                        r.next_probe_at = now + self._jittered(
                            r.probe_backoff_s or self.probe_interval_s)
                        ripe.append(r)
            # Fresh schedulers are built OUTSIDE the pool lock: scheduler
            # construction resolves the model's dispatch policy, which may
            # run a device probe (seconds on a cold backend) — holding the
            # lock here would stall routing/breaker bookkeeping on every
            # OTHER healthy replica for the duration (sonata-lint
            # lock-order pass; pinned by
            # test_replicas.test_probe_rebuild_does_not_hold_pool_lock).
            # Construction against a still-sick device can itself raise
            # (that same dispatch-policy probe): a failed build must not
            # kill this thread — it is the pool's ONLY path back from
            # OPEN — so the replica stays OPEN and retries at its next
            # (already backed-off) probe.
            fresh = []
            for r in ripe:
                try:
                    fresh.append((r, r._new_scheduler()))
                except Exception:
                    log.exception(
                        "pool %s: replica %d scheduler rebuild failed; "
                        "retrying at next probe", self.name, r.index)
                    with self._lock:
                        if r.state == OPEN:
                            r.probe_backoff_s = min(
                                (r.probe_backoff_s or
                                 self.probe_interval_s) * 2,
                                self.probe_max_s)
                            r.next_probe_at = (time.monotonic()
                                               + self._jittered(
                                                   r.probe_backoff_s))
            changed = False
            with self._lock:
                for r, sched in fresh:
                    if self._closed or self._draining or r.state != OPEN:
                        # raced shutdown()/start_draining() (or an
                        # operator state change): installing now would
                        # leak the worker thread
                        self._drain_off_thread(sched, r.index)
                        continue
                    # the old scheduler was drained at trip time
                    r.consecutive_failures = 0
                    # re-apply the recorded watchdog bound: this build's
                    # kwargs snapshot may predate a set_dispatch_timeout
                    # that ran while construction was off-lock
                    timeout = r._scheduler_kwargs.get("dispatch_timeout_s")
                    if timeout is not None:
                        sched.set_dispatch_timeout(timeout)
                    r.scheduler = sched
                    r.state = HALF_OPEN
                    changed = True
                    log.info("pool %s: replica %d half-open; next "
                             "request is its trial", self.name, r.index)
                closed = self._closed
            if changed:
                self._notify_health()
            if closed:
                return
