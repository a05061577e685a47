"""Serving runtime: admission control, deadlines, metrics, and health.

The layer every production inference stack grows once it must survive
overload and be observed in production (ROADMAP north star: heavy traffic
from millions of users).  Four orthogonal pieces:

- :mod:`.admission` — bounded admission (max in-flight + max queue
  depth); excess load fails fast with :class:`Overloaded` instead of
  queueing unboundedly.
- :mod:`.deadlines` — per-request :class:`Deadline` propagated into the
  batch scheduler, so expired or client-abandoned work is dropped
  *before* it reaches a device dispatch.
- :mod:`.metrics` — counter/gauge/histogram registry with Prometheus
  text exposition over a stdlib HTTP server.
- :mod:`.health` — liveness plus warmup-gated readiness for rolling
  restarts.
- :mod:`.tracing` — request-scoped span trees (Dapper-style) with
  coalesced-dispatch attribution, ring-buffered and served from the
  same HTTP plane at ``/debug/traces`` / ``/debug/slowest``.
- :mod:`.faults` — first-party failpoint injection (named sites, armed
  via ``SONATA_FAILPOINTS`` or ``/debug/failpoints``), the substrate the
  chaos smoke drives.
- :mod:`.degradation` — the graceful-degradation ladder: sustained
  shedding or watchdog fires move the process through named levels
  (shrink coalescing → reject batch work → readiness off), recovering
  by hysteresis.

:class:`ServingRuntime` bundles one of each with the standard instrument
set and the glue that exports existing observability (``RtfCounter``,
``dispatch_stats()``, scheduler stats) per voice.  Frontends construct
one runtime per process and thread it through their request paths; the
whole layer is frontend-agnostic — nothing in here imports gRPC.
"""

from __future__ import annotations

import time
from typing import Optional

from . import degradation as degradation_mod
from . import faults, tracing
from . import ledger as ledger_mod
from . import mesh as mesh_mod
from . import scope as scope_mod
from . import synthcache as synthcache_mod
from . import tenancy as tenancy_mod
from . import warmup as warmup_mod
from .admission import AdmissionController, Overloaded
from .deadlines import Deadline, DeadlineExceeded, default_timeout_s
from .degradation import DegradationLadder
from .drain import DrainCoordinator, Draining
from .faults import InjectedFault
from .health import HealthState
from .ledger import RequestLedger
from .metrics import (
    MetricsRegistry,
    parse_prometheus_text,
    resolve_metrics_port,
    start_http_server,
)
from .placement import PlacementPlane, VoiceWarming
from .replicas import ReplicaPool, resolve_replica_count
from .scope import Scope
from .synthcache import SynthCache
from .tracing import Trace, Tracer

__all__ = [
    "AdmissionController",
    "Overloaded",
    "Deadline",
    "DeadlineExceeded",
    "DegradationLadder",
    "DrainCoordinator",
    "Draining",
    "InjectedFault",
    "default_timeout_s",
    "degradation_mod",
    "faults",
    "ledger_mod",
    "RequestLedger",
    "HealthState",
    "mesh_mod",
    "MetricsRegistry",
    "parse_prometheus_text",
    "resolve_metrics_port",
    "start_http_server",
    "PlacementPlane",
    "ReplicaPool",
    "resolve_replica_count",
    "Scope",
    "SynthCache",
    "VoiceWarming",
    "scope_mod",
    "synthcache_mod",
    "tenancy_mod",
    "ServingRuntime",
    "Trace",
    "Tracer",
    "tracing",
    "warmup_mod",
]


class ServingRuntime:
    """One process's serving plane: admission + deadlines + metrics +
    health, pre-wired with the standard instrument set."""

    def __init__(self, *, max_in_flight: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 scope: Optional[Scope] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.health = HealthState(registry=self.registry)
        self.admission = AdmissionController(max_in_flight, max_queue_depth)
        #: request-scoped tracing: the process-wide default tracer unless
        #: one is injected (tests), so every frontend and the HTTP debug
        #: plane share one ring buffer
        self.tracer = tracer if tracer is not None else \
            tracing.default_tracer()
        #: server-side default when the client sets no deadline; None
        #: disables the default (explicit arg > env > 120 s).  An
        #: explicit <= 0 means "disabled" — same contract as the env
        #: knob — NOT "already expired".
        if request_timeout_s is None:
            self.request_timeout_s = default_timeout_s()
        else:
            self.request_timeout_s = (request_timeout_s
                                      if request_timeout_s > 0 else None)
        self.http: Optional["object"] = None
        #: per-voice labeled series created by register_voice, so
        #: unregister_voice removes exactly what was registered (no
        #: twin hardcoded name lists to keep in sync)
        self._voice_series: dict = {}

        r = self.registry
        self.requests = r.counter(
            "sonata_requests_total", "Requests admitted, by rpc.")
        self.failures = r.counter(
            "sonata_request_failures_total",
            "Requests failed, by rpc and grpc code.")
        self.shed = r.counter(
            "sonata_shed_total",
            "Requests rejected at admission (RESOURCE_EXHAUSTED).")
        self.expired = r.counter(
            "sonata_deadline_expired_total",
            "Requests or scheduler items dropped on an expired deadline.")
        self.ttfb = r.histogram(
            "sonata_ttfb_seconds",
            "Time to first audio of a synthesis stream.")
        self.synth_latency = r.histogram(
            "sonata_synth_seconds",
            "End-to-end synthesis request latency.")
        r.gauge(
            "sonata_in_flight",
            "Admitted requests currently held (executing or queued)."
        ).set_function(lambda: float(self.admission.in_flight))
        r.gauge(
            "sonata_admission_capacity",
            "Admission ceiling (max_in_flight + max_queue_depth)."
        ).set_function(lambda: float(self.admission.capacity))
        # admission sheds counted inside the controller surface here too,
        # so dashboards need only one source
        self.shed.labels(source="admission").set_function(
            lambda: float(self.admission.shed_total))
        self._started_at = time.monotonic()
        r.gauge("sonata_uptime_seconds", "Seconds since runtime start."
                ).set_function(
            lambda: time.monotonic() - self._started_at)
        #: stable node identity for the fleet tier: set by
        #: the frontend once it knows its bind address, via set_node_id
        self.node_id: Optional[str] = None
        #: fleet aggregation plane: set by the mesh router
        #: frontend before start_http, so the HTTP plane serves
        #: /debug/fleet and /debug/traces/stitched; None on backend
        #: nodes (they only *export*, via /debug/scope/export)
        self.fleet = None
        #: graceful drain: the process-wide drain flag + phase
        #: log + bounded in-flight wait; frontends' admission paths
        #: consult it so new work mid-drain fails typed (UNAVAILABLE,
        #: never RESOURCE_EXHAUSTED — a deploy is not overload)
        self.drain = DrainCoordinator()
        r.gauge(
            "sonata_draining",
            "1 while the process is draining for a restart (readiness "
            "off, new admissions refused typed), else 0."
        ).set_function(lambda: 1.0 if self.drain.draining else 0.0)
        #: bucket-lattice warmup progress: 0 → 1 as the boot
        #: warmup compiles its enumerated shapes; a gauge stuck below
        #: 1.0 is a wedged or over-budget warmup
        self.warmup_progress = warmup_mod.WarmupProgress()
        r.gauge(
            "sonata_warmup_progress",
            "Bucket-lattice warmup progress (0 at boot, done/total "
            "while compiling, 1 once warm; readiness waits for it)."
        ).set_function(self.warmup_progress.fraction)
        #: graceful-degradation ladder: admission sheds feed it directly;
        #: deep layers (scheduler queue-full, pool no-healthy, watchdog)
        #: feed the process-global install.  The gauge read doubles as
        #: the lazy hysteresis tick — every scrape decays a quiet ladder.
        self.degradation = DegradationLadder()
        degradation_mod.install(self.degradation)
        self.admission.on_shed = self.degradation.record_shed
        r.gauge(
            "sonata_degradation_level",
            "Graceful-degradation ladder level (0 normal, 1 shrink "
            "coalescing, 2 reject batch work, 3 readiness off)."
        ).set_function(lambda: float(self.degradation.current_level()))
        #: level 3 takes the process out of the serving set; recovery
        #: (hysteresis) flips /readyz back with no operator action
        self.health.add_readiness_gate(
            "degradation", lambda: self.degradation.current_level() < 3)
        #: chaos observability: series appear once a failpoint registry
        #: exists (counter semantics via scrape-time callbacks, like the
        #: replica series)
        fp = r.counter(
            "sonata_failpoint_fires_total",
            "Injected-fault firings since process start, by site.")
        for site in faults.SITES:
            fp.labels(site=site).set_function(
                lambda s=site: faults.fires_total(s))
        #: sonata-scope aggregation plane: rolling per-stage
        #: quantiles, SLO burn rates, dispatch padding-waste accounting,
        #: and the 1 Hz flight recorder.  SONATA_SCOPE=0 disables; the
        #: hooks then cost one module-global read.  Installed globally
        #: (like the ladder) so the scheduler and tracer feed it.
        self.scope: Optional[Scope] = None
        if scope is not None or scope_mod.scope_enabled():
            self.scope = scope if scope is not None else Scope()
            scope_mod.install(self.scope)
            self.scope.bind_metrics(r)
            self.scope.add_probe(
                "in_flight", lambda: float(self.admission.in_flight))
            self.scope.add_probe(
                "shed_total", lambda: float(self.admission.shed_total))
            self.scope.start()
        #: content-addressed synthesis cache: enabled by
        #: SONATA_SYNTH_CACHE_MB > 0 (default off — the request path is
        #: then byte-for-byte the pre-cache shape).  The frontends probe
        #: it ahead of pool/iteration-loop admission; its hit/miss/
        #: bytes series ride the metrics plane as scrape-time callbacks
        #: and its hit-ratio rows ride the scope plane.
        self.synth_cache: Optional[SynthCache] = synthcache_mod.from_env()
        if self.synth_cache is not None:
            self.synth_cache.bind_metrics(r)
            if self.scope is not None:
                self.scope.attach_cache_stats(self.synth_cache.cache_view)
                self.scope.add_probe(
                    "cache_hit_ratio",
                    lambda: self.synth_cache.hit_ratio())
                self.scope.add_probe(
                    "cache_bytes",
                    lambda: float(self.synth_cache.bytes_used))
        #: tenant control plane: enabled by SONATA_TENANTS
        #: (default off — every RPC path is then byte-for-byte the
        #: pre-tenancy shape, pinned).  The fair gate sizes its slots to
        #: the admission controller's in-flight ceiling: below it entry
        #: is immediate, at it the DRR queues take over.
        self.tenancy: Optional[tenancy_mod.TenantPlane] = \
            tenancy_mod.from_env(fair_slots=self.admission.max_in_flight)
        if self.tenancy is not None:
            self.tenancy.bind_metrics(r)
            self.shed.labels(source="tenancy").set_function(
                lambda: sum(self.tenancy.stat(t, "shed")
                            for t in self.tenancy.tenant_names()))
            if self.scope is not None:
                # padding-waste chargeback: the scope pro-rates each
                # dispatch's waste over the tenants running synthesis
                # at that moment
                self.scope.attach_tenant_mix(self.tenancy.active_mix)
            if self.synth_cache is not None:
                # per-tenant insert budgets: a tenant's committed bytes
                # are bounded to cache_share x SONATA_SYNTH_CACHE_MB
                # (tenancy never joins the cache KEY — identical text
                # still dedups across tenants)
                self.synth_cache.set_share_resolver(
                    self.tenancy.cache_share)
        #: per-request wide-event ledger: enabled by
        #: SONATA_LEDGER_MB > 0 (default off — the request path is then
        #: byte-for-byte the pre-ledger shape and zero new metric
        #: series exist).  Frontends begin/emit records; the ring is
        #: served by GET /debug/requests on the metrics plane.
        self.ledger: Optional[RequestLedger] = ledger_mod.from_env()
        if self.ledger is not None:
            self.ledger.bind_metrics(r)
        #: per-voice flight-recorder probes added by register_voice, so
        #: unregister removes exactly what was added
        self._voice_probes: dict = {}

    # -- node identity (fleet tier) ------------------------------------------
    def set_node_id(self, node_id: str) -> None:
        """Stable node identity (``SONATA_NODE_ID`` or the bind
        ``host:port``): exported as ``sonata_node_info{node_id=...}``,
        appended to ``/readyz``, answered in ``CheckHealth``, and
        stamped into gRPC trailing metadata — so sonata-mesh router
        logs/spans name the backend that served each request instead of
        an opaque channel."""
        self.node_id = node_id
        self.health.node_id = node_id
        if self.ledger is not None:
            # every subsequent record names the node that served it
            self.ledger.node_id = node_id
        self.registry.gauge(
            "sonata_node_info",
            "Constant 1, labeled with this process's stable node_id "
            "(SONATA_NODE_ID, default the gRPC bind host:port)."
        ).labels(node_id=node_id).set(1.0)

    # -- graceful drain ------------------------------------------------------
    def begin_drain(self, reason: str = "shutdown") -> bool:
        """Enter the drain state: readiness flips off FIRST (the load
        balancer stops routing here before anything tears down), then
        the admission paths refuse new work typed.  First caller wins;
        returns whether this call started the drain."""
        first = self.drain.begin(reason)
        if first:
            self.health.set_not_ready(f"draining: {reason}")
        return first

    # -- deadlines -----------------------------------------------------------
    def deadline_for(self, context=None) -> Deadline:
        """Per-request deadline: client gRPC deadline > server default."""
        if context is None:
            return Deadline.after(self.request_timeout_s)
        return Deadline.from_grpc_context(
            context, default_s=self.request_timeout_s)

    # -- HTTP plane ----------------------------------------------------------
    def start_http(self, port: Optional[int] = None,
                   host: Optional[str] = None) -> Optional[int]:
        """Start the /metrics + /healthz + /readyz server if configured.

        Returns the bound port, or None when disabled (no explicit port
        and no ``SONATA_METRICS_PORT``)."""
        resolved = resolve_metrics_port(port)
        if resolved is None:
            return None
        self.http = start_http_server(self.registry, health=self.health,
                                      port=resolved, host=host,
                                      tracer=self.tracer, scope=self.scope,
                                      fleet=self.fleet,
                                      tenancy=self.tenancy,
                                      ledger=self.ledger)
        return self.http.port

    @property
    def http_port(self) -> Optional[int]:
        return self.http.port if self.http is not None else None

    # -- per-voice observability wiring --------------------------------------
    def register_voice(self, voice_id: str, *, rtf_counter=None,
                       dispatch_stats=None, scheduler=None,
                       replica_pool=None) -> None:
        """Export an existing voice's counters as labeled gauge series.

        Everything is callback-based: the scrape reads live state, the
        hot path pays nothing.  ``dispatch_stats`` is the zero-arg
        callable from ``PiperVoice.dispatch_stats`` /
        ``SpeechSynthesizer.dispatch_stats``.  ``replica_pool`` adds the
        per-replica series (outstanding, dispatches, breaker state,
        device id) and pool-level routing counters.
        """
        r = self.registry
        lbl = {"voice": voice_id}
        owned = self._voice_series.setdefault(voice_id, [])

        def labeled_gauge(name, help, fn, labels):
            metric = r.gauge(name, help)
            metric.labels(**labels).set_function(fn)
            owned.append((metric, labels))

        def voice_gauge(name, help, fn):
            labeled_gauge(name, help, fn, lbl)

        # actual-state signal for the fleet tier: the
        # sonata-mesh placement reconciler scrapes this gauge (and the
        # /readyz ``voices=`` twin maintained on the health plane) to
        # diff a node's resident voices against its desired state
        self.health.note_voice(voice_id)
        voice_gauge("sonata_voice_loaded",
                    "1 while this voice is loaded and serving on this "
                    "node (the actual-state signal the sonata-mesh "
                    "placement reconciler diffs against desired state).",
                    lambda: 1.0)
        if rtf_counter is not None:
            def stat(attr):
                return lambda: float(getattr(rtf_counter.snapshot(), attr))

            voice_gauge("sonata_voice_utterances",
                        "Utterances synthesized, per voice.",
                        stat("utterances"))
            voice_gauge("sonata_voice_rtf",
                        "Aggregate real-time factor, per voice "
                        "(inference ms / audio ms).",
                        lambda: float(rtf_counter.snapshot().rtf))
            voice_gauge("sonata_voice_audio_ms",
                        "Total audio milliseconds synthesized, per voice.",
                        stat("audio_ms"))
        if dispatch_stats is not None:
            def stage_stat(stage, key):
                def read():
                    stats = dispatch_stats()
                    s = (stats or {}).get(stage)
                    return float(s[key]) if s else None
                return read

            for stage in ("stream_decode", "stream_stage"):
                for key in ("requests", "dispatches"):
                    voice_gauge(f"sonata_{stage}_{key}",
                                f"Stream coalescer {key}, per voice.",
                                stage_stat(stage, key))
        if self.scope is not None:
            # dispatch padding-waste accumulator (scope plane): counter
            # semantics via a scrape-time callback, like the replica
            # series; the scope keys on the voice label the scheduler
            # stamps into its dispatch attribution
            waste = r.counter(
                "sonata_dispatch_padding_waste_seconds_total",
                "Device-dispatch seconds spent on padding rows "
                "(dispatch duration x padding_ratio, accumulated), "
                "per voice.")
            waste.labels(**lbl).set_function(
                lambda v=voice_id: self.scope.padding_waste_seconds(v))
            owned.append((waste, lbl))
            # cold-compile containment: compiles AFTER warmup completion
            # are lattice-coverage regressions — zero under smoke
            # traffic is the acceptance bar, and any nonzero value also
            # ships a flight-recorder incident
            cold = r.counter(
                "sonata_runtime_cold_compiles_total",
                "Device dispatches that paid an XLA compile after the "
                "boot warmup completed (warmup-lattice coverage holes), "
                "per voice.")
            cold.labels(**lbl).set_function(
                lambda v=voice_id: self.scope.runtime_cold_compiles(v))
            owned.append((cold, lbl))
        if scheduler is not None:
            voice_gauge("sonata_scheduler_queue_depth",
                        "Items waiting in the batch scheduler, per voice.",
                        lambda: float(scheduler.queue_depth()))
            if self.scope is not None:
                # flight-recorder probes ride the same registration so
                # the timeline names the voice's queue
                probes = self._voice_probes.setdefault(voice_id, [])
                name = f"queue_depth:{voice_id}"
                self.scope.add_probe(
                    name, lambda: float(scheduler.queue_depth()))
                probes.append(name)

            # stats_view() instead of raw .stats: a ReplicaPool passed as
            # the voice's scheduler aggregates its per-replica scheduler
            # counters under the same keys
            def sched_stat(key):
                return lambda: float(scheduler.stats_view().get(key, 0))

            for key, help in (
                    ("requests", "Scheduler items submitted"),
                    ("dispatches", "Scheduler device dispatches"),
                    ("expired", "Scheduler items dropped on expired "
                                "deadlines"),
                    ("cancelled", "Scheduler items dropped on client "
                                  "cancellation"),
                    ("shed", "Scheduler items rejected on a full queue"),
                    ("stuck", "Scheduler dispatches killed by the "
                              "hung-dispatch watchdog")):
                voice_gauge(f"sonata_scheduler_{key}",
                            f"{help}, per voice.", sched_stat(key))
            # time-in-queue histogram (the observability gap the
            # shed/expired counters left): both BatchScheduler and
            # ReplicaPool expose .queue_wait, the pool's aggregated
            # across its replicas' schedulers
            queue_wait = getattr(scheduler, "queue_wait", None)
            if queue_wait is not None:
                metric = r.histogram(
                    "sonata_queue_wait_seconds",
                    "Time requests spend in the batch-scheduler queue "
                    "before a device dispatch (or drop), per voice.",
                    buckets=queue_wait.bounds)
                metric.attach(queue_wait, **lbl)
                owned.append((metric, lbl))
        if replica_pool is not None:
            self._register_replica_pool(voice_id, replica_pool,
                                        labeled_gauge, voice_gauge)

    def _register_replica_pool(self, voice_id, pool, labeled_gauge,
                               voice_gauge) -> None:
        """Per-replica gauges + pool-level routing/breaker counters.

        Replica series carry a ``replica`` label next to ``voice``; the
        breaker state gauge is numeric (0 closed / 1 half-open / 2 open)
        so a dashboard can alert on ``> 0``.
        """
        r = self.registry
        owned = self._voice_series.setdefault(voice_id, [])
        for replica in pool.replicas:
            rl = {"voice": voice_id, "replica": str(replica.index)}

            def attr(r, name):
                return lambda: float(getattr(r, name))

            labeled_gauge("sonata_replica_outstanding",
                          "Requests routed to a replica and not yet "
                          "resolved.", attr(replica, "outstanding"), rl)
            labeled_gauge("sonata_replica_dispatches",
                          "Successful device dispatches, per replica.",
                          attr(replica, "dispatches"), rl)
            labeled_gauge("sonata_replica_dispatch_failures",
                          "Failed device dispatches, per replica.",
                          attr(replica, "dispatch_failures"), rl)
            # counter semantics via a scrape-time callback, like the rest
            # of the replica series: resubmissions used to be visible
            # only as the pool-level aggregate — this names the replica
            # whose failures pushed requests elsewhere
            resub = r.counter(
                "sonata_replica_resubmits_total",
                "Requests that failed on this replica and were "
                "resubmitted to another.")
            resub.labels(**rl).set_function(attr(replica, "resubmits"))
            owned.append((resub, rl))
            labeled_gauge("sonata_replica_breaker_state",
                          "Circuit breaker: 0 closed, 1 half-open, "
                          "2 open.", attr(replica, "state"), rl)
            labeled_gauge("sonata_replica_device",
                          "JAX device id this replica is pinned to.",
                          lambda r=replica: float(r.device_id), rl)

        def pool_stat(key):
            return lambda: float(pool.stats.get(key, 0))

        for key, help in (
                ("routed", "Requests routed into the replica pool"),
                ("resubmitted", "Requests resubmitted to another replica "
                                "after a replica fault"),
                ("failed", "Requests that failed out of the pool"),
                ("breaker_opens", "Circuit-breaker trips"),
                ("recovered", "Breakers closed again by a successful "
                              "trial")):
            voice_gauge(f"sonata_pool_{key}", f"{help}, per voice.",
                        pool_stat(key))
        voice_gauge("sonata_pool_healthy_replicas",
                    "Replicas currently accepting traffic, per voice.",
                    lambda: float(pool.healthy_count()))
        voice_gauge("sonata_pool_replicas",
                    "Total replicas in the pool, per voice.",
                    lambda: float(len(pool.replicas)))
        if self.scope is not None:
            probes = self._voice_probes.setdefault(voice_id, [])
            name = f"healthy_replicas:{voice_id}"
            self.scope.add_probe(name,
                                 lambda: float(pool.healthy_count()))
            probes.append(name)

    def unregister_voice(self, voice_id: str) -> None:
        """Drop a voice's labeled series after UnloadVoice — exactly the
        (metric, labels) pairs register_voice created (recorded per
        voice, so the two methods cannot drift apart), releasing the
        closures that would otherwise pin the unloaded voice's objects."""
        self.health.drop_voice(voice_id)
        for metric, labels in self._voice_series.pop(voice_id, []):
            metric.remove(**labels)
        for probe in self._voice_probes.pop(voice_id, []):
            if self.scope is not None:
                self.scope.remove_probe(probe)

    def close(self) -> None:
        degradation_mod.uninstall(self.degradation)
        if self.tenancy is not None:
            self.tenancy.close()
        if self.synth_cache is not None:
            self.synth_cache.close()
        if self.scope is not None:
            scope_mod.uninstall(self.scope)
            self.scope.close()
        if self.ledger is not None:
            self.ledger.close()
        if self.http is not None:
            self.http.stop()
            self.http = None
