"""sonata-mesh router frontend: one gRPC endpoint over N backend nodes.

The fleet tier (``serving/mesh.py``) made concrete: this server speaks
the exact sonata gRPC surface (same service path, same
:mod:`.grpc_messages` codec — existing clients point at the router
unchanged) and forwards every RPC to the backend sonata servers named by
``SONATA_MESH_BACKENDS`` / ``--backend``, with health-gated membership,
per-node breakers, least-outstanding routing, deadline propagation, and
drain/kill-safe rerouting supplied by
:class:`~sonata_tpu_torch.serving.mesh.MeshRouter`.

Design points specific to the hop:

- **Streaming payloads are forwarded as raw bytes** — the router
  decodes the (tiny) request to learn the voice id but never touches
  the audio frames: backend chunks pass through byte-for-byte, which is
  most of why the router-hop TTFB overhead stays inside the MESH_r01
  budget.
- **The trace crosses the hop**: the router accepts (or generates) the
  ``x-request-id``, records its own span tree (admission →
  mesh-dispatch → stream-emit, with ``mesh-reroute`` spans on
  failover), and forwards the id to the backend — the backend's trace
  carries the same id, so one Perfetto load of both ``/debug/traces``
  shows router queue → node dispatch end to end.
- **Unary surface**: voice management (``LoadVoice`` / ``UnloadVoice``
  / ``SetSynthesisOptions``) records *desired state* in the placement
  plane and applies it to the voice's assigned nodes
  (``SONATA_PLACEMENT_REPLICAS``, default all); the anti-entropy
  reconciler riding the membership probers replays missed ops to
  nodes that were down, breaker-open, or restarted later — one
  reachable node is enough for the RPC to succeed.  Lookups
  (``GetVoiceInfo`` / ``GetSynthesisOptions`` / ``ListVoices``) forward
  to a routable node (preferring converged holders of the requested
  voice); ``CheckHealth`` / ``GetSonataVersion`` answer for the router
  itself.
- **The router drains like a node**: SIGTERM runs the same pinned
  ``DRAIN_PHASES`` order (readiness off first, typed refusals, bounded
  in-flight wait) — the "voices" phase closes mesh membership probing
  instead of voices.
- **The router is the fleet's observability plane**: a
  :class:`~sonata_tpu_torch.serving.fleetscope.FleetScope` rides the
  membership probers, scraping each node's ``/debug/scope/export`` and
  serving fleet-merged quantiles/SLO burn (`sonata_fleet_*` families),
  the ``/debug/fleet`` scoreboard, stitched cross-host traces at
  ``/debug/traces/stitched?id=``, and a fleet flight recorder that
  auto-dumps on node eviction, breaker trips, and fast-burn breaches.

Binds ``127.0.0.1:$SONATA_MESH_PORT`` (default 49315, one above the
backend default so a laptop runs both).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Iterator, Optional

import grpc

from .. import __version__
from ..core import OperationError, SonataError
from ..serving import (
    DeadlineExceeded,
    Draining,
    Overloaded,
    ServingRuntime,
    faults,
    synthcache,
    tracing,
)
from ..serving import fleetcache as fleetcache_mod
from ..serving import ledger as ledger_mod
from ..serving import tenancy as tenancy_mod
from ..serving.fleetscope import FleetScope
from ..serving.logs import configure_logging
from ..serving.mesh import (
    MeshRouter,
    _http_fetch,
    parse_backends,
    resolve_node_id,
)
from ..serving.placement import PlacementPlane, VoiceWarming
from ..serving.replicas import OPEN
from . import grpc_messages as pb
from .grpc_server import (
    _METHODS,
    _SERVICE_PATH,
    _add_trailers,
    _context_request_id,
    _ledger_record,
    _status_for,
    voice_id_for,
)

log = logging.getLogger("sonata.mesh")

DEFAULT_PORT = 49315
PORT_ENV = "SONATA_MESH_PORT"

#: router-side metric families, loop-registered like the scope's
#: GAUGE_FAMILIES so the sonata-lint metricsdoc pass resolves the names
MESH_COUNTER_FAMILIES = (
    ("sonata_mesh_routed_total", "routed",
     "Streaming requests routed into the mesh."),
    ("sonata_mesh_rerouted_total", "rerouted",
     "Requests rerouted to another node (route-class failure, "
     "draining refusal, or first-chunk hedge) before any audio "
     "streamed."),
    ("sonata_mesh_rerouted_draining_total", "rerouted_draining",
     "Of the reroutes, those caused by a typed draining refusal "
     "(rolling-deploy traffic, not faults)."),
    ("sonata_mesh_hedged_total", "hedged",
     "Of the reroutes, those fired by the first-chunk hedge budget "
     "(SONATA_MESH_HEDGE_MS)."),
    ("sonata_mesh_failed_total", "failed",
     "Requests that failed out of the mesh (typed to the client)."),
    ("sonata_mesh_breaker_opens_total", "breaker_opens",
     "Node circuit-breaker trips."),
    ("sonata_mesh_recovered_total", "recovered",
     "Node breakers closed again by a successful trial request."),
    ("sonata_mesh_probe_failures_total", "probe_failures",
     "Node health probes that failed (unreachable health plane)."),
)

MESH_NODE_GAUGES = (
    ("sonata_mesh_node_outstanding", "outstanding",
     "Router-side in-flight requests, per backend node."),
    ("sonata_mesh_node_breaker_state", "state",
     "Node breaker: 0 closed, 1 half-open, 2 open."),
    ("sonata_mesh_node_draining", "draining",
     "1 while the node reports draining (evicted from membership), "
     "else 0."),
    ("sonata_mesh_node_reported_outstanding", "reported_outstanding",
     "Backend-scraped occupancy (sonata_replica_outstanding sum, "
     "fallback sonata_in_flight), per node."),
)


def _classify_rpc_error(exc: BaseException) -> str:
    """gRPC-aware failure classes for the router's retry contract."""
    if isinstance(exc, Draining):
        return "draining"
    if isinstance(exc, faults.InjectedFault):
        return "route"
    code = getattr(exc, "code", None)
    code = code() if callable(code) else None
    if code == grpc.StatusCode.UNAVAILABLE:
        details = ""
        det = getattr(exc, "details", None)
        if callable(det):
            try:
                details = det() or ""
            except Exception:
                details = ""
        # a draining refusal is a deploy (evict + immediate
        # reroute); every other UNAVAILABLE is a connect/route fault
        return "draining" if "draining" in details else "route"
    if code in (grpc.StatusCode.CANCELLED, grpc.StatusCode.INTERNAL):
        # CANCELLED: our own hedge/cleanup cancel (a client hangup
        # surfaces as GeneratorExit on the router generator, never as
        # this).  INTERNAL: how a SIGKILLed peer surfaces to streams
        # caught mid-handshake (RST_STREAM) — route_stream only ever
        # retries pre-first-chunk, so a genuine INTERNAL from a live
        # node still fails typed after the bounded retry.
        return "route"
    return "fatal"


class SonataMeshService:
    """RPC implementations over a :class:`MeshRouter` membership."""

    def __init__(self, router: MeshRouter,
                 runtime: Optional[ServingRuntime] = None):
        self.router = router
        self.runtime = runtime if runtime is not None else ServingRuntime()
        self.fleetcache = None  # built after the fleet scope
        self._channels: dict = {}
        #: (addr, method) -> stream multicallable: building one per
        #: request costs real TTFB on the hop (measured by bench_mesh)
        self._stream_stubs: dict = {}
        self._chan_lock = threading.Lock()
        #: (metric, labels) pairs created by _register_metrics, so the
        #: teardown removes exactly what was registered (the per-voice
        #: series idiom from ServingRuntime.register_voice)
        self._node_series: list = []
        rt = self.runtime
        #: zero routable nodes must flip the router's /readyz — the
        #: fleet balancer routes around this router until a backend
        #: rejoins (probes flip it back with no restart)
        rt.health.add_readiness_gate(
            "mesh:nodes", lambda: self.router.routable_count() > 0)
        rt.health.set_ready(
            f"mesh router over {len(router.nodes)} node(s)")
        self._register_metrics()
        #: sonata-placement: the desired-state voice
        #: registry + anti-entropy reconciler.  Voice ops through this
        #: router are recorded and REPLAYED — a SIGKILLed-and-restarted
        #: backend rejoins and gets its voices back with no operator
        #: action; routing is voice-aware (converged holders only, a
        #: typed voice-warming refusal after the bounded wait).  The
        #: reconcile loop rides the router's per-node prober threads.
        self.placement = PlacementPlane(
            router,
            apply_load=self._apply_load,
            apply_unload=self._apply_unload,
            apply_options=self._apply_options)
        router.attach_placement(self.placement)
        self.placement.bind_metrics(rt.registry)
        #: sonata-fleetscope: fleet-merged quantiles/burn,
        #: the /debug/fleet scoreboard, stitched traces, and the fleet
        #: flight recorder — scraping rides the router's probers
        self.fleet = FleetScope(router, tracer=rt.tracer)
        router.attach_fleet(self.fleet)
        self.fleet.bind_metrics(rt.registry)
        rt.fleet = self.fleet  # the HTTP plane serves /debug/fleet
        self.fleet.start()
        #: sonata-fleetcache: cache-affinity routing, router
        #: single-flight, and hot-set replication.  Opt-in via
        #: SONATA_FLEETCACHE=1 — off, the router's routing decisions and
        #: stream path are byte-for-byte the ones.
        if fleetcache_mod.resolve_enabled():
            self.fleetcache = fleetcache_mod.FleetCache(
                router, fleet=self.fleet)
            self.fleetcache.set_replicate_transport(self._replicate_stream)
            router.attach_fleetcache(self.fleetcache)
            self.fleetcache.bind_metrics(rt.registry)
        #: sonata-tenancy: when the router runs with a
        #: tenant table (SONATA_TENANTS — the runtime built rt.tenancy
        #: from it), quota enforcement moves HERE: routed streams are
        #: charged at the router and stamped with the
        #: x-sonata-tenant-quota marker so nodes skip double-charging
        #: (per-node buckets stay the fallback for direct traffic), and
        #: the table itself is pushed to every node's /debug/tenants on
        #: the prober threads — the placement desired-state pattern.
        self.tenancy_propagator = None
        if rt.tenancy is not None:
            self.tenancy_propagator = tenancy_mod.ConfigPropagator(
                rt.tenancy)
            router.attach_tenancy(self.tenancy_propagator)
        #: sonata-ledger: /debug/requests?id= on the router
        #: merges the serving node's own record into the hop record by
        #: x-request-id (the stitched-trace pattern) — one document
        #: shows router reroutes next to node-side cost
        if rt.ledger is not None:
            rt.ledger.set_node_record_fetcher(self._fetch_node_record)

    # -- placement replay transport (the plane's apply_* callables) ----------
    def _apply_load(self, node, config_path: str):
        info = self._call_unary(
            node, "LoadVoice", pb.VoicePath(config_path=config_path),
            pb.VoiceInfo, 600.0)  # a replayed load may compile cold
        self._learn_voice(info)
        return info

    def _apply_unload(self, node, voice_id: str) -> None:
        try:
            self._call_unary(node, "UnloadVoice",
                             pb.VoiceIdentifier(voice_id=voice_id),
                             pb.Empty, 60.0)
        except grpc.RpcError as e:
            code = getattr(e, "code", None)
            code = code() if callable(code) else None
            if code != grpc.StatusCode.NOT_FOUND:
                raise  # already gone there == retired

    def _apply_options(self, node, payload: bytes):
        req = pb.VoiceSynthesisOptions.decode(payload)
        resp = self._call_unary(node, "SetSynthesisOptions", req,
                                pb.SynthesisOptions, 30.0)
        # a replayed option change moves the node's cache key: keep the
        # router's per-voice key inputs in lock-step
        if self.fleetcache is not None and resp is not None:
            self.fleetcache.update_options(req.voice_id, resp)
        return resp

    # -- fleet-cache plumbing (serving/fleetcache.py) --------------
    def _replicate_stream(self, node, rpc_name: str, payload: bytes,
                          key: str) -> None:
        """Replay a remembered synthesis request to ``node`` so its
        cache warms the template (hot-set replication transport).
        The audio is drained and dropped — the side effect is the fill."""
        fn = self._stream_stub(node, rpc_name)
        md = (("x-request-id", f"replicate-{key[:12]}"),)
        for _ in fn(payload, timeout=60.0, metadata=md):
            pass

    def _learn_voice(self, info) -> None:
        """Teach the affinity tier a voice's cache-key inputs from a
        node's VoiceInfo response (scales, speaker map, audio shape)."""
        if self.fleetcache is not None and info is not None:
            self.fleetcache.learn_voice(info)

    def _register_metrics(self) -> None:
        r = self.runtime.registry
        router = self.router
        r.gauge(
            "sonata_mesh_nodes",
            "Backend nodes configured in the mesh."
        ).set_function(lambda: float(len(router.nodes)))
        r.gauge(
            "sonata_mesh_healthy_nodes",
            "Backend nodes currently routable (breaker not open, ready, "
            "not draining) — the router's readiness gate."
        ).set_function(lambda: float(router.routable_count()))
        for name, key, help_text in MESH_COUNTER_FAMILIES:
            r.counter(name, help_text).set_function(
                lambda k=key: float(router.stats.get(k, 0)))
        for name, attr, help_text in MESH_NODE_GAUGES:
            metric = r.gauge(name, help_text)
            for node in router.nodes:
                labels = {"node": node.spec.addr}
                metric.labels(**labels).set_function(
                    lambda n=node, a=attr: float(getattr(n, a)))
                self._node_series.append((metric, labels))

    def unregister_node_series(self) -> None:
        """Drop the per-node labeled series (teardown twin of
        :meth:`_register_metrics`), releasing the closures that would
        otherwise pin the router's nodes past shutdown."""
        for metric, labels in self._node_series:
            metric.remove(**labels)
        self._node_series = []

    # -- channels -------------------------------------------------------------
    def _channel(self, node) -> grpc.Channel:
        with self._chan_lock:
            ch = self._channels.get(node.spec.addr)
            if ch is None:
                # one cached channel per node; gRPC reconnects through
                # backend restarts, so membership rejoin needs no churn
                ch = grpc.insecure_channel(node.spec.addr)
                self._channels[node.spec.addr] = ch
            return ch

    def _stream_stub(self, node, name: str):
        key = (node.spec.addr, name)
        with self._chan_lock:
            stub = self._stream_stubs.get(key)
        if stub is None:
            channel = self._channel(node)
            stub = channel.unary_stream(
                f"/{_SERVICE_PATH}/{name}",
                request_serializer=None,
                response_deserializer=None)
            with self._chan_lock:
                self._stream_stubs[key] = stub
        return stub

    def _call_unary(self, node, name: str, request, resp_cls,
                    timeout_s: float):
        fn = self._channel(node).unary_unary(
            f"/{_SERVICE_PATH}/{name}",
            request_serializer=lambda m: m.encode(),
            response_deserializer=resp_cls.decode)
        return fn(request, timeout=timeout_s)

    def _routable_node(self, context, voice_id: Optional[str] = None):
        nodes = [n for n in self.router.nodes
                 if n.state != OPEN and n.ready and not n.draining]
        if voice_id and self.placement.has_voice(voice_id):
            # voice-aware lookup forwarding: prefer a converged holder
            # so GetVoiceInfo does not 404 off a not-yet-reconciled node
            holders = [n for n in nodes
                       if n.loaded_voices is None
                       or voice_id in n.loaded_voices]
            if holders:
                nodes = holders
        if not nodes:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"mesh {self.router.name!r}: no routable "
                          "backend node")
        return nodes[0]

    # -- unary RPCs -----------------------------------------------------------
    def GetSonataVersion(self, request: pb.Empty, context) -> pb.Version:
        return pb.Version(version=__version__)

    def CheckHealth(self, request: pb.Empty, context) -> pb.HealthStatus:
        h = self.runtime.health.snapshot()
        return pb.HealthStatus(live=h["live"], ready=h["ready"],
                               reason=h["reason"], version=__version__,
                               node_id=h.get("node_id") or "")

    def _fanout(self, name: str, request, resp_cls, context,
                timeout_s: float):
        """Voice management reaches every reachable node; the last
        response is returned (they agree — same voice config path ⇒
        same voice id on every node).  Any node failing fails the call
        typed: a half-loaded fleet is worse than a failed load."""
        self.runtime.drain.raise_if_draining()
        nodes = [n for n in self.router.nodes
                 if n.state != OPEN and not n.draining]
        if not nodes:
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"mesh {self.router.name!r}: no reachable "
                          "backend node")
        last = None
        for node in nodes:
            try:
                last = self._call_unary(node, name, request, resp_cls,
                                        timeout_s)
            except grpc.RpcError as e:
                context.abort(
                    e.code() if callable(getattr(e, "code", None))
                    and e.code() is not None else grpc.StatusCode.UNKNOWN,
                    f"node {node.node_id}: {e.details() or ''}")
        return last

    def LoadVoice(self, request: pb.VoicePath, context) -> pb.VoiceInfo:
        """Record the voice as desired state, then load it onto its
        placement (``SONATA_PLACEMENT_REPLICAS`` nodes, default all).

        Unlike the best-effort fan-out, one reachable node
        suffices for success — the anti-entropy reconciler replays the
        load to every other assigned node (including ones that are
        down, breaker-open, or restarted *later*), which is what closes
        the rejoins-without-voices gap.  Zero successes rolls the
        desired record back and fails typed."""
        if not request.config_path:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "config_path is required")
        self.runtime.drain.raise_if_draining()
        vid = voice_id_for(request.config_path)
        created = self.placement.record_load(vid, request.config_path)
        info, last_err = None, None
        for node in self.placement.assigned_nodes(vid):
            if node.state == OPEN or node.draining:
                continue  # the reconciler replays once it rejoins
            try:
                info = self._call_unary(node, "LoadVoice", request,
                                        pb.VoiceInfo, 600.0)
                self.placement.note_applied(node, vid)
                self.router.note_voice_loaded(node, vid)
            except grpc.RpcError as e:
                last_err = (node, e)
                log.warning("mesh %s: LoadVoice on node %s failed "
                            "(reconciler will replay): %s", self.router.name,
                            node.node_id, e)
        if info is None:
            if created:
                # the op reached nobody: no ghost desired state
                self.placement.forget_load(vid)
            if last_err is not None:
                node, e = last_err
                context.abort(
                    e.code() if callable(getattr(e, "code", None))
                    and e.code() is not None else grpc.StatusCode.UNKNOWN,
                    f"node {node.node_id}: {e.details() or ''}")
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"mesh {self.router.name!r}: no reachable "
                          "backend node to load the voice on")
        self._learn_voice(info)
        return info

    def UnloadVoice(self, request: pb.VoiceIdentifier,
                    context) -> pb.Empty:
        """Tombstone the voice (nothing ever resurrects it) and unload
        it from every reachable node; nodes that are down now are
        retired by the reconciler when they rejoin."""
        self.runtime.drain.raise_if_draining()
        vid = request.voice_id
        known = self.placement.record_unload(vid)
        found = False
        for node in self.router.nodes:
            if node.state == OPEN or node.draining:
                continue
            if (node.loaded_voices is not None
                    and vid not in node.loaded_voices and known):
                continue  # known-absent there: nothing to do
            try:
                self._call_unary(node, "UnloadVoice", request, pb.Empty,
                                 60.0)
                found = True
                self.router.note_voice_unloaded(node, vid)
            except grpc.RpcError as e:
                code = getattr(e, "code", None)
                code = code() if callable(code) else None
                if code == grpc.StatusCode.NOT_FOUND:
                    continue
                if not known:
                    context.abort(code or grpc.StatusCode.UNKNOWN,
                                  f"node {node.node_id}: "
                                  f"{e.details() or ''}")
                log.warning("mesh %s: UnloadVoice on node %s failed "
                            "(reconciler will retire): %s",
                            self.router.name, node.node_id, e)
        if not found and not known:
            # the unload found the voice NOWHERE and the registry never
            # knew it: roll the tombstone back out, or a node later
            # boot-loading this id would be silently retired by an op
            # the client was told failed
            self.placement.forget_unload(vid)
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no voice with id {vid}")
        if self.fleetcache is not None:
            self.fleetcache.forget_voice(vid)
        return pb.Empty()

    def SetSynthesisOptions(self, request: pb.VoiceSynthesisOptions,
                            context) -> pb.SynthesisOptions:
        """Apply the options to every current holder, then record the
        payload as desired state (replayed verbatim to late joiners by
        the reconciler).  Apply-before-record: an RPC that reaches no
        holder aborts typed with NOTHING recorded — the registry must
        never hold options the client was told failed.  Voices the
        registry has never seen — node boot-config voices — keep the
        fan-out path."""
        vid = request.voice_id
        if not self.placement.has_voice(vid):
            last = self._fanout("SetSynthesisOptions", request,
                                pb.SynthesisOptions, context,
                                timeout_s=30.0)
            if self.fleetcache is not None and last is not None:
                self.fleetcache.update_options(vid, last)
            return last
        self.runtime.drain.raise_if_draining()
        last, last_err = None, None
        applied_nodes = []
        for node in self.placement.assigned_nodes(vid):
            if node.state == OPEN or node.draining:
                continue
            if (node.loaded_voices is not None
                    and vid not in node.loaded_voices):
                continue  # not resident yet: the load replay carries it
            try:
                last = self._call_unary(node, "SetSynthesisOptions",
                                        request, pb.SynthesisOptions,
                                        30.0)
                applied_nodes.append(node)
            except grpc.RpcError as e:
                last_err = (node, e)
        if last is None:
            if last_err is not None:
                node, e = last_err
                context.abort(
                    e.code() if callable(getattr(e, "code", None))
                    and e.code() is not None else grpc.StatusCode.UNKNOWN,
                    f"node {node.node_id}: {e.details() or ''}")
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          f"mesh {self.router.name!r}: no reachable "
                          f"holder of voice {vid}")
        self.placement.record_options(vid, request.encode())
        for node in applied_nodes:
            self.placement.note_applied(node, vid)
        if self.fleetcache is not None:
            self.fleetcache.update_options(vid, last)
        return last

    def _forward_one(self, name: str, request, resp_cls, context,
                     timeout_s: float = 15.0):
        node = self._routable_node(
            context, getattr(request, "voice_id", None))
        try:
            return self._call_unary(node, name, request, resp_cls,
                                    timeout_s)
        except grpc.RpcError as e:
            context.abort(
                e.code() if callable(getattr(e, "code", None))
                and e.code() is not None else grpc.StatusCode.UNKNOWN,
                f"node {node.node_id}: {e.details() or ''}")

    def GetVoiceInfo(self, request: pb.VoiceIdentifier,
                     context) -> pb.VoiceInfo:
        return self._forward_one("GetVoiceInfo", request, pb.VoiceInfo,
                                 context)

    def GetSynthesisOptions(self, request: pb.VoiceIdentifier,
                            context) -> pb.SynthesisOptions:
        return self._forward_one("GetSynthesisOptions", request,
                                 pb.SynthesisOptions, context)

    def ListVoices(self, request: pb.Empty, context) -> pb.VoiceList:
        return self._forward_one("ListVoices", request, pb.VoiceList,
                                 context)

    # -- streaming RPCs -------------------------------------------------------
    def SynthesizeUtterance(self, request: pb.Utterance,
                            context) -> Iterator[bytes]:
        return self._routed_stream("SynthesizeUtterance", request,
                                   context)

    def SynthesizeUtteranceRealtime(self, request: pb.Utterance,
                                    context) -> Iterator[bytes]:
        return self._routed_stream("SynthesizeUtteranceRealtime",
                                   request, context)

    def _fetch_node_record(self, request_id: str, node_id: str):
        """Fetch the serving node's own ledger record over its metrics
        plane (the fleet scope's scrape transport).  None on any miss —
        the router's hop record then stands alone.  Called at QUERY
        time only (one /debug/requests?id= lookup), never on the
        request path."""
        import json
        from urllib.parse import quote

        for node in self.router.nodes:
            if node.node_id != node_id:
                continue
            base = node.spec.metrics_base
            if base is None:
                return None
            status, body = _http_fetch(
                f"{base}/debug/requests?id={quote(request_id)}",
                timeout_s=2.0)
            if status != 200:
                return None
            try:
                records = json.loads(body).get("records") or []
            except (ValueError, AttributeError):
                return None
            return records[0] if records else None
        return None

    def _abort(self, context, rpc: str, code, detail: str,
               refusal: Optional[str] = None,
               error: Optional[str] = None) -> None:
        """Metrics + a typed ledger record + the ``x-request-id``
        trailer (refused requests are debuggable too), then abort
        (raises)."""
        self.runtime.failures.labels(rpc=rpc, code=code.name).inc()
        _add_trailers(context,
                      ("x-request-id", _context_request_id(context)))
        lg = self.runtime.ledger
        if lg is not None:
            rec = _ledger_record(self.runtime, context, f"mesh.{rpc}")
            ident = getattr(context, "_sonata_tenant", None)
            if ident is not None:
                rec.note(tenant=ident.name)
            if refusal is not None:
                lg.emit(rec, refusal=refusal)
            else:
                lg.emit(rec, outcome="error", error=error or code.name)
        context.abort(code, detail)

    def _routed_stream(self, name: str, request: pb.Utterance,
                       context) -> Iterator[bytes]:
        """Route one synthesis stream across the fleet, yielding the
        backend's chunks as raw bytes.  The admission slot, request
        trace, and deadline are the router's own; the per-node retry
        contract (reroute before first chunk, typed after) lives in
        :meth:`MeshRouter.route_stream`."""
        from contextlib import ExitStack

        rt = self.runtime
        rid = _context_request_id(context)
        rec = _ledger_record(self.runtime, context, f"mesh.{name}",
                             voice=request.voice_id or None)
        if rec is not None:
            rec.note(text_len=len(request.text or ""))
        t0 = time.monotonic()
        ttfb = None
        try:
            with rt.tracer.trace_request(
                    f"mesh.{name}", request_id=rid,
                    voice=request.voice_id or "") as trace:
                with ExitStack() as stack:
                    with tracing.span("admission"):
                        rt.drain.raise_if_draining()
                        stack.enter_context(rt.admission.admit())
                    rt.requests.labels(rpc=name).inc()
                    _add_trailers(context, ("x-request-id", rid))
                    deadline = rt.deadline_for(context)
                    payload = request.encode()
                    md = (("x-request-id", rid),)
                    # sonata-tenancy: classify here, charge
                    # AFTER the single-flight follow decision (a
                    # follower rides a cache fill — parity with the
                    # node's probe-before-charge order).  The forwarded
                    # metadata names the tenant and marks quota as
                    # router-enforced so the backend skips its bucket.
                    tn = rt.tenancy
                    identity = None
                    if tn is not None:
                        identity = tn.classify_context(context)
                        try:
                            # the ledger's refusal records read it back
                            context._sonata_tenant = identity
                        except Exception:
                            pass
                        md = md + (
                            (tenancy_mod.ROUTER_TENANT_HEADER,
                             identity.name),
                            (tenancy_mod.ROUTER_ENFORCED_HEADER,
                             tenancy_mod.ROUTER_ENFORCED_VALUE))
                    served = [None]

                    def start(node, timeout_s):
                        served[0] = node
                        # raw-bytes forward via a cached stub: no codec
                        # and no per-request stub build on the hot path
                        fn = self._stream_stub(node, name)
                        return fn(payload, timeout=timeout_s,
                                  metadata=md)

                    # fleet cache tier: derive the
                    # canonical key at the router.  ckey is None when
                    # the tier is off, the voice is unknown/uncacheable,
                    # or derivation failed — every None keeps the
                    # routing and stream path byte-for-byte.
                    fc = self.router.fleetcache
                    ckey = None
                    if fc is not None:
                        kind = ("realtime"
                                if name == "SynthesizeUtteranceRealtime"
                                else "utterance")
                        ckey = fc.routing_key(kind, request)
                    outcome, flight = "bypass", None
                    if fc is not None and ckey is not None:
                        # remember the encoded request so hot-set
                        # replication can replay it to a peer later
                        fc.note_payload(ckey, name, payload)
                        outcome, flight = fc.begin_stream(ckey)
                    if outcome == "follow":
                        # router single-flight follower: ride the
                        # leader's fill instead of re-synthesizing
                        n = 0
                        follow_bytes = 0
                        try:
                            with tracing.span("fleetcache-follow") as fsp:
                                first = True
                                for chunk, _aux in flight:
                                    n += 1
                                    follow_bytes += len(chunk)
                                    if first:
                                        first = False
                                        ttfb = time.monotonic() - t0
                                        rt.ttfb.observe(ttfb)
                                        fsp.annotate(
                                            ttfb_ms=round(ttfb * 1e3, 3))
                                    yield chunk
                                fsp.annotate(chunks=n)
                            rt.synth_latency.observe(
                                time.monotonic() - t0)
                            if rec is not None:
                                rec.note(
                                    tenant=(identity.name
                                            if identity is not None
                                            else None),
                                    cache="follow", chunks=n,
                                    bytes_out=follow_bytes, ttfb_s=ttfb)
                                rt.ledger.emit(rec)
                            return
                        except synthcache.LeaderFailed:
                            if n > 0:
                                # audio already streamed: the client
                                # stream is poisoned, fail typed (the
                                # never-resend-after-first-chunk rule)
                                raise
                            # leader died before our first chunk: fall
                            # through to an independent routed synth
                        finally:
                            flight.abandon()

                    if tn is not None:
                        # this stream synthesizes (bypass, fill, or a
                        # follower whose leader died pre-first-chunk):
                        # burn the tenant's router-side token now, and
                        # refuse typed with a machine-readable
                        # retry-after trailer when the bucket is dry
                        ok, retry_after = tn.charge(
                            identity._replace(router_enforced=False))
                        if not ok:
                            _add_trailers(
                                context,
                                (tenancy_mod.RETRY_AFTER_TRAILER,
                                 f"{retry_after:.3f}"))
                            self._abort(
                                context, name,
                                grpc.StatusCode.RESOURCE_EXHAUSTED,
                                f"tenant {identity.name!r} over quota; "
                                f"retry in {retry_after:.3f}s",
                                refusal="router-quota")
                        tn.note_admitted(identity.name)

                    fill = flight if outcome == "fill" else None
                    committed = False
                    try:
                        first = True
                        with tracing.span("stream-emit") as emit_sp:
                            n_chunks = 0
                            bytes_out = 0
                            for chunk in self.router.route_stream(
                                    start, deadline=deadline,
                                    request_id=rid,
                                    classify=_classify_rpc_error,
                                    voice=request.voice_id or None,
                                    affinity_key=ckey):
                                n_chunks += 1
                                bytes_out += len(chunk)
                                if first:
                                    first = False
                                    ttfb = time.monotonic() - t0
                                    rt.ttfb.observe(ttfb)
                                    emit_sp.annotate(
                                        ttfb_ms=round(ttfb * 1e3, 3))
                                if fill is not None:
                                    fill.add_chunk(chunk)
                                yield chunk
                            emit_sp.annotate(chunks=n_chunks)
                        if fill is not None:
                            fill.commit_fill()
                            committed = True
                        rt.synth_latency.observe(time.monotonic() - t0)
                    finally:
                        if fill is not None and not committed:
                            # error, deadline, or client hangup
                            # (GeneratorExit): wake followers so they
                            # fall back instead of waiting out the clock
                            fill.abort_fill()
                    if served[0] is not None:
                        # forward the serving node's identity to OUR
                        # client, like the backend does for us — a
                        # client of the router learns which process in
                        # the fleet actually synthesized its audio
                        _add_trailers(context, ("x-sonata-node-id",
                                                served[0].node_id))
                    if rec is not None:
                        # the hop's wide event: router-side cost plus
                        # which node synthesized and how many reroutes
                        # it took to get there — /debug/requests?id= on
                        # the router merges the node's own record in
                        cost = ledger_mod.cost_fields_from_trace(trace)
                        reroutes = cost.pop("reroutes", 0)
                        rec.note(
                            tenant=(identity.name
                                    if identity is not None else None),
                            chunks=n_chunks, bytes_out=bytes_out,
                            ttfb_s=ttfb,
                            router={"reroutes": reroutes,
                                    "node": (served[0].node_id
                                             if served[0] is not None
                                             else None)},
                            **cost)
                        rt.ledger.emit(rec)
        except VoiceWarming as e:
            # typed like a draining refusal (UNAVAILABLE, retryable):
            # the voice is desired but no holder has converged inside
            # the bounded placement wait — a reconcile is in flight
            self._abort(context, name, grpc.StatusCode.UNAVAILABLE,
                        str(e), refusal="voice-warming")
        except Overloaded as e:
            rt.shed.labels(source="mesh").inc()
            self._abort(context, name, _status_for(e), str(e),
                        refusal="overload")
        except DeadlineExceeded as e:
            rt.expired.inc()
            self._abort(context, name, _status_for(e), str(e),
                        refusal="deadline")
        except Draining as e:
            self._abort(context, name, _status_for(e), str(e),
                        refusal="draining")
        except grpc.RpcError as e:
            # backend failure after the retry budget (or after bytes
            # streamed): forward the backend's own status typed
            code = getattr(e, "code", None)
            code = code() if callable(code) else None
            det = getattr(e, "details", None)
            det = (det() if callable(det) else "") or ""
            self._abort(context, name,
                        code or grpc.StatusCode.UNKNOWN,
                        f"backend: {det}",
                        error=(code.name if code is not None
                               else "RpcError"))
        except SonataError as e:
            self._abort(context, name, _status_for(e), str(e),
                        error=type(e).__name__)
        except GeneratorExit:
            # client hangup mid-stream: "cancelled", not a server error
            if rec is not None:
                rt.ledger.emit(rec, outcome="cancelled")
            raise
        except BaseException as e:
            if rec is not None and not rec.emitted:
                rt.ledger.emit(rec, outcome="error",
                               error=type(e).__name__)
            raise

    # -- lifecycle ------------------------------------------------------------
    def drain(self, timeout_s: Optional[float] = None,
              reason: str = "shutdown") -> bool:
        """Graceful router drain, same pinned phase order as a node
        (``DRAIN_PHASES``): readiness off first, new streams refused
        typed, in-flight streams finish inside the budget, then the
        "voices" phase closes mesh membership probing and "runtime"
        tears the metrics plane down.  First caller wins."""
        rt = self.runtime
        if not rt.begin_drain(reason):
            return False
        d = rt.drain
        d.note_phase("readiness-off")
        d.note_phase("reject-admissions", in_flight=rt.admission.in_flight)
        t0 = time.monotonic()
        idle_ok = d.wait_idle(lambda: rt.admission.in_flight == 0,
                              timeout_s)
        d.note_phase("wait-in-flight", ok=idle_ok,
                     waited_ms=round((time.monotonic() - t0) * 1e3, 1),
                     stragglers=rt.admission.in_flight)
        self.router.close()
        if self.fleetcache is not None:
            self.fleetcache.close()  # wakes single-flight followers
        self.fleet.close()
        self.placement.close()
        self.unregister_node_series()
        d.note_phase("voices", closed=len(self.router.nodes))
        rt.close()
        d.note_phase("runtime")
        d.note_phase("done", stragglers=rt.admission.in_flight)
        return True

    def shutdown(self) -> None:
        """Immediate teardown (the abrupt sibling of :meth:`drain`):
        raced requests still refuse typed via the shared drain flag."""
        self.runtime.drain.begin("shutdown")
        self.runtime.health.set_not_ready("shutting down")
        self.router.close()
        if self.fleetcache is not None:
            self.fleetcache.close()
        self.fleet.close()
        self.placement.close()
        self.unregister_node_series()
        with self._chan_lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for ch in channels:
            try:
                ch.close()
            except Exception:
                pass
        self.runtime.close()


class _MeshHandler(grpc.GenericRpcHandler):
    """Same method table as the node server; the two streaming
    synthesis RPCs pass response bytes through unserialized."""

    def __init__(self, service: SonataMeshService):
        self._service = service

    def service(self, handler_call_details):
        path = handler_call_details.method
        prefix = f"/{_SERVICE_PATH}/"
        if not path.startswith(prefix):
            return None
        name = path[len(prefix):]
        entry = _METHODS.get(name)
        if entry is None:
            return None
        req_cls, resp_cls, streaming = entry
        method = getattr(self._service, name)
        if streaming:
            return grpc.unary_stream_rpc_method_handler(
                method, request_deserializer=req_cls.decode,
                response_serializer=None)  # raw backend bytes
        return grpc.unary_unary_rpc_method_handler(
            method, request_deserializer=req_cls.decode,
            response_serializer=lambda m: m.encode())


def create_mesh_server(port: Optional[int] = None, *,
                       backends=None,
                       host: str = "127.0.0.1",
                       max_workers: int = 32,
                       runtime: Optional[ServingRuntime] = None,
                       router: Optional[MeshRouter] = None,
                       max_in_flight: Optional[int] = None,
                       max_queue_depth: Optional[int] = None,
                       request_timeout_s: Optional[float] = None,
                       metrics_port: Optional[int] = None,
                       name: str = "mesh"
                       ) -> tuple:
    """Build (server, bound_port) for the router.  ``backends`` is a
    spec string, a list of specs, or None (``SONATA_MESH_BACKENDS``)."""
    from concurrent.futures import ThreadPoolExecutor

    port = port if port is not None else int(
        os.environ.get(PORT_ENV, DEFAULT_PORT))
    if router is None:
        if isinstance(backends, (list, tuple)):
            backends = ",".join(backends)
        specs = parse_backends(backends)
        router = MeshRouter(specs, name=name)
    if runtime is None:
        runtime = ServingRuntime(max_in_flight=max_in_flight,
                                 max_queue_depth=max_queue_depth,
                                 request_timeout_s=request_timeout_s)
    service = SonataMeshService(router, runtime=runtime)
    server = grpc.server(ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix="sonata_mesh"))
    server.add_generic_rpc_handlers((_MeshHandler(service),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        router.close()
        raise OperationError(f"cannot bind {host}:{port}")
    server.sonata_service = service
    server.sonata_runtime = runtime
    runtime.set_node_id(resolve_node_id(f"{host}:{bound}"))
    http_port = runtime.start_http(metrics_port)
    if http_port is not None:
        log.info("mesh metrics/health plane on http://127.0.0.1:%d",
                 http_port)
    return server, bound


def main(argv=None) -> int:
    configure_logging(env_level_var="SONATA_GRPC")
    import argparse

    ap = argparse.ArgumentParser(prog="sonata-mesh")
    ap.add_argument("--port", type=int, default=None,
                    help="router gRPC port (default $SONATA_MESH_PORT "
                         f"or {DEFAULT_PORT})")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--backend", action="append", default=[],
                    help="backend node spec host:grpc_port[/metrics_port]"
                         " (repeatable; default $SONATA_MESH_BACKENDS)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="router /metrics /healthz /readyz HTTP port "
                         "(0 = ephemeral; default $SONATA_METRICS_PORT "
                         "or disabled)")
    ap.add_argument("--request-timeout-s", type=float, default=None,
                    help="router-side default deadline when the client "
                         "set none (default $SONATA_REQUEST_TIMEOUT_S "
                         "or 120; <=0 disables)")
    ap.add_argument("--max-in-flight", type=int, default=None)
    ap.add_argument("--max-queue-depth", type=int, default=None)
    ap.add_argument("--log-level", default=None,
                    choices=("DEBUG", "INFO", "WARNING", "ERROR",
                             "CRITICAL"))
    ap.add_argument("--log-format", default=None,
                    choices=("text", "json"))
    args = ap.parse_args(argv)
    if args.log_level or args.log_format:
        configure_logging(args.log_level, args.log_format,
                          env_level_var="SONATA_GRPC")
    faults.warn_if_armed(log)

    server, port = create_mesh_server(
        args.port, host=args.host,
        backends=args.backend or None,
        metrics_port=args.metrics_port,
        max_in_flight=args.max_in_flight,
        max_queue_depth=args.max_queue_depth,
        request_timeout_s=args.request_timeout_s)
    server.start()
    service = server.sonata_service
    log.info("sonata-mesh v%s listening on %s:%d over %d backend "
             "node(s): %s", __version__, args.host, port,
             len(service.router.nodes),
             [n.spec.addr for n in service.router.nodes])
    # rolling restarts: the router drains like a node (readiness off
    # first, in-flight streams finish, typed refusals)
    from .grpc_server import install_signal_handlers

    install_signal_handlers(server)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(grace=2.0)
        service.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
