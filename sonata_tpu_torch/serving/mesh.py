"""sonata-mesh core: federate sonata servers into one serving fleet.

:class:`~sonata_tpu_torch.serving.replicas.ReplicaPool` stops at the local
chips of one process — the r08 bench hit that wall directly (two
replicas contending on 2 vCPUs; the scale-out axis is more *hosts*, not
more threads).  This module is the routing tier above it: N backend
sonata servers (each its own process with its own pool, drain, warmup,
and iteration loop) federated behind one endpoint, where a dead,
draining, wedged, or partitioned node is a **routing event**, not a
user-visible error.  The transport-agnostic core lives here; the gRPC
frontend that drives it is :mod:`sonata_tpu_torch.frontends.mesh_server`.

Pieces, in dependency order:

- **Health-gated membership.**  One prober thread per node (a wedged
  health endpoint must not stall the probes of its peers) scrapes
  ``/readyz`` plus ``/metrics`` every ``SONATA_MESH_PROBE_INTERVAL_S``:
  ``sonata_draining`` evicts a draining node from membership *before*
  its listener stops, ``sonata_replica_outstanding`` (fallback
  ``sonata_in_flight``) feeds the routing tiebreak, and
  ``sonata_node_info`` teaches the router the backend's stable
  ``node_id`` so router-side logs and spans name the process that
  served each request.  A 503 ``/readyz`` (warming, degraded) makes the
  node unroutable but is **not** a fault; an unreachable plane is.
- **Per-node circuit breaker**, the replica state machine at
  node granularity: ``SONATA_MESH_BREAKER_THRESHOLD`` consecutive
  failures trip the node OPEN.  Probe failures and route-class request
  failures keep **separate** consecutive counters (a node answering its
  health endpoint while erroring every request must still trip — a
  shared counter would let each probe success launder the route
  failures accumulated between scrapes); once the
  backed-off ``next_probe_at`` passes, a successful probe of a ready
  node flips it HALF_OPEN and the next routed request is its trial —
  success closes the breaker, failure re-opens with the probe backoff
  doubled (jittered, capped at ``SONATA_MESH_PROBE_MAX_S``).  A
  recovered backend therefore **rejoins membership with no router
  restart**.
- **Least-outstanding routing with an iteration-headroom tiebreak**:
  primary key is the router's own live in-flight count per node; ties
  break toward the node with the most slots left below its current
  graduated batch rung (:data:`~sonata_tpu_torch.utils.buckets.BATCH_BUCKETS`
  over router + scraped occupancy) — a new stream should fill a rung,
  not graduate one (the padding economics, fleet edition).
- **Deadline and admission propagation over the hop**: the remaining
  deadline at each attempt — shrunk by queue wait, failed attempts, and
  backoff sleeps — becomes the per-attempt transport timeout.
- **Bounded retry** (:meth:`MeshRouter.route_stream`): route-class
  failures (connect errors, injected ``mesh.route`` faults, typed
  UNAVAILABLE) retry another node with exponential backoff + jitter;
  a typed ``draining`` refusal reroutes *immediately* (a deploy is not
  a fault: no breaker count, no backoff) and marks the node draining
  at once rather than waiting for the next scrape.  **Never after
  bytes reached the client**: once the first chunk has been yielded,
  any failure is typed through — resending audio is worse than failing.
- **First-chunk hedge** (``SONATA_MESH_HEDGE_MS``, default 0 = off):
  when armed, an attempt that produced no first chunk inside the budget
  is cancelled and rerouted (counts against the same retry budget;
  never duplicates audio because it only ever fires pre-first-chunk).

Failpoint sites: ``mesh.route`` fires inside every per-node dispatch
attempt (an injected error counts toward that node's breaker exactly
like a real one), ``mesh.health`` fires inside every probe cycle, and
``mesh.reconcile`` fires inside every voice-placement reconcile cycle —
so the chaos lane can kill, wedge, or partition a node deterministically
without owning real processes.

The fleet observability plane rides the same per-node
prober: an attached :class:`~sonata_tpu_torch.serving.fleetscope.FleetScope`
gets :meth:`FleetScope.on_probe_cycle` after every health cycle and
pulls the node's ``/debug/scope/export`` on its own slower cadence.
The router only holds the bookkeeping: ``scope_scrape_at`` /
``scope_stale`` per node, with a stale scrape (the fleet scraper's
staleness budget exceeded) making the node **unroutable** — a node
whose observability plane is wedged must not keep looking healthy just
because the last good scrape said so.

The voice-placement plane (
:class:`~sonata_tpu_torch.serving.placement.PlacementPlane`) rides the same
probers: each health cycle scrapes the node's *actual* loaded-voice
set (the ``voices=`` line on ``/readyz``, falling back to the
``sonata_voice_loaded`` gauge) and drives one reconcile cycle per
``SONATA_PLACEMENT_RECONCILE_INTERVAL_S``; the router holds the
per-node actual set, the per-(node, voice) outstanding counts, and the
voice-aware restriction in :meth:`MeshRouter.pick`.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Iterator, List, Optional, Sequence

from ..core import OperationError
from ..utils.buckets import BATCH_BUCKETS
from . import faults, tracing
from .admission import Overloaded
from .deadlines import Deadline
from .drain import Draining
from .metrics import parse_prometheus_text
from .placement import VoiceWarming
from .replicas import CLOSED, HALF_OPEN, OPEN, _STATE_NAMES, _env_float, _env_int

log = logging.getLogger("sonata.serving")

MESH_BACKENDS_ENV = "SONATA_MESH_BACKENDS"
NODE_ID_ENV = "SONATA_NODE_ID"
MESH_PROBE_INTERVAL_ENV = "SONATA_MESH_PROBE_INTERVAL_S"
MESH_PROBE_TIMEOUT_ENV = "SONATA_MESH_PROBE_TIMEOUT_S"
MESH_BREAKER_THRESHOLD_ENV = "SONATA_MESH_BREAKER_THRESHOLD"
MESH_PROBE_MAX_ENV = "SONATA_MESH_PROBE_MAX_S"
MESH_RETRIES_ENV = "SONATA_MESH_RETRIES"
MESH_RETRY_BACKOFF_ENV = "SONATA_MESH_RETRY_BACKOFF_MS"
MESH_HEDGE_ENV = "SONATA_MESH_HEDGE_MS"

DEFAULT_PROBE_INTERVAL_S = 0.5
DEFAULT_PROBE_TIMEOUT_S = 2.0
DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_PROBE_MAX_S = 30.0
DEFAULT_RETRIES = 2
DEFAULT_RETRY_BACKOFF_MS = 50.0
#: reroute backoff is capped well below any request deadline: the retry
#: exists to dodge a sick node, not to wait one back to health
MAX_RETRY_BACKOFF_S = 2.0
#: fractional jitter on retry backoff and probe rescheduling, so a fleet
#: of routers tripped by one node death does not re-probe in lockstep
MESH_JITTER = 0.1

#: sentinel for "the backend stream ended before a first chunk" (an
#: empty stream is a legitimate completion, not a failure)
_DONE = object()


class _HedgeCancelled(Exception):
    """The first-chunk hedge cancelled an attempt racing its own first
    chunk — rerouted like any hedge fire (nothing reached the client)."""


#: the metric families the membership prober actually reads (scrape
#: lines are pre-filtered to these before parsing)
_SCRAPE_FAMILIES = ("sonata_draining", "sonata_replica_outstanding",
                    "sonata_in_flight", "sonata_node_info",
                    "sonata_voice_loaded")


def resolve_node_id(default: str) -> str:
    """Stable node identity: ``SONATA_NODE_ID`` wins, else the bind
    ``host:port``.  This is the name router-side logs, spans, and
    clients (via gRPC trailing metadata) know the backend by."""
    raw = os.environ.get(NODE_ID_ENV, "").strip()
    return raw or default


class NodeSpec:
    """One backend's addresses: ``host:grpc_port[/metrics_port]``.

    The metrics port is where the node's ``/readyz`` + ``/metrics``
    plane lives; without one, membership is driven by route outcomes
    only: a tripped breaker still recovers (probe cycles count as
    optimistic successes, so OPEN walks to HALF_OPEN and a trial
    request closes it), but there is no scrape-driven drain eviction,
    no occupancy tiebreak, and a node evicted by a typed draining
    refusal stays evicted until a router restart.
    """

    __slots__ = ("host", "grpc_port", "metrics_port")

    def __init__(self, host: str, grpc_port: int,
                 metrics_port: Optional[int] = None):
        self.host = host
        self.grpc_port = int(grpc_port)
        self.metrics_port = int(metrics_port) if metrics_port else None

    @classmethod
    def parse(cls, spec: str) -> "NodeSpec":
        text = spec.strip()
        metrics: Optional[str] = None
        if "/" in text:
            text, _, metrics = text.partition("/")
        host, sep, port = text.rpartition(":")
        if not sep or not host:
            raise OperationError(
                f"bad mesh backend spec {spec!r} "
                "(host:grpc_port[/metrics_port])")
        try:
            return cls(host, int(port), int(metrics) if metrics else None)
        except ValueError:
            raise OperationError(
                f"bad mesh backend spec {spec!r}: ports must be "
                "integers (host:grpc_port[/metrics_port])") from None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.grpc_port}"

    @property
    def metrics_base(self) -> Optional[str]:
        if self.metrics_port is None:
            return None
        return f"http://{self.host}:{self.metrics_port}"

    def __repr__(self) -> str:
        return (f"NodeSpec({self.addr}"
                + (f"/{self.metrics_port}" if self.metrics_port else "")
                + ")")


def parse_backends(raw: Optional[str] = None) -> List[NodeSpec]:
    """Comma-separated backend specs; defaults to
    ``SONATA_MESH_BACKENDS``.  Duplicate addresses are rejected — two
    membership entries for one process would double-count its load."""
    if raw is None:
        raw = os.environ.get(MESH_BACKENDS_ENV, "")
    specs = [NodeSpec.parse(s) for s in raw.split(",") if s.strip()]
    seen: set = set()
    for s in specs:
        if s.addr in seen:
            raise OperationError(
                f"duplicate mesh backend {s.addr!r} in {raw!r}")
        seen.add(s.addr)
    return specs


class MeshNode:
    """One backend process's membership entry: identity + breaker +
    live/scraped load.  All mutation happens under the router's lock."""

    def __init__(self, index: int, spec: NodeSpec):
        self.index = index
        self.spec = spec
        #: stable identity; the spec address until a scrape of
        #: ``sonata_node_info`` teaches us the backend's own id
        self.node_id = spec.addr
        self.state = CLOSED
        #: optimistic until the first probe — a router with no metrics
        #: plane configured still routes, learning only from outcomes
        self.ready = True
        self.draining = False
        #: consecutive ROUTE-class request failures (reset by a route
        #: success); probes keep their own counter — see the module
        #: docstring on why they never launder each other
        self.consecutive_failures = 0
        self.consecutive_probe_failures = 0
        #: consecutive placement-reconcile failures — a THIRD separate
        #: counter, for the same reason probes and routes have their
        #: own: probes run every 0.5 s and reconciles every 2 s, so a
        #: shared counter would let each probe success launder the
        #: reconcile failures accumulated between cycles and a node
        #: whose control plane can never be reconciled would never trip
        self.consecutive_reconcile_failures = 0
        self.outstanding = 0            # router-side in-flight
        self.reported_outstanding = 0.0  # scraped backend occupancy
        self.routed = 0
        self.route_failures = 0
        self.probe_failures = 0
        self.last_probe_at: Optional[float] = None
        self.opened_at: Optional[float] = None
        self.next_probe_at: Optional[float] = None
        self.probe_backoff_s: Optional[float] = None
        #: fleet observability bookkeeping: monotonic stamp
        #: of the last good ``/debug/scope/export`` scrape, and the
        #: staleness verdict the attached FleetScope maintains — stale
        #: means unroutable (see the module docstring)
        self.scope_scrape_at: Optional[float] = None
        self.scope_stale = False
        #: voice placement: the node's ACTUAL loaded-voice
        #: set, scraped from the ``voices=`` line on ``/readyz`` (or
        #: the ``sonata_voice_loaded`` gauge); None until a scrape has
        #: reported one — an unknown actual set keeps semantics
        #: (no reconcile ops, permissive voice-aware routing)
        self.loaded_voices: Optional[frozenset] = None
        #: router-side in-flight per voice on this node (what the RAM
        #: budget's never-evict-a-live-voice guard reads)
        self.voice_outstanding: dict = {}

    def snapshot(self) -> dict:
        return {"node_id": self.node_id, "addr": self.spec.addr,
                "index": self.index,
                "state": _STATE_NAMES[self.state],
                "ready": self.ready, "draining": self.draining,
                "outstanding": self.outstanding,
                "reported_outstanding": self.reported_outstanding,
                "routed": self.routed,
                "route_failures": self.route_failures,
                "probe_failures": self.probe_failures,
                "consecutive_failures": self.consecutive_failures,
                "consecutive_probe_failures":
                    self.consecutive_probe_failures,
                "consecutive_reconcile_failures":
                    self.consecutive_reconcile_failures,
                "probe_backoff_s": self.probe_backoff_s,
                "scope_stale": self.scope_stale,
                "voices": (None if self.loaded_voices is None
                           else sorted(self.loaded_voices)),
                "scope_scrape_age_s": (
                    None if self.scope_scrape_at is None
                    else round(time.monotonic() - self.scope_scrape_at,
                               3))}


def default_classify(exc: BaseException) -> str:
    """Failure class for transports raising typed errors: ``draining``
    (reroute immediately, no breaker count), ``route`` (reroute with
    backoff, counts toward the node breaker), or ``fatal`` (typed
    through).  gRPC frontends supply their own status-code-aware
    classifier."""
    if isinstance(exc, Draining):
        return "draining"
    if isinstance(exc, faults.InjectedFault):
        return "route"
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return "route"
    return "fatal"


def _http_fetch(url: str, timeout_s: float) -> tuple:
    """(status code, body text); HTTP error codes are answers, not
    exceptions — only an unreachable plane raises."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.getcode(), resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace")


class MeshRouter:
    """Membership + breaker + routing over :class:`MeshNode` entries.

    Transport-agnostic: :meth:`route_stream` drives a caller-supplied
    ``start(node, timeout_s)`` callable, so the gRPC frontend and the
    fake-backend unit tests share every line of the retry/breaker/
    membership logic.
    """

    def __init__(self, specs: Sequence[NodeSpec], *,
                 probe_interval_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 probe_max_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 retry_backoff_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 name: str = "mesh",
                 fetch: Optional[Callable[[str, float], tuple]] = None,
                 start_probers: bool = True):
        if not specs:
            raise OperationError(
                "a mesh needs at least one backend "
                f"(set {MESH_BACKENDS_ENV} or pass --backend)")
        self.name = name
        self.probe_interval_s = max(0.05, (
            probe_interval_s if probe_interval_s is not None
            else _env_float(MESH_PROBE_INTERVAL_ENV, DEFAULT_PROBE_INTERVAL_S)))
        self.probe_timeout_s = max(0.05, (
            probe_timeout_s if probe_timeout_s is not None
            else _env_float(MESH_PROBE_TIMEOUT_ENV, DEFAULT_PROBE_TIMEOUT_S)))
        self.breaker_threshold = max(1, (
            breaker_threshold if breaker_threshold is not None
            else _env_int(MESH_BREAKER_THRESHOLD_ENV,
                          DEFAULT_BREAKER_THRESHOLD)))
        # never below the probe interval (same contract as the pool cap)
        self.probe_max_s = max(self.probe_interval_s, (
            probe_max_s if probe_max_s is not None
            else _env_float(MESH_PROBE_MAX_ENV, DEFAULT_PROBE_MAX_S)))
        self.retries = max(0, (
            retries if retries is not None
            else _env_int(MESH_RETRIES_ENV, DEFAULT_RETRIES)))
        self.retry_backoff_ms = max(0.0, (
            retry_backoff_ms if retry_backoff_ms is not None
            else _env_float(MESH_RETRY_BACKOFF_ENV, DEFAULT_RETRY_BACKOFF_MS)))
        self.hedge_ms = max(0.0, (
            hedge_ms if hedge_ms is not None
            else _env_float(MESH_HEDGE_ENV, 0.0)))
        self._fetch = fetch if fetch is not None else _http_fetch
        self._lock = threading.RLock()
        self._closed = False
        self.nodes = [MeshNode(i, s) for i, s in enumerate(specs)]
        self.stats = {"routed": 0, "rerouted": 0, "rerouted_draining": 0,
                      "hedged": 0, "failed": 0, "breaker_opens": 0,
                      "recovered": 0, "probe_failures": 0}
        self._wake = threading.Event()
        #: attached fleet observability plane — probed on
        #: every cycle, scrapes on its own cadence; None costs one read
        self._fleet = None
        #: attached voice-placement plane — reconciles on
        #: the prober threads, restricts voice-aware routing
        self._placement = None
        #: attached fleet cache tier — biases routing of
        #: cacheable requests toward their rendezvous owner, replicates
        #: hot entries on the prober threads; None costs one read
        self._fleetcache = None
        #: attached tenant-config propagator — pushes the
        #: router's tenant table to nodes on the prober threads
        self._tenancy_propagator = None
        self._probers: list = []
        if start_probers:
            for node in self.nodes:
                t = threading.Thread(
                    target=self._probe_loop, args=(node,),
                    name=f"sonata_mesh_probe_{node.index}", daemon=True)
                t.start()
                self._probers.append(t)

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        """Stop membership probing (terminal).  In-flight routed streams
        are untouched — they finish or fail through their transport."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        for t in self._probers:
            t.join(timeout=self.probe_timeout_s + 5.0)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- fleet observability attachment ----------------------------
    def attach_fleet(self, fleet) -> None:
        """Attach the fleet aggregation plane: each node's prober calls
        ``fleet.on_probe_cycle(node)`` after every health cycle (the
        scope-export scrape rides the prober thread on the fleet's own
        slower cadence, so a wedged node export can never stall a
        peer's probes either)."""
        self._fleet = fleet

    # -- voice placement attachment --------------------------------
    def attach_placement(self, plane) -> None:
        """Attach the voice-placement plane: each node's prober calls
        ``plane.on_probe_cycle(node)`` after every health cycle (the
        reconcile runs on the prober thread at the plane's own slower
        cadence, so a wedged reconcile can only ever stall its own
        node's prober), and ``pick(voice=...)`` restricts routing to
        the plane's converged holders."""
        self._placement = plane

    @property
    def placement(self):
        return self._placement

    # -- fleet cache attachment ------------------------------------
    def attach_fleetcache(self, fleetcache) -> None:
        """Attach the fleet cache tier: ``pick(affinity_key=...)``
        consults it for the rendezvous owner of a cacheable request,
        and each node's prober calls
        ``fleetcache.on_probe_cycle(node)`` after every health cycle
        (hot-set replication rides the prober threads at the tier's own
        slower cadence, like the placement reconciler)."""
        self._fleetcache = fleetcache

    @property
    def fleetcache(self):
        return self._fleetcache

    # -- tenant-config propagation attachment -----------------------
    def attach_tenancy(self, propagator) -> None:
        """Attach the tenant-config propagator: each node's prober
        calls ``propagator.on_probe_cycle(node)`` after every health
        cycle (the desired-state push rides the prober threads at the
        propagator's own slower cadence, like the placement
        reconciler), so every node converges to the router's tenant
        table without a control-plane dependency."""
        self._tenancy_propagator = propagator

    @property
    def tenancy_propagator(self):
        return self._tenancy_propagator

    def routable_nodes(self) -> list:
        """Snapshot of the nodes currently accepting traffic (the
        replication pass targets peers from this list)."""
        with self._lock:
            return [n for n in self.nodes if self._routable_locked(n)]

    def voice_load_view(self, node: MeshNode) -> tuple:
        """(actual loaded-voice set or None, per-voice router-side
        in-flight) for the placement reconciler — one consistent read
        under the router lock."""
        with self._lock:
            return node.loaded_voices, dict(node.voice_outstanding)

    def note_voice_loaded(self, node: MeshNode, voice_id: str) -> None:
        """A voice op just landed on ``node`` (RPC fan-out or a
        reconcile replay): fold it into the actual set optimistically
        so routing converges immediately — the next ``/readyz`` scrape
        remains the source of truth and overwrites the whole set."""
        with self._lock:
            if node.loaded_voices is None:
                node.loaded_voices = frozenset((voice_id,))
            else:
                node.loaded_voices = node.loaded_voices | {voice_id}

    def note_voice_unloaded(self, node: MeshNode,
                            voice_id: str) -> None:
        with self._lock:
            if node.loaded_voices:
                node.loaded_voices = node.loaded_voices - {voice_id}

    def note_reconcile_failure(self, node: MeshNode,
                               reason: str) -> None:
        """A failed reconcile cycle (injected ``mesh.reconcile`` fault,
        hang-cap conviction, failed replay op) counts toward the
        node's breaker on its OWN consecutive counter — probes succeed
        4x as often as reconciles run, so sharing the probe counter
        would let each probe success launder the reconcile failures
        accumulated between cycles (the probe-vs-route lesson,
        third edition).  A node whose control plane cannot be
        reconciled is therefore eventually evicted from membership."""
        with self._lock:
            node.consecutive_reconcile_failures += 1
            self._maybe_trip_locked(
                node, node.consecutive_reconcile_failures,
                f"reconcile failed ({reason})")

    def note_reconcile_success(self, node: MeshNode) -> None:
        """A clean reconcile cycle resets only the RECONCILE counter
        (never the probe or route ones)."""
        with self._lock:
            node.consecutive_reconcile_failures = 0

    def begin_voice_retire(self, node: MeshNode,
                           voice_id: str) -> bool:
        """Atomically stop routing ``voice_id`` to ``node`` ahead of an
        unload/eviction op.  Under the router lock: refuse (False) if
        the voice has in-flight streams there; otherwise remove it from
        the node's actual set — ``pick`` can then never route a new
        stream for the voice to this node, so the unload RPC that
        follows cannot kill a stream the router admitted (the
        never-evict-a-live-voice invariant, closed against the
        diff-to-apply race).  A failed unload RPC self-heals: the next
        ``/readyz`` scrape restores the actual set and the reconciler
        retries."""
        with self._lock:
            if node.voice_outstanding.get(voice_id, 0) > 0:
                return False
            if node.loaded_voices:
                node.loaded_voices = node.loaded_voices - {voice_id}
            return True

    def record_scope_scrape(self, node: MeshNode) -> None:
        """One successful scope-export scrape of ``node`` (stamps the
        staleness clock the fleet scraper reads back)."""
        with self._lock:
            node.scope_scrape_at = time.monotonic()

    def scope_scrape_age_s(self, node: MeshNode) -> Optional[float]:
        """Seconds since the node's scope export last scraped OK, or
        None before the first success (the
        ``sonata_mesh_node_scrape_age_seconds`` callback)."""
        with self._lock:
            at = node.scope_scrape_at
        return None if at is None else time.monotonic() - at

    def set_scope_stale(self, node: MeshNode, stale: bool) -> None:
        """Flip the staleness verdict (the FleetScope's eviction lever):
        a stale node is unroutable until a scrape lands again."""
        with self._lock:
            was, node.scope_stale = node.scope_stale, stale
        if stale and not was:
            log.warning(
                "mesh %s: node %s scope-export scrape is stale; evicted "
                "to unroutable until its observability plane answers "
                "again", self.name, node.node_id)
        elif was and not stale:
            log.info("mesh %s: node %s scope-export scrape recovered; "
                     "routable again", self.name, node.node_id)

    # -- membership / health --------------------------------------------------
    def _routable_locked(self, node: MeshNode) -> bool:
        return (node.state != OPEN and node.ready and not node.draining
                and not node.scope_stale)

    def routable_count(self) -> int:
        """Nodes currently accepting traffic (closed or probing breaker,
        ready, not draining) — the router's readiness gate."""
        with self._lock:
            return sum(1 for n in self.nodes if self._routable_locked(n))

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "closed": self._closed,
                    "routable": sum(1 for n in self.nodes
                                    if self._routable_locked(n)),
                    "stats": dict(self.stats),
                    "nodes": [n.snapshot() for n in self.nodes]}

    def probe_once(self, node: MeshNode) -> bool:
        """One health cycle: ``/readyz`` gate, then ``/metrics``
        enrichment (drain flag, occupancy, node id).  Returns whether
        the node's plane answered.  Without a metrics port the cycle is
        a no-op success — membership is then route-outcome-driven."""
        try:
            faults.fire("mesh.health")
            if node.spec.metrics_base is None:
                # no health plane: the cycle is an optimistic success so
                # a breaker tripped by route failures still walks
                # OPEN → HALF_OPEN → trial — without this, a metrics-less
                # node's first trip would be permanent eviction.  The
                # draining flag is preserved as-is (nothing can refute it).
                self._probe_result(node, ok=True, ready=True,
                                   draining=node.draining)
                return True
            code, rbody = self._fetch(node.spec.metrics_base + "/readyz",
                                      self.probe_timeout_s)
        except Exception as e:
            self._probe_result(node, ok=False,
                               error=f"{type(e).__name__}: {e}")
            return False
        ready = code == 200
        draining = False
        reported: Optional[float] = None
        node_id: Optional[str] = None
        #: the node's ACTUAL loaded-voice set — the `voices=` line on
        #: /readyz is authoritative (present-but-empty means "no
        #: voices", explicitly); absent falls back to the
        #: sonata_voice_loaded gauge below, and neither leaves the
        #: actual set unknown (old backends keep semantics)
        voices: Optional[frozenset] = None
        for line in rbody.splitlines():
            if line.startswith("voices="):
                raw = line[len("voices="):].strip()
                voices = frozenset(v for v in raw.split(",") if v)
        try:
            mcode, mbody = self._fetch(
                node.spec.metrics_base + "/metrics", self.probe_timeout_s)
            if mcode == 200:
                # pre-filter to the four families the prober consumes:
                # regex-parsing a node's whole exposition every probe
                # interval burns router-process GIL time that lands on
                # TTFB-critical chunk relays (measured by bench_mesh)
                wanted = [line for line in mbody.splitlines()
                          if line.startswith(_SCRAPE_FAMILIES)]
                series = parse_prometheus_text("\n".join(wanted))
                draining = any(v > 0 for _l, v in
                               series.get("sonata_draining", []))
                outs = [v for _l, v in
                        series.get("sonata_replica_outstanding", [])]
                if not outs:
                    outs = [v for _l, v in
                            series.get("sonata_in_flight", [])]
                if outs:
                    reported = float(sum(outs))
                for lbl, _v in series.get("sonata_node_info", []):
                    if lbl.get("node_id"):
                        node_id = lbl["node_id"]
                if voices is None:
                    loaded = series.get("sonata_voice_loaded", [])
                    if loaded:
                        voices = frozenset(
                            lbl["voice"] for lbl, v in loaded
                            if v > 0 and lbl.get("voice"))
        except Exception:
            # /readyz answered, so the node is alive; the /metrics
            # enrichment is best-effort and must not convict it
            pass
        self._probe_result(node, ok=True, ready=ready, draining=draining,
                           reported=reported, node_id=node_id,
                           voices=voices)
        return True

    def _probe_result(self, node: MeshNode, *, ok: bool,
                      ready: bool = False, draining: bool = False,
                      reported: Optional[float] = None,
                      node_id: Optional[str] = None,
                      voices: Optional[frozenset] = None,
                      error: Optional[str] = None) -> None:
        with self._lock:
            node.last_probe_at = time.monotonic()
            if not ok:
                node.probe_failures += 1
                self.stats["probe_failures"] += 1
                node.consecutive_probe_failures += 1
                self._maybe_trip_locked(
                    node, node.consecutive_probe_failures,
                    f"health probe failed ({error})")
                return
            if node.draining and not draining and ready:
                log.info("mesh %s: node %s finished draining and is "
                         "ready; rejoining membership", self.name,
                         node.node_id)
            elif draining and not node.draining:
                log.info("mesh %s: node %s reports draining; evicted "
                         "from membership until it rejoins", self.name,
                         node.node_id)
            node.ready = ready
            node.draining = draining
            if reported is not None:
                node.reported_outstanding = reported
            if node_id:
                node.node_id = node_id
            if voices is not None:
                # the scraped actual set replaces the optimistic view
                # wholesale — a restarted node's empty set is real news
                node.loaded_voices = voices
            # a probe success resets only the PROBE counter: it must
            # not launder route failures accumulated between scrapes
            node.consecutive_probe_failures = 0
            if node.state == OPEN and ready and not draining:
                now = time.monotonic()
                if node.next_probe_at is None or now >= node.next_probe_at:
                    node.state = HALF_OPEN
                    log.info("mesh %s: node %s answered its health probe; "
                             "half-open — next routed request is its "
                             "trial", self.name, node.node_id)

    def _maybe_trip_locked(self, node: MeshNode, consecutive: int,
                           reason: str) -> None:
        """Shared trip arithmetic (lock held); ``consecutive`` is the
        caller's own failure-class counter, already incremented."""
        failed_trial = node.state == HALF_OPEN
        if failed_trial or (node.state == CLOSED
                            and consecutive >= self.breaker_threshold):
            self._trip_locked(node, failed_trial=failed_trial,
                              reason=reason)
        elif node.state == OPEN:
            # already out: back the next half-open check off further
            node.probe_backoff_s = min(
                (node.probe_backoff_s or self.probe_interval_s) * 2,
                self.probe_max_s)
            node.next_probe_at = (time.monotonic()
                                  + self._jittered(node.probe_backoff_s))

    def _trip_locked(self, node: MeshNode, *, failed_trial: bool,
                     reason: str) -> None:
        node.state = OPEN
        node.opened_at = time.monotonic()
        if failed_trial and node.probe_backoff_s is not None:
            node.probe_backoff_s = min(node.probe_backoff_s * 2,
                                       self.probe_max_s)
        else:
            node.probe_backoff_s = self.probe_interval_s
        node.next_probe_at = (node.opened_at
                              + self._jittered(node.probe_backoff_s))
        self.stats["breaker_opens"] += 1
        log.error("mesh %s: node %s circuit-broken (%s; next half-open "
                  "check in %.1fs)", self.name, node.node_id, reason,
                  node.probe_backoff_s)

    @staticmethod
    def _jittered(seconds: float) -> float:
        return seconds * (1.0 + MESH_JITTER * random.random())

    def _probe_loop(self, node: MeshNode) -> None:
        while not self._closed:
            try:
                self.probe_once(node)
            except Exception:
                log.exception("mesh %s: probe loop error (node %s)",
                              self.name, node.node_id)
            fleet = self._fleet
            if fleet is not None:
                try:
                    fleet.on_probe_cycle(node)
                except Exception:
                    # the aggregation plane must never stall membership
                    log.exception("mesh %s: fleet scrape error (node %s)",
                                  self.name, node.node_id)
            placement = self._placement
            if placement is not None:
                try:
                    # run_cycle already charges failures to the node's
                    # breaker; this guard only catches plane bugs
                    placement.on_probe_cycle(node)
                except Exception:
                    log.exception(
                        "mesh %s: placement reconcile error (node %s)",
                        self.name, node.node_id)
            fleetcache = self._fleetcache
            if fleetcache is not None:
                try:
                    # replication is advisory anti-entropy: failures
                    # are counted inside, this guard catches tier bugs
                    fleetcache.on_probe_cycle(node)
                except Exception:
                    log.exception(
                        "mesh %s: fleet-cache replication error "
                        "(node %s)", self.name, node.node_id)
            propagator = self._tenancy_propagator
            if propagator is not None:
                try:
                    # config push is idempotent desired-state: failures
                    # are counted inside, this guard catches plane bugs
                    propagator.on_probe_cycle(node)
                except Exception:
                    log.exception(
                        "mesh %s: tenant-config push error (node %s)",
                        self.name, node.node_id)
            self._wake.wait(timeout=self.probe_interval_s)

    # -- routing --------------------------------------------------------------
    @staticmethod
    def _headroom(node: MeshNode) -> float:
        """Slots left below the backend's current graduated batch rung,
        from router + scraped occupancy: a node at 3 of rung 4 (headroom
        1) beats one at 2 of rung 2 (headroom 0) — the new stream fills
        a rung there instead of graduating one."""
        occupancy = node.outstanding + node.reported_outstanding
        for rung in BATCH_BUCKETS:
            if rung >= max(occupancy, 1.0):
                return rung - occupancy
        return 0.0

    def _rank_locked(self, node: MeshNode) -> tuple:
        return (node.outstanding, -self._headroom(node), node.index)

    def pick(self, exclude: tuple = (),
             voice: Optional[str] = None,
             affinity_key: Optional[str] = None) -> MeshNode:
        """Reserve the best routable node (caller must :meth:`release`).

        A half-open node with nothing outstanding takes the request as
        its breaker trial.  With ``voice`` set and a placement plane
        attached, candidates are restricted to converged holders of
        that voice; zero converged holders of a known voice raises the
        typed :class:`VoiceWarming` refusal (``route_stream`` absorbs
        it with the bounded placement wait).  With ``affinity_key`` set
        and a fleet cache attached, the key's rendezvous owner among
        the healthy candidates wins (unless its load skew trips the
        guard) — trial precedence and every exclusion/restriction
        above still apply, so affinity only ever biases WITHIN the
        routable set.  Raises typed :class:`Draining` when every
        candidate is mid-deploy, :class:`Overloaded` when none is
        healthy."""
        with self._lock:
            allowed = None
            if voice is not None and self._placement is not None:
                # plane lock nested inside the router lock — the one
                # ordering the placement plane is built around
                allowed = self._placement.routable_for(voice)

            def _holds(n: MeshNode) -> bool:
                return allowed is None or n.index in allowed

            for n in self.nodes:
                if (n.state == HALF_OPEN and n.outstanding == 0
                        and n.ready and not n.draining
                        and not n.scope_stale and n not in exclude
                        and _holds(n)):
                    return self._reserve_locked(n, voice)
            routable = [n for n in self.nodes
                        if n.state == CLOSED and n.ready
                        and not n.draining and not n.scope_stale
                        and n not in exclude and _holds(n)]
            if not routable:
                candidates = [n for n in self.nodes if n not in exclude]
                if allowed is not None and any(
                        self._routable_locked(n) for n in candidates) \
                        and not any(_holds(n) for n in candidates
                                    if self._routable_locked(n)):
                    # healthy nodes exist, none has converged on the
                    # voice yet: warming, not overload
                    raise VoiceWarming(
                        f"voice-warming: no converged holder of voice "
                        f"{voice!r} in mesh {self.name!r} yet "
                        "(placement replay in flight; retry shortly)")
                if candidates and all(n.draining for n in candidates):
                    raise Draining(
                        f"draining: every node of mesh {self.name!r} is "
                        "draining for a deploy; retry shortly")
                raise Overloaded(
                    f"mesh {self.name!r}: no healthy node available "
                    f"({sum(1 for n in self.nodes if self._routable_locked(n))}"
                    f" of {len(self.nodes)} routable)")
            if affinity_key is not None and self._fleetcache is not None:
                choice = self._fleetcache.affinity_choice_locked(
                    affinity_key, routable)
                if choice is not None:
                    return self._reserve_locked(choice, voice)
            best = min(routable, key=self._rank_locked)
            return self._reserve_locked(best, voice)

    def _reserve_locked(self, node: MeshNode,
                        voice: Optional[str]) -> MeshNode:
        node.outstanding += 1
        node.routed += 1
        self.stats["routed"] += 1
        if voice is not None:
            node.voice_outstanding[voice] = \
                node.voice_outstanding.get(voice, 0) + 1
            if self._placement is not None:
                self._placement.touch(voice)  # the LRU clock
        return node

    def release(self, node: MeshNode,
                voice: Optional[str] = None) -> None:
        with self._lock:
            if node.outstanding > 0:
                node.outstanding -= 1
            if voice is not None:
                held = node.voice_outstanding.get(voice, 0)
                if held <= 1:
                    node.voice_outstanding.pop(voice, None)
                else:
                    node.voice_outstanding[voice] = held - 1

    def record_route(self, node: MeshNode, ok: bool,
                     reason: str = "") -> None:
        """Route outcome → breaker bookkeeping (success closes a
        half-open trial; failure counts toward the threshold)."""
        with self._lock:
            if ok:
                node.consecutive_failures = 0
                if node.state == HALF_OPEN:
                    node.state = CLOSED
                    node.probe_backoff_s = None
                    self.stats["recovered"] += 1
                    log.info("mesh %s: node %s trial request succeeded; "
                             "breaker closed", self.name, node.node_id)
            else:
                node.route_failures += 1
                node.consecutive_failures += 1
                self._maybe_trip_locked(node, node.consecutive_failures,
                                        reason or "route failure")

    def _note_draining(self, node: MeshNode, exc: BaseException) -> None:
        """A typed draining refusal evicts the node NOW — the next
        scrape would too, but requests racing the deploy should not
        keep landing on it for a probe interval."""
        with self._lock:
            if not node.draining:
                node.draining = True
                log.info("mesh %s: node %s refused typed draining (%s); "
                         "evicted from membership until it rejoins",
                         self.name, node.node_id, exc)

    @staticmethod
    def _cancel(call) -> None:
        cancel = getattr(call, "cancel", None)
        if cancel is not None:
            try:
                cancel()
            except Exception:
                pass

    def _hedge_fire(self, call, hedged: list, got_first: list,
                    lock: threading.Lock) -> None:
        # the flag exchange under the lock makes the hedge and the
        # first chunk mutually exclusive: once got_first is set the
        # timer is a no-op, so a cancel can never land after bytes
        # were yielded to the client
        with lock:
            if got_first[0]:
                return
            hedged[0] = True
        self._cancel(call)

    def route_stream(self, start: Callable, *,
                     deadline: Optional[Deadline] = None,
                     request_id: Optional[str] = None,
                     classify: Optional[Callable] = None,
                     voice: Optional[str] = None,
                     affinity_key: Optional[str] = None) -> Iterator:
        """Route one streaming request across the fleet; yields chunks.

        ``start(node, timeout_s)`` opens the stream on ``node`` and
        returns an iterable (``cancel()`` honored when present —
        real gRPC calls and the test fakes both have one).  The retry
        contract: route-class failures and draining refusals reroute
        (bounded by ``SONATA_MESH_RETRIES`` and the deadline) while no
        chunk has been yielded; after the first chunk every failure is
        typed through.  With ``voice`` set, routing is restricted to
        converged placement holders, and a :class:`VoiceWarming` state
        gets a bounded router-side wait (``SONATA_PLACEMENT_WAIT_MS``,
        separate from the retry budget — a warming voice is not a
        fault) before failing typed.  The caller holds its own
        admission slot; this method holds the per-node outstanding
        count.  ``affinity_key`` (the fleet cache tier) biases every
        attempt's pick toward the key's rendezvous owner — on failover
        the dead owner sits in the exclusion list, so HRW over the
        remaining nodes lands on the key's next preference, which is
        exactly the hot-set replication peer.
        """
        classify = classify if classify is not None else default_classify
        tried: list = []
        retries_left = self.retries
        backoff_s = self.retry_backoff_ms / 1e3
        streamed = False
        warming_until: Optional[float] = None
        while True:
            if deadline is not None:
                deadline.raise_if_expired()
            try:
                node = self.pick(exclude=tuple(tried), voice=voice,
                                 affinity_key=affinity_key)
            except VoiceWarming as e:
                now = time.monotonic()
                if warming_until is None:
                    budget = (self._placement.wait_budget_s
                              if self._placement is not None else 0.0)
                    warming_until = now + budget
                if now < warming_until and (deadline is None
                                            or deadline.alive()):
                    time.sleep(min(0.05, max(warming_until - now, 0.0)))
                    continue
                with self._lock:
                    self.stats["failed"] += 1
                log.warning("mesh %s: request %s failed voice-warming "
                            "after the placement wait budget (%s)",
                            self.name, request_id, e)
                raise
            except (Overloaded, Draining) as e:
                # transient no-candidate states deserve the same bounded
                # retry as a route failure: the canonical case is a node
                # kill while the only peer is HALF_OPEN with its trial
                # in flight — the trial resolves in one request's time,
                # well inside a backoff step
                if retries_left > 0 and (deadline is None
                                         or deadline.alive()):
                    retries_left -= 1
                    delay = backoff_s * (1.0 + MESH_JITTER
                                         * random.random())
                    log.warning("mesh %s: no candidate node for request "
                                "%s (%s); retrying in %.0f ms", self.name,
                                request_id, e, delay * 1e3)
                    time.sleep(delay)
                    backoff_s = min(backoff_s * 2, MAX_RETRY_BACKOFF_S)
                    continue
                with self._lock:
                    self.stats["failed"] += 1
                raise
            timeout_s = None
            if deadline is not None:
                rem = deadline.remaining()
                if rem is not None:
                    # shrunk by everything spent so far: queue wait,
                    # failed attempts, backoff sleeps
                    timeout_s = max(rem, 1e-3)
            call = None
            hedged = [False]
            got_first = [False]
            hedge_lock = threading.Lock()
            timer: Optional[threading.Timer] = None
            try:
                with tracing.span("mesh-dispatch", node=node.node_id,
                                  addr=node.spec.addr,
                                  attempt=len(tried) + 1) as sp:
                    faults.fire("mesh.route")
                    call = start(node, timeout_s)
                    it = iter(call)
                    if self.hedge_ms > 0:
                        timer = threading.Timer(
                            self.hedge_ms / 1e3, self._hedge_fire,
                            (call, hedged, got_first, hedge_lock))
                        timer.daemon = True
                        timer.start()
                    try:
                        first = next(it, _DONE)
                    finally:
                        if timer is not None:
                            timer.cancel()
                    if timer is not None:
                        with hedge_lock:
                            got_first[0] = True
                            hedge_won = hedged[0]
                        if hedge_won and first is not _DONE:
                            # the timer cancelled the call concurrently
                            # with the first chunk arriving; nothing
                            # reached the client yet, and the rest of
                            # the stream is gone — reroute instead of
                            # emitting one chunk of a dead stream
                            raise _HedgeCancelled(
                                "first-chunk hedge fired at "
                                f"{self.hedge_ms:g} ms")
                    if first is not _DONE:
                        streamed = True
                        yield first
                        for chunk in it:
                            yield chunk
                    sp.annotate(streamed=streamed)
                self.record_route(node, ok=True)
                self.release(node, voice)
                return
            except GeneratorExit:
                # the client went away: stop the backend stream, free
                # the slot, and let the generator close normally
                self._cancel(call)
                self.release(node, voice)
                raise
            except Exception as e:
                self.release(node, voice)
                if hedged[0] and not streamed:
                    kind = "hedge"
                elif streamed:
                    kind = "fatal"
                else:
                    kind = classify(e)
                reason = f"{type(e).__name__}: {e}"
                if kind == "draining":
                    # a deploy, not a fault: evict, don't count
                    self._note_draining(node, e)
                elif kind in ("route", "hedge"):
                    self.record_route(node, ok=False, reason=reason)
                else:
                    if streamed:
                        # mid-stream death is the node's fault — count
                        # it, but the client already holds bytes: fail
                        # typed rather than resend audio
                        self.record_route(node, ok=False, reason=reason)
                    with self._lock:
                        self.stats["failed"] += 1
                    raise
                tried.append(node)
                if retries_left <= 0 or (deadline is not None
                                         and not deadline.alive()):
                    with self._lock:
                        self.stats["failed"] += 1
                    raise
                retries_left -= 1
                with self._lock:
                    self.stats["rerouted"] += 1
                    if kind == "draining":
                        self.stats["rerouted_draining"] += 1
                    elif kind == "hedge":
                        self.stats["hedged"] += 1
                ctx = tracing.current()
                if ctx is not None:
                    # the failover must be visible in the request's own
                    # trace, like the pool's resubmit span
                    trace, parent = ctx
                    now = time.monotonic()
                    trace.new_span("mesh-reroute", parent=parent,
                                   start=now, end=now,
                                   attrs={"failed_node": node.node_id,
                                          "kind": kind, "error": reason})
                log.warning("mesh %s: rerouting request %s off node %s "
                            "(%s: %s)", self.name, request_id,
                            node.node_id, kind, e)
                if kind == "route":
                    delay = backoff_s * (1.0 + MESH_JITTER
                                         * random.random())
                    if deadline is not None:
                        rem = deadline.remaining()
                        if rem is not None:
                            delay = min(delay, max(rem - 0.01, 0.0))
                    if delay > 0:
                        time.sleep(delay)
                    backoff_s = min(backoff_s * 2, MAX_RETRY_BACKOFF_S)
                continue
