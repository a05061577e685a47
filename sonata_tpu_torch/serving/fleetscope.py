"""sonata-fleetscope: the fleet-aggregated observability plane.

N sonata servers federate behind the mesh router, but every
observability surface a node has — stage quantiles, SLO burn, waste
tables, the flight recorder — stops at the process boundary: an
operator of a 10-node fleet has 10 ``/debug/quantiles`` pages and no
answer to "what is fleet-wide TTFB p99, which node is the outlier, and
what was the whole fleet doing when the breaker tripped?".  The
sketches were built *mergeable* (merge == union, pinned) precisely so
aggregation could cross hosts; this module closes that loop on the
router, in four coupled pieces:

1. **Scope-export scraping.**  Each node serves its whole aggregation
   plane as a compact versioned payload (bins + slot epochs, never
   samples) at ``GET /debug/scope/export``; the mesh prober calls
   :meth:`FleetScope.on_probe_cycle` every health cycle and this module
   pulls the export on its own slower cadence
   (``SONATA_FLEET_SCRAPE_INTERVAL_S``, default 5 s).  A version
   mismatch is rejected loud and typed per node
   (:class:`~.sketches.SketchImportError`) — never folded.  Staleness
   past ``SONATA_FLEET_SCRAPE_STALE_S`` evicts the node to unroutable:
   a node whose observability plane is wedged must not keep looking
   healthy just because the last good scrape said so.
2. **Fleet aggregation.**  Node sketch exports merge into fleet-wide
   per-stage quantiles (bucket union == pooling the raw observations,
   so the 1% relative-error guarantee survives the hop — pinned across
   real processes in tests/test_fleetscope.py), fleet SLO burn rates
   (same ``SONATA_SLO`` grammar, fast/slow windows), and
   per-node-vs-fleet deltas that name outlier nodes.  Exported as
   ``sonata_fleet_stage_quantile{stage,q,window}``,
   ``sonata_fleet_slo_burn_rate{slo,window}``,
   ``sonata_fleet_node_delta{node_id,stage}``,
   ``sonata_mesh_node_scrape_age_seconds{node_id}``, and the
   ``GET /debug/fleet`` JSON scoreboard (per-node health, occupancy,
   scrape staleness, burn, top waste buckets).
3. **Stitched distributed traces.**  ``GET /debug/traces/stitched?id=``
   finds the router's own trace for a request id, learns the serving
   node from its ``mesh-dispatch`` span, fetches that node's trace over
   ``/debug/traces?id=``, re-bases the node's clock through the
   scrape-measured wall offset, and splices both span trees into one
   Chrome-trace document — one Perfetto load shows the whole cross-host
   request (router admission → mesh-dispatch → stream-emit, reroutes
   included, over the node's queue → dispatch → decode).
4. **Fleet flight recorder.**  A 1 Hz ring of fleet snapshots
   (per-node routable/breaker/outstanding/scrape-age plus fleet
   rollups and fast burn), auto-dumped to ``SONATA_FLEET_DUMP_DIR``
   (falling back to ``SONATA_TIMELINE_DUMP_DIR``) on node eviction,
   breaker trip, or a fleet-level fast-burn breach — reusing the
   per-reason rate limiting so a flapping breaker cannot starve a burn
   incident of its dump.

Cost model: scraping is one small HTTP GET per node per cadence on the
node's existing debug plane (node-side cost measured ≤ the 2%
bar, FLEET_r01.json); aggregation work happens router-side at scrape
and query time, never on the audio hot path.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.parse
from collections import deque
from typing import Callable, Dict, List, Optional

from . import sketches, tracing
from .mesh import _http_fetch
from .scope import (
    DUMP_DIR_ENV,
    DUMP_MIN_INTERVAL_S,
    FAST_WINDOW,
    QUANTILES,
    SLOW_WINDOW,
    STAGES,
    WINDOWS,
    parse_slos,
)
from .sketches import QuantileSketch, SketchImportError

log = logging.getLogger("sonata.serving")

FLEET_SCRAPE_INTERVAL_ENV = "SONATA_FLEET_SCRAPE_INTERVAL_S"
FLEET_SCRAPE_STALE_ENV = "SONATA_FLEET_SCRAPE_STALE_S"
FLEET_RECORDER_CAP_ENV = "SONATA_FLEET_RECORDER_CAP"
FLEET_DUMP_DIR_ENV = "SONATA_FLEET_DUMP_DIR"

DEFAULT_SCRAPE_INTERVAL_S = 5.0
DEFAULT_SCRAPE_STALE_S = 30.0
DEFAULT_RECORDER_CAP = 600
DEFAULT_TICK_INTERVAL_S = 1.0

#: the outlier lens: per-node-vs-fleet deltas compare this quantile
#: over this window (positive delta = the node is slower than the
#: fleet merge at its tail)
DELTA_WINDOW = FAST_WINDOW[0]
DELTA_QUANTILE = 0.99

#: window seconds by label (age-expiry at merge time needs them)
_WINDOW_SECONDS = {label: seconds for label, seconds, _slots in WINDOWS}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, default)))
    except ValueError:
        return default


#: fleet-level metric families, loop-registered like the scope's
#: GAUGE_FAMILIES so the sonata-lint metricsdoc pass resolves the names
FLEET_GAUGE_FAMILIES = (
    ("sonata_fleet_stage_quantile",
     "Fleet-wide rolling per-stage latency quantile in seconds, merged "
     "from every reporting node's sketch export, by stage, quantile "
     "(p50/p90/p99) and window (1m/5m/1h)."),
    ("sonata_fleet_slo_burn_rate",
     "Fleet-wide SLO burn rate by objective and window (node SLO "
     "counters summed; 1.0 = the whole fleet consuming exactly its "
     "error budget)."),
    ("sonata_fleet_nodes_reporting",
     "Backend nodes whose scope export has been imported (the fleet "
     "quantiles' population)."),
)

#: per-node labeled families (series appear once a node's export has
#: taught the router its node_id, removed on close)
FLEET_NODE_GAUGE_FAMILIES = (
    ("sonata_fleet_node_delta",
     "Per-node minus fleet-merged 5m p99 in seconds, by node_id and "
     "stage (positive = this node is slower than the fleet — the "
     "outlier finder)."),
    ("sonata_mesh_node_scrape_age_seconds",
     "Seconds since this node's scope export last scraped OK, by "
     "node_id; past SONATA_FLEET_SCRAPE_STALE_S the node is evicted "
     "to unroutable."),
)


class _NodeScope:
    """One node's imported scope export plus scrape metadata."""

    __slots__ = ("node_id", "scraped_mono", "wall_offset_s", "rtt_s",
                 "export_bytes", "stage_rings", "slo_rings", "totals",
                 "top_waste_buckets", "synth_cache", "tenant_slos",
                 "tenant_waste")

    def __init__(self, node_id: str, scraped_mono: float,
                 wall_offset_s: float, rtt_s: float, export_bytes: int,
                 stage_rings: dict, slo_rings: dict, totals: dict,
                 top_waste_buckets: list,
                 synth_cache: Optional[dict] = None,
                 tenant_slos: Optional[dict] = None,
                 tenant_waste: Optional[list] = None):
        self.node_id = node_id
        self.scraped_mono = scraped_mono
        #: node wall clock minus router wall clock, measured against the
        #: fetch midpoint — what re-bases stitched traces
        self.wall_offset_s = wall_offset_s
        self.rtt_s = rtt_s
        self.export_bytes = export_bytes
        #: (stage, window label) -> [(age_s_at_scrape, QuantileSketch)]
        self.stage_rings = stage_rings
        #: (slo name, window label) -> (window_s, [(age_s, good, bad)])
        self.slo_rings = slo_rings
        self.totals = totals
        self.top_waste_buckets = top_waste_buckets
        #: the node's synthcache view (hit counters, bytes, hot_keys) —
        #: None on cache-off nodes; the fleet-cache replication pass
        #: reads hot_keys from here via node_cache_view
        self.synth_cache = synth_cache
        #: tenant -> (slo name, window label) -> (window_s, ring) —
        #: empty on tenancy-off nodes
        self.tenant_slos = tenant_slos or {}
        #: the node's per-tenant padding-waste rows
        self.tenant_waste = tenant_waste or []


class FleetScope:
    """Aggregate observability over a
    :class:`~sonata_tpu_torch.serving.mesh.MeshRouter`'s membership.

    Attach with ``router.attach_fleet(fleet)``: the router's per-node
    prober threads then drive :meth:`on_probe_cycle`, so scraping
    inherits the prober's isolation (a wedged node stalls only its own
    thread).  All imports are validated at ingest — a malformed or
    version-mismatched export is counted, logged, and dropped whole.
    """

    def __init__(self, router, *, tracer=None,
                 scrape_interval_s: Optional[float] = None,
                 stale_s: Optional[float] = None,
                 recorder_cap: Optional[int] = None,
                 dump_dir: Optional[str] = None,
                 slos=None,
                 fetch: Optional[Callable[[str, float], tuple]] = None,
                 tick_interval_s: float = DEFAULT_TICK_INTERVAL_S,
                 clock=None):
        self.router = router
        self.tracer = tracer
        self._clock = clock if clock is not None else time.monotonic
        self.scrape_interval_s = max(0.05, (
            scrape_interval_s if scrape_interval_s is not None
            else _env_float(FLEET_SCRAPE_INTERVAL_ENV,
                            DEFAULT_SCRAPE_INTERVAL_S)))
        #: <= 0 disables staleness eviction (documented escape hatch)
        self.stale_s = (stale_s if stale_s is not None
                        else _env_float(FLEET_SCRAPE_STALE_ENV,
                                        DEFAULT_SCRAPE_STALE_S))
        self.recorder_cap = (recorder_cap if recorder_cap is not None
                             else _env_int(FLEET_RECORDER_CAP_ENV,
                                           DEFAULT_RECORDER_CAP))
        #: SONATA_FLEET_DUMP_DIR, falling back to the node recorder's
        #: SONATA_TIMELINE_DUMP_DIR so one knob configures both planes
        self.dump_dir = (dump_dir if dump_dir is not None
                         else os.environ.get(FLEET_DUMP_DIR_ENV)
                         or os.environ.get(DUMP_DIR_ENV) or None)
        self.slos = (parse_slos(slos)
                     if slos is None or isinstance(slos, str)
                     else list(slos))
        self._slo_by_name = {s.name: s for s in self.slos}
        self.tick_interval_s = max(0.05, tick_interval_s)
        self._fetch = fetch if fetch is not None else _http_fetch
        self._probe_timeout_s = getattr(router, "probe_timeout_s", 2.0)

        self._lock = threading.Lock()
        #: node.index -> _NodeScope (replaced whole per scrape)
        self._nodes: Dict[int, _NodeScope] = {}
        #: node.index -> monotonic stamp of the last scrape *attempt*
        self._attempt_at: Dict[int, float] = {}
        #: node.index -> first time this plane saw the node (staleness
        #: grace before the first successful scrape)
        self._first_seen: Dict[int, float] = {}
        #: nodes whose export answered 404: scope disabled there — not
        #: scrapeable, therefore never stale-evicted
        self._no_scope: set = set()
        self._gen = 0
        self._merged_lock = threading.Lock()
        self._merged_cache: Dict[tuple, tuple] = {}
        self.stats = {"scrapes": 0, "scrape_failures": 0,
                      "import_errors": 0}

        # fleet flight recorder
        self._timeline: "deque[dict]" = deque(
            maxlen=max(1, self.recorder_cap))
        self._timeline_lock = threading.Lock()
        self._last_dump_at: Dict[str, float] = {}
        self.dumps: List[str] = []
        #: edge-detection baselines.  Breaker trips are COUNTER edges,
        #: baselined at construction (zero trips) so a trip landing
        #: before the recorder's first 1 Hz tick still registers as an
        #: edge, not the baseline (caught by chaos phase M, where the
        #: injected trip beats the first tick).  Evictions are STATE
        #: edges and baseline at the first observed tick instead: a
        #: router booting before its backends would otherwise write a
        #: spurious node-evicted incident on every cold start.  Keyed
        #: by the stable node index, not node_id, so a scrape teaching
        #: the router a node's real id never reads as an eviction.
        self._last_routable_idx: Optional[frozenset] = None
        self._last_breaker_opens = 0
        self._last_burn_breach = False
        self._stop = threading.Event()
        self._ticker: Optional[threading.Thread] = None

        # metric bookkeeping (lazy per-node series, exact teardown)
        self._registry = None
        self._node_families: dict = {}
        self._series_lock = threading.Lock()
        self._node_series: list = []        # (index, metric, labels)
        self._node_series_ids: Dict[int, str] = {}

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "FleetScope":
        """Start the 1 Hz fleet recorder thread (idempotent)."""
        if self._ticker is None or not self._ticker.is_alive():
            self._stop.clear()
            self._ticker = threading.Thread(target=self._tick_loop,
                                            name="sonata_fleet_tick",
                                            daemon=True)
            self._ticker.start()
        return self

    def close(self) -> None:
        self._stop.set()
        ticker, self._ticker = self._ticker, None
        if ticker is not None:
            ticker.join(timeout=2.0)
        self.unregister_node_series()

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:
                # the recorder must never take the router down
                log.exception("fleet recorder tick failed")

    # -- scraping (rides the mesh prober threads) ------------------------------
    def on_probe_cycle(self, node) -> None:
        """Called by the router's prober after every health cycle for
        ``node``: scrape the scope export when the fleet cadence is
        due, and re-evaluate staleness every cycle (so eviction fires
        within one probe interval of the budget, not one scrape
        interval)."""
        if node.spec.metrics_base is None:
            return
        now = self._clock()
        with self._lock:
            self._first_seen.setdefault(node.index, now)
            last = self._attempt_at.get(node.index)
            due = last is None or now - last >= self.scrape_interval_s
            if due:
                self._attempt_at[node.index] = now
        if due:
            self.scrape_node(node)
        self._update_staleness(node)

    def scrape_node(self, node) -> bool:
        """One scope-export pull + ingest.  Returns whether an export
        was imported."""
        base = node.spec.metrics_base
        if base is None:
            return False
        t0_wall = time.time()
        try:
            code, body = self._fetch(base + "/debug/scope/export",
                                     self._probe_timeout_s)
        except Exception as e:
            with self._lock:
                self.stats["scrape_failures"] += 1
            log.debug("fleet: scope scrape of node %s failed: %s",
                      node.node_id, e)
            return False
        t1_wall = time.time()
        if code == 404:
            # scope disabled on that node (SONATA_SCOPE=0): it simply
            # does not report — never a fault, never stale-evicted.
            # Any export it reported BEFORE (e.g. pre-restart) is
            # dropped whole: a node that stopped exporting must not
            # stay "reporting" with an unboundedly-aging snapshot
            self._drop_node_scope(node)
            with self._lock:
                self._no_scope.add(node.index)
            return False
        if code != 200:
            with self._lock:
                self.stats["scrape_failures"] += 1
            return False
        try:
            payload = json.loads(body)
            self.ingest(node, payload,
                        wall_mid=(t0_wall + t1_wall) / 2.0,
                        rtt_s=t1_wall - t0_wall,
                        export_bytes=len(body))
        except SketchImportError as e:
            with self._lock:
                self.stats["import_errors"] += 1
            log.error("fleet: node %s scope export rejected: %s",
                      node.node_id, e)
            return False
        except ValueError as e:
            with self._lock:
                self.stats["import_errors"] += 1
            log.error("fleet: node %s scope export is not JSON: %s",
                      node.node_id, e)
            return False
        return True

    def ingest(self, node, payload, *, wall_mid: Optional[float] = None,
               rtt_s: float = 0.0, export_bytes: int = 0) -> None:
        """Validate and import one node's scope export (the whole
        payload is parsed up front — a malformed ring raises the typed
        :class:`SketchImportError` here, never lazily at query time)."""
        sketches._check_version(payload, "scope")
        stages = payload.get("stages")
        if not isinstance(stages, dict):
            raise SketchImportError("scope export has no 'stages' dict")
        stage_rings: dict = {}
        for stage, windows in stages.items():
            if not isinstance(windows, dict):
                raise SketchImportError(
                    f"scope export stage {stage!r} is not a dict")
            for label, ring_payload in windows.items():
                _w, _s, ring = sketches.ring_from_export(ring_payload)
                for _age, sk in ring:
                    # fleet merges are raw bucket adds: a node built
                    # with a different gamma must be rejected HERE,
                    # whole and typed, never folded (its bin keys mean
                    # different values)
                    if abs(sk.relative_accuracy
                           - sketches.DEFAULT_RELATIVE_ACCURACY) > 1e-12:
                        raise SketchImportError(
                            f"stage {stage!r}/{label}: node sketch "
                            f"relative_accuracy {sk.relative_accuracy} "
                            "differs from this router's "
                            f"{sketches.DEFAULT_RELATIVE_ACCURACY}")
                stage_rings[(stage, label)] = ring
        slo_rings: dict = {}
        for name, windows in (payload.get("slos") or {}).items():
            for label, ring_payload in dict(windows).items():
                # pre-parsed at ingest like the stage rings: burn
                # queries then only re-expire by age, no re-parsing on
                # the metrics scrape path
                window_s, _slot_s, ring = \
                    sketches.counter_ring_from_export(ring_payload)
                slo_rings[(name, label)] = (window_s, ring)
        # per-tenant SLO rings: same counter-ring format as
        # the global slos, one layer deeper — parsed whole at ingest so
        # a malformed tenant ring rejects the export typed, like the rest
        tenant_slos: dict = {}
        for tenant, tslos in (payload.get("tenant_slos") or {}).items():
            rings: dict = {}
            for name, windows in dict(tslos).items():
                for label, ring_payload in dict(windows).items():
                    window_s, _slot_s, ring = \
                        sketches.counter_ring_from_export(ring_payload)
                    rings[(name, label)] = (window_s, ring)
            tenant_slos[str(tenant)] = rings
        wall = payload.get("wall_time")
        offset = 0.0
        if isinstance(wall, (int, float)) and wall_mid is not None:
            offset = float(wall) - wall_mid
        ns = _NodeScope(
            node_id=node.node_id, scraped_mono=self._clock(),
            wall_offset_s=offset, rtt_s=rtt_s,
            export_bytes=export_bytes, stage_rings=stage_rings,
            slo_rings=slo_rings,
            totals=dict(payload.get("totals") or {}),
            top_waste_buckets=list(payload.get("top_waste_buckets")
                                   or ()),
            synth_cache=(dict(payload["synth_cache"])
                         if isinstance(payload.get("synth_cache"), dict)
                         else None),
            tenant_slos=tenant_slos,
            tenant_waste=list(payload.get("tenant_waste") or ()))
        with self._lock:
            self._nodes[node.index] = ns
            self._no_scope.discard(node.index)
            self._gen += 1
            self.stats["scrapes"] += 1
        self.router.record_scope_scrape(node)
        self._ensure_node_series(node)

    def _drop_node_scope(self, node) -> None:
        """Forget a node's imported export and its node_id-labeled
        series (a node that stopped exporting must not stay
        'reporting', inflate `sonata_fleet_nodes_reporting`, or page
        the scrape-age alert forever)."""
        with self._lock:
            had = self._nodes.pop(node.index, None) is not None
            if had:
                self._gen += 1
        if not had:
            return
        with self._series_lock:
            kept = []
            for idx, metric, labels in self._node_series:
                if idx == node.index:
                    metric.remove(**labels)
                else:
                    kept.append((idx, metric, labels))
            self._node_series = kept
            self._node_series_ids.pop(node.index, None)

    def _update_staleness(self, node) -> None:
        if self.stale_s <= 0 or node.spec.metrics_base is None:
            return
        now = self._clock()
        with self._lock:
            if node.index in self._no_scope:
                stale = False
            else:
                ns = self._nodes.get(node.index)
                ref = (ns.scraped_mono if ns is not None
                       else self._first_seen.get(node.index, now))
                stale = now - ref > self.stale_s
        # router lock taken outside the fleet lock (one-way ordering)
        self.router.set_scope_stale(node, stale)

    # -- fleet aggregation -----------------------------------------------------
    def _node_scopes(self) -> List[_NodeScope]:
        with self._lock:
            return list(self._nodes.values())

    def nodes_reporting(self) -> int:
        with self._lock:
            return len(self._nodes)

    def _merge_node_stage(self, ns: _NodeScope, stage: str,
                          window: str) -> Optional[QuantileSketch]:
        """One node's (stage, window) ring folded to a sketch, expiring
        slots by export age + scrape age (an export scraped 50 s ago
        contributes only what is still inside the window *now*)."""
        ring = ns.stage_rings.get((stage, window))
        if not ring:
            return None
        window_s = _WINDOW_SECONDS.get(window)
        if window_s is None:
            return None
        extra = self._clock() - ns.scraped_mono
        out = None
        for age_s, sketch in ring:
            if age_s + extra > window_s:
                continue
            if out is None:
                out = QuantileSketch(sketch.relative_accuracy)
            out.merge(sketch)
        return out

    def _merged(self, stage: str, window: str) -> QuantileSketch:
        """Fleet-merged sketch for (stage, window), memoized per
        (ingest generation, second) so one metrics scrape's 9 quantile
        callbacks per pair pay a single merge."""
        with self._lock:
            gen = self._gen
        stamp = (gen, int(self._clock()))
        key = (stage, window)
        with self._merged_lock:
            cached = self._merged_cache.get(key)
            if cached is not None and cached[0] == stamp:
                return cached[1]
        out = QuantileSketch()
        for ns in self._node_scopes():
            sk = self._merge_node_stage(ns, stage, window)
            if sk is not None and sk.count > 0:
                out.merge(sk)
        with self._merged_lock:
            self._merged_cache[key] = (stamp, out)
        return out

    def fleet_quantile(self, stage: str, q: float,
                       window: str) -> Optional[float]:
        """Fleet-wide quantile from the merged node exports, or None
        while no node has reported observations for the pair."""
        if stage not in STAGES or window not in _WINDOW_SECONDS:
            return None
        merged = self._merged(stage, window)
        if merged.count == 0:
            return None
        return merged.quantile(q)

    def _node_totals(self, ns: _NodeScope, slo: str,
                     window: str) -> tuple:
        entry = ns.slo_rings.get((slo, window))
        if entry is None:
            return 0, 0
        window_s, ring = entry
        extra = self._clock() - ns.scraped_mono
        good = bad = 0
        for age_s, g, b in ring:
            if age_s + extra > window_s:
                continue
            good += g
            bad += b
        return good, bad

    def fleet_burn_rate(self, slo: str,
                        window: str) -> Optional[float]:
        """Fleet bad fraction / budget over one window (node counters
        summed), or None while the fleet window is empty."""
        spec = self._slo_by_name.get(slo)
        if spec is None or window not in (FAST_WINDOW[0], SLOW_WINDOW[0]):
            return None
        good = bad = 0
        for ns in self._node_scopes():
            g, b = self._node_totals(ns, slo, window)
            good += g
            bad += b
        total = good + bad
        if total == 0:
            return None
        return (bad / total) / spec.budget

    def fleet_budget_remaining(self, slo: str) -> Optional[float]:
        burn = self.fleet_burn_rate(slo, SLOW_WINDOW[0])
        if burn is None:
            return None
        return 1.0 - burn

    def node_delta(self, node, stage: str) -> Optional[float]:
        """This node's 5m p99 minus the fleet-merged 5m p99 for
        ``stage`` (seconds; positive = slower than the fleet).  None
        until both sides have data."""
        with self._lock:
            ns = self._nodes.get(node.index)
        if ns is None:
            return None
        own = self._merge_node_stage(ns, stage, DELTA_WINDOW)
        if own is None or own.count == 0:
            return None
        fleet = self.fleet_quantile(stage, DELTA_QUANTILE, DELTA_WINDOW)
        own_q = own.quantile(DELTA_QUANTILE)
        if fleet is None or own_q is None:
            return None
        return own_q - fleet

    # -- the /debug/fleet scoreboard -------------------------------------------
    def fleet_snapshot(self) -> dict:
        """The JSON scoreboard: per-node health/occupancy/staleness/
        burn/deltas plus the fleet rollups."""
        view = self.router.snapshot()
        with self._lock:
            by_index = dict(self._nodes)
            no_scope = set(self._no_scope)
            stats = dict(self.stats)
        nodes_out = []
        for node in self.router.nodes:
            nv = node.snapshot()
            ns = by_index.get(node.index)
            entry = {**nv,
                     "reporting": ns is not None,
                     "scope_disabled": node.index in no_scope}
            if ns is not None:
                entry["export_age_s"] = round(
                    self._clock() - ns.scraped_mono, 3)
                entry["wall_offset_s"] = round(ns.wall_offset_s, 6)
                entry["totals"] = ns.totals
                entry["burn"] = {
                    spec.name: _round6(self._burn_of(ns, spec))
                    for spec in self.slos}
                entry["delta_p99_5m"] = {
                    stage: _round6(self.node_delta(node, stage))
                    for stage in STAGES}
                if ns.synth_cache is not None:
                    entry["synth_cache"] = ns.synth_cache
            nodes_out.append(entry)
        fleet_quant = {
            stage: {window: self._merged(stage, window).to_dict()
                    for window, _s in _WINDOW_SECONDS.items()}
            for stage in STAGES}
        fleet_slo = [{
            **spec.to_dict(),
            "burn_rate": {
                label: _round6(self.fleet_burn_rate(spec.name, label))
                for label in (FAST_WINDOW[0], SLOW_WINDOW[0])},
            "budget_remaining": _round6(
                self.fleet_budget_remaining(spec.name))}
            for spec in self.slos]
        # per-node voice-placement table: desired vs
        # converged holders, budgets, tombstones — served here so one
        # /debug/fleet load answers "where do this fleet's voices live"
        plane = getattr(self.router, "placement", None)
        placement = (plane.snapshot() if plane is not None
                     else None)
        # fleet cache tier: the router-side affinity/
        # replication view plus the node cache-counter rollup — one
        # /debug/fleet load answers "is the fleet cache working"
        fleetcache = getattr(self.router, "fleetcache", None)
        cache_rollup = self._cache_rollup(by_index.values())
        if fleetcache is not None:
            cache_rollup["router"] = fleetcache.snapshot()
        # multi-tenant rollup: fleet-merged per-tenant burn
        # plus the padding-waste chargeback — empty dict/list while the
        # fleet runs tenancy-off, so the document shape is stable
        tenant_burn = self.fleet_tenant_burn(by_index.values())
        tenant_waste = self._merged_tenant_waste(by_index.values())
        return {
            "name": view["name"],
            "routable": view["routable"],
            "router_stats": view["stats"],
            "scrape": {"interval_s": self.scrape_interval_s,
                       "stale_s": self.stale_s, **stats},
            "placement": placement,
            "nodes": nodes_out,
            "fleet": {
                "nodes_reporting": len(by_index),
                "stage_quantiles": fleet_quant,
                "slo": fleet_slo,
                "cache": cache_rollup,
                "top_waste_buckets": self._merged_waste_rows(
                    by_index.values()),
                "tenants": tenant_burn,
                "tenant_waste": tenant_waste,
            }}

    # -- fleet cache rollup -----------------------------------------
    def node_cache_view(self, node) -> Optional[dict]:
        """The node's last-scraped synthcache view (None before one
        lands or on cache-off nodes) — the fleet-cache replication
        pass reads ``hot_keys`` from here."""
        with self._lock:
            ns = self._nodes.get(node.index)
        return None if ns is None else ns.synth_cache

    @staticmethod
    def _cache_rollup(node_scopes) -> dict:
        """Sum the reporting nodes' cache counters into the fleet view:
        fleet hit ratio (total hits over total resolved lookups),
        resident bytes/entries, and the reporting population."""
        hits = misses = bytes_used = entries = with_cache = 0
        for ns in node_scopes:
            sc = ns.synth_cache
            if not sc:
                continue
            with_cache += 1
            hits += int(sc.get("hits") or 0)
            misses += int(sc.get("misses") or 0)
            bytes_used += int(sc.get("bytes") or 0)
            entries += int(sc.get("entries") or 0)
        total = hits + misses
        return {"nodes_with_cache": with_cache, "hits": hits,
                "misses": misses, "bytes": bytes_used,
                "entries": entries,
                "hit_ratio": (round(hits / total, 6) if total else None)}

    def _burn_of(self, ns: _NodeScope, spec) -> Optional[float]:
        g, b = self._node_totals(ns, spec.name, FAST_WINDOW[0])
        total = g + b
        if total == 0:
            return None
        return (b / total) / spec.budget

    # -- per-tenant fleet burn ---------------------------------------
    def _tenant_totals(self, ns: _NodeScope, tenant: str, slo: str,
                       window: str) -> tuple:
        entry = ns.tenant_slos.get(tenant, {}).get((slo, window))
        if entry is None:
            return 0, 0
        window_s, ring = entry
        extra = self._clock() - ns.scraped_mono
        good = bad = 0
        for age_s, g, b in ring:
            if age_s + extra > window_s:
                continue
            good += g
            bad += b
        return good, bad

    def fleet_tenant_burn(self, node_scopes=None) -> dict:
        """Fleet-merged per-tenant burn: tenant -> slo -> window ->
        bad fraction / budget (node counters summed), empty while no
        node exports tenant rings — the /debug/fleet 'tenants' block."""
        if node_scopes is None:
            node_scopes = self._node_scopes()
        tenants: set = set()
        for ns in node_scopes:
            tenants.update(ns.tenant_slos)
        out: dict = {}
        for tenant in sorted(tenants):
            per_slo: dict = {}
            for spec in self.slos:
                burns: dict = {}
                for label in (FAST_WINDOW[0], SLOW_WINDOW[0]):
                    good = bad = 0
                    for ns in node_scopes:
                        g, b = self._tenant_totals(
                            ns, tenant, spec.name, label)
                        good += g
                        bad += b
                    total = good + bad
                    if total:
                        burns[label] = _round6(
                            (bad / total) / spec.budget)
                if burns:
                    per_slo[spec.name] = burns
            if per_slo:
                out[tenant] = per_slo
        return out

    @staticmethod
    def _merged_tenant_waste(node_scopes) -> list:
        """Fleet per-tenant padding-waste chargeback: nodes' tenant
        rows summed by tenant, ranked by waste seconds."""
        acc: dict = {}
        for ns in node_scopes:
            for row in ns.tenant_waste:
                tenant = row.get("tenant")
                if not tenant:
                    continue
                slot = acc.setdefault(tenant, {
                    "tenant": tenant, "dispatches": 0,
                    "seconds": 0.0, "waste_seconds": 0.0})
                slot["dispatches"] += int(row.get("dispatches", 0))
                for k in ("seconds", "waste_seconds"):
                    slot[k] = round(slot[k] + float(row.get(k, 0.0)), 6)
        return sorted(acc.values(), key=lambda r: r["waste_seconds"],
                      reverse=True)

    @staticmethod
    def _merged_waste_rows(node_scopes, top: int = 10) -> list:
        """Fleet top waste buckets: nodes' top rows summed by bucket
        key.  Each node only exports its own top rows, so this is a
        lower bound per bucket — good enough to rank where the fleet's
        padding seconds go."""
        acc: dict = {}
        for ns in node_scopes:
            for row in ns.top_waste_buckets:
                key = (row.get("batch_bucket"), row.get("text_bucket"),
                       row.get("frame_bucket"))
                slot = acc.setdefault(key, {
                    "batch_bucket": key[0], "text_bucket": key[1],
                    "frame_bucket": key[2], "dispatches": 0, "rows": 0,
                    "padding_rows": 0, "seconds": 0.0,
                    "waste_seconds": 0.0, "cold_compiles": 0})
                for k in ("dispatches", "rows", "padding_rows",
                          "cold_compiles"):
                    slot[k] += int(row.get(k, 0))
                for k in ("seconds", "waste_seconds"):
                    slot[k] = round(slot[k] + float(row.get(k, 0.0)), 6)
        rows = sorted(acc.values(), key=lambda r: r["waste_seconds"],
                      reverse=True)
        return rows[:top]

    # -- stitched distributed traces -------------------------------------------
    def stitched_trace(self, request_id: str) -> tuple:
        """(http status, document) for ``/debug/traces/stitched?id=``:
        the router's span tree and the serving node's, spliced into one
        Chrome-trace JSON with the node's clock re-based through the
        scrape-measured wall offset."""
        if not request_id:
            return 400, {"error": "missing ?id=<request id>"}
        if self.tracer is None:
            return 404, {"error": "tracing not enabled on the router"}
        trace = self.tracer.find(request_id)
        if trace is None:
            return 404, {"error": f"no router trace for id "
                                  f"{request_id!r} (the ring holds the "
                                  f"{self.tracer.recent_cap} most "
                                  "recent traces)"}
        node_id = None
        for span in trace.spans_snapshot():
            if span.name == "mesh-dispatch" and span.attrs.get("node"):
                # the LAST mesh-dispatch is the attempt that served (or
                # terminally failed) the stream; earlier ones rerouted
                node_id = span.attrs["node"]
        events = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                   "args": {"name": f"sonata-mesh router "
                                    f"({self.router.name})"}}]
        events.extend(trace.chrome_events(tid=1, pid=1))
        stitched = {"request_id": request_id, "node": node_id,
                    "wall_offset_s": 0.0, "node_spans": 0}
        node_doc, err = self._fetch_node_trace(node_id, request_id)
        if node_doc is not None:
            offset = self._wall_offset_for(node_id)
            stitched["wall_offset_s"] = round(offset, 6)
            node_events = tracing.chrome_events_from_dict(
                node_doc, pid=2, tid=1, wall_offset_s=offset)
            stitched["node_spans"] = sum(
                1 for e in node_events if e.get("ph") == "X")
            events.append({"ph": "M", "pid": 2, "tid": 0,
                           "name": "process_name",
                           "args": {"name": f"node {node_id}"}})
            events.extend(node_events)
        elif err:
            stitched["node_error"] = err
        return 200, {"traceEvents": events, "displayTimeUnit": "ms",
                     "stitched": stitched}

    def _wall_offset_for(self, node_id: Optional[str]) -> float:
        with self._lock:
            for ns in self._nodes.values():
                if ns.node_id == node_id:
                    return ns.wall_offset_s
        return 0.0

    def _fetch_node_trace(self, node_id: Optional[str],
                          request_id: str) -> tuple:
        """(trace dict or None, error string or None)."""
        if node_id is None:
            return None, "router trace has no mesh-dispatch span"
        node = next((n for n in self.router.nodes
                     if n.node_id == node_id
                     or n.spec.addr == node_id), None)
        if node is None or node.spec.metrics_base is None:
            return None, (f"node {node_id!r} has no scrapeable "
                          "metrics plane")
        url = (node.spec.metrics_base + "/debug/traces?id="
               + urllib.parse.quote(request_id))
        try:
            code, body = self._fetch(url, self._probe_timeout_s)
            if code != 200:
                return None, f"node trace fetch answered {code}"
            traces = json.loads(body).get("traces") or []
        except Exception as e:
            return None, f"node trace fetch failed: {e}"
        if not traces:
            return None, (f"node {node_id} holds no trace for id "
                          f"{request_id!r}")
        return traces[0], None

    # -- fleet flight recorder -------------------------------------------------
    def tick(self) -> dict:
        """One 1 Hz fleet snapshot (the recorder thread calls this;
        tests call it directly).  Auto-dump triggers — node eviction,
        breaker trip, fleet fast-burn breach — are edge-detected here
        so they cost nothing anywhere else."""
        view = self.router.snapshot()
        snap: dict = {"ts": round(time.time(), 3),
                      "routable": view["routable"],
                      "nodes_reporting": self.nodes_reporting(),
                      "rerouted": view["stats"].get("rerouted", 0),
                      "failed": view["stats"].get("failed", 0)}
        nodes: dict = {}
        routable_idx = set()
        for nv in view["nodes"]:
            nodes[nv["node_id"]] = {
                "state": nv["state"], "draining": nv["draining"],
                "ready": nv["ready"],
                "outstanding": nv["outstanding"],
                "scope_stale": nv["scope_stale"],
                "scrape_age_s": nv["scope_scrape_age_s"]}
            if (nv["state"] != "open" and nv["ready"]
                    and not nv["draining"] and not nv["scope_stale"]):
                routable_idx.add(nv["index"])
        snap["nodes"] = nodes
        breach = False
        for spec in self.slos:
            burn = self.fleet_burn_rate(spec.name, FAST_WINDOW[0])
            if burn is None:
                continue
            snap[f"burn:{spec.name}"] = round(burn, 3)
            if burn > 1.0:
                breach = True
        snap["fleet_burn_breach"] = 1 if breach else 0
        with self._timeline_lock:
            self._timeline.append(snap)
        # edge-detected incident dumps (per-reason rate-limited)
        evicted = (self._last_routable_idx is not None
                   and bool(self._last_routable_idx
                            - frozenset(routable_idx)))
        self._last_routable_idx = frozenset(routable_idx)
        opens = view["stats"].get("breaker_opens", 0)
        tripped = opens > self._last_breaker_opens
        self._last_breaker_opens = opens
        burn_crossed = breach and not self._last_burn_breach
        self._last_burn_breach = breach
        if evicted:
            self.dump("node-evicted")
        if tripped:
            self.dump("breaker-trip")
        if burn_crossed:
            self.dump("fleet-burn")
        return snap

    def timeline_snapshot(self) -> list:
        with self._timeline_lock:
            return list(self._timeline)

    def dump(self, reason: str) -> Optional[str]:
        """Write the fleet timeline ring to ``dump_dir`` (no-op when
        unset), at most once per ``DUMP_MIN_INTERVAL_S`` per reason —
        the rate-limit contract, so a flapping breaker cannot
        starve a burn incident of its dump."""
        if not self.dump_dir:
            return None
        now = self._clock()
        with self._timeline_lock:
            last = self._last_dump_at.get(reason)
            if last is not None and now - last < DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump_at[reason] = now
            snapshots = list(self._timeline)
        path = os.path.join(
            self.dump_dir, f"fleet-{int(time.time())}-{reason}.json")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"reason": reason, "wall_time": time.time(),
                           "interval_s": self.tick_interval_s,
                           "snapshots": snapshots}, f)
        except OSError:
            log.exception("fleet recorder dump to %s failed", path)
            return None
        self.dumps.append(path)
        log.warning("fleet recorder dumped %d snapshot(s) to %s (%s)",
                    len(snapshots), path, reason)
        return path

    # -- metrics export --------------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Attach the fleet gauge families (loop-registered literal
        tables, the scope idiom).  The fixed-label families bind now;
        node_id-labeled series appear lazily at first ingest (the
        node's stable id is only known once its export is scraped) and
        are torn down exactly by :meth:`unregister_node_series`."""
        self._registry = registry
        families = {}
        for name, help in FLEET_GAUGE_FAMILIES:
            families[name] = registry.gauge(name, help)
        quant = families["sonata_fleet_stage_quantile"]
        for stage in STAGES:
            for wlabel, _s, _n in WINDOWS:
                for qlabel, q in QUANTILES:
                    quant.labels(
                        stage=stage, q=qlabel, window=wlabel
                    ).set_function(
                        lambda s=stage, qq=q, w=wlabel:
                        self.fleet_quantile(s, qq, w))
        burn = families["sonata_fleet_slo_burn_rate"]
        for spec in self.slos:
            for wlabel in (FAST_WINDOW[0], SLOW_WINDOW[0]):
                burn.labels(slo=spec.name, window=wlabel).set_function(
                    lambda n=spec.name, w=wlabel:
                    self.fleet_burn_rate(n, w))
        families["sonata_fleet_nodes_reporting"].set_function(
            lambda: float(self.nodes_reporting()))
        for name, help in FLEET_NODE_GAUGE_FAMILIES:
            self._node_families[name] = registry.gauge(name, help)

    def _ensure_node_series(self, node) -> None:
        """Create (or re-key, if a scrape taught us a new node_id) the
        node_id-labeled series for ``node``; every created series is
        recorded so teardown removes exactly what was registered."""
        if self._registry is None:
            return
        with self._series_lock:
            current = self._node_series_ids.get(node.index)
            if current == node.node_id:
                return
            if current is not None:
                kept = []
                for idx, metric, labels in self._node_series:
                    if idx == node.index:
                        metric.remove(**labels)
                    else:
                        kept.append((idx, metric, labels))
                self._node_series = kept
            nid = node.node_id
            age = self._node_families.get(
                "sonata_mesh_node_scrape_age_seconds")
            if age is not None:
                labels = {"node_id": nid}
                age.labels(**labels).set_function(
                    lambda n=node: self.router.scope_scrape_age_s(n))
                self._node_series.append((node.index, age, labels))
            delta = self._node_families.get("sonata_fleet_node_delta")
            if delta is not None:
                for stage in STAGES:
                    labels = {"node_id": nid, "stage": stage}
                    delta.labels(**labels).set_function(
                        lambda n=node, s=stage: self.node_delta(n, s))
                    self._node_series.append((node.index, delta, labels))
            self._node_series_ids[node.index] = nid

    def unregister_node_series(self) -> None:
        """Drop every node_id-labeled series created at ingest (the
        teardown twin of the lazy registration in
        :meth:`_ensure_node_series`)."""
        with self._series_lock:
            for _idx, metric, labels in self._node_series:
                metric.remove(**labels)
            self._node_series = []
            self._node_series_ids = {}


def _round6(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)
