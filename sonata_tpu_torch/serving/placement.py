"""sonata-placement: self-healing voice placement for the mesh.

The router treats voice state as fire-and-forget: ``LoadVoice`` fans
out to whichever nodes are reachable *at call time*, so a SIGKILLed-and-
restarted backend rejoins membership holding **no voices** and answers
``NOT_FOUND`` for every id the fleet is supposed to serve — the gap
DEPLOY.md documented ("voices belong in node boot config") and the
ROADMAP carried as the fleet-tier leftover.  At millions-of-users scale
voice state must be a *reconciled desired-state control plane*, not a
best-effort broadcast.  This module is that plane, in four pieces:

- **Desired-state registry.**  Every voice op through the router —
  ``LoadVoice`` (config path), ``UnloadVoice``, ``SetSynthesisOptions``
  (the encoded request, replayable verbatim) — is recorded with a
  monotonically increasing revision.  An unload leaves a *tombstone*:
  a stale node rejoining with the voice still resident is retired, and
  no code path can resurrect an unloaded voice (pinned).  Voices the
  registry has never seen (node *boot-config* voices, pre-placement
  fleets) are deliberately left alone — wire compatibility.
- **Placement map.**  Each desired voice is assigned to
  ``SONATA_PLACEMENT_REPLICAS`` nodes (default 0 = every node, the
  fan-out shape), spread by least RAM pressure (estimated
  ``SONATA_PLACEMENT_VOICE_MB`` per placed voice).  Assignment is
  sticky: a healthy placement never moves, and a holder that trips its
  breaker or leaves membership is replaced within one reconcile
  interval — while a voice is *under*-replicated its dead holders stay
  assigned, so a rejoining node gets its voices replayed instead of
  orphan-retired.
- **Anti-entropy reconciler.**  Rides the router's existing per-node
  prober threads (:meth:`PlacementPlane.on_probe_cycle`, the
  fleetscope pattern — a wedged node can only ever stall its own
  reconcile).  Each cycle diffs the node's *actual* loaded-voice set —
  scraped from the ``voices=`` line on ``/readyz``, falling back to the
  ``sonata_voice_loaded{voice}`` gauge — against desired state, and
  replays the difference: missed loads (plus recorded synthesis
  options) to rejoining/restarted nodes, unloads for tombstoned or
  no-longer-placed voices.  The ``mesh.reconcile`` failpoint fires
  inside every cycle; an injected error counts toward *that node's*
  breaker on its own consecutive reconcile-failure counter (separate
  from the probe and route counters, so the 4x-more-frequent probe
  successes cannot launder it) and an injected hang stalls only that
  node's prober thread.
- **RAM-budgeted LRU eviction.**  ``SONATA_PLACEMENT_RAM_BUDGET_MB``
  (0 = off) bounds each node's estimated resident set; over budget, the
  least-recently-routed placed voice is evicted from that node — but
  **never** a voice with in-flight or resident iteration-loop streams
  routed through this router (the per-(node, voice) outstanding count
  guards both the eviction pick and the unload op).  An evicted voice
  is re-placed onto a node with budget room by the next reconcile.

Routing becomes **voice-aware**: :meth:`MeshRouter.pick(voice=...)` is
restricted to converged holders (nodes whose scraped actual set carries
the voice; nodes with an unknown actual set — no metrics plane — stay
permissive).  When the registry knows a voice but no holder has
converged yet, the pick raises the typed :class:`VoiceWarming` refusal;
``route_stream`` absorbs it with a bounded router-side wait
(``SONATA_PLACEMENT_WAIT_MS``) so a request racing a placement replay
waits for convergence instead of failing.

Lock order: the router lock is taken *outside* the plane lock
(``pick`` → ``routable_for``/``touch``), so the plane never calls a
router-locking method while holding its own lock — reconcile gathers
its router-side view first, computes under the plane lock, and applies
ops with no lock held.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core import OperationError
from . import faults
from .replicas import OPEN, _env_float, _env_int

log = logging.getLogger("sonata.serving")

PLACEMENT_REPLICAS_ENV = "SONATA_PLACEMENT_REPLICAS"
PLACEMENT_RECONCILE_INTERVAL_ENV = "SONATA_PLACEMENT_RECONCILE_INTERVAL_S"
PLACEMENT_RAM_BUDGET_ENV = "SONATA_PLACEMENT_RAM_BUDGET_MB"
PLACEMENT_VOICE_MB_ENV = "SONATA_PLACEMENT_VOICE_MB"
PLACEMENT_WAIT_ENV = "SONATA_PLACEMENT_WAIT_MS"

#: 0 = place every voice on every node (the fan-out shape, wire
#: compatible: nothing changes until an operator opts into subsets)
DEFAULT_REPLICAS = 0
DEFAULT_RECONCILE_INTERVAL_S = 2.0
#: 0 = no RAM budget, no eviction
DEFAULT_RAM_BUDGET_MB = 0.0
#: per-voice resident-RAM estimate driving spread and the budget
DEFAULT_VOICE_MB = 512.0
#: bounded router-side wait for a warming voice before the typed refusal
DEFAULT_WAIT_MS = 1000.0

#: ops the reconciler replays, the label values of
#: ``sonata_placement_reconcile_ops_total{op=...}``
PLACEMENT_OPS = ("load", "unload", "set_options")
#: label values of ``sonata_placement_evictions_total{reason=...}``:
#: ``ram-budget`` (LRU under the node budget) and ``unplaced`` (the
#: rebalancer dropped a holder — trip replacement or target trim)
PLACEMENT_EVICTION_REASONS = ("ram-budget", "unplaced")

#: fleet-level placement gauge families, loop-registered like the
#: scope's GAUGE_FAMILIES so the sonata-lint metricsdoc pass resolves
#: the names
PLACEMENT_GAUGE_FAMILIES = (
    ("sonata_placement_desired",
     "Nodes assigned to hold this voice by the placement map "
     "(SONATA_PLACEMENT_REPLICAS, default every node), per voice."),
    ("sonata_placement_converged",
     "Assigned nodes whose scraped actual loaded-voice set carries "
     "this voice, per voice; converged == desired is the healthy "
     "steady state."),
)


class VoiceWarming(OperationError):
    """Typed refusal: the registry knows this voice but no routable
    node has converged on holding it yet (a placement replay is in
    flight).  Maps to gRPC UNAVAILABLE with a ``voice-warming`` detail
    — clients retry, exactly like a ``draining`` refusal."""


class ProbeCadence:
    """Per-node cadence gate for work that rides the mesh prober
    threads at a slower interval than the health probe itself.

    The prober calls its plane hooks every ``probe_interval_s``; a
    plane that wants its own (slower) cadence per node gates each call
    through :meth:`due`.  Factored out of this module's reconciler so
    the anti-entropy passes that ride the probers — voice-placement
    reconcile (here) and hot-set cache replication
    (``serving/fleetcache.py``) — share one gating implementation.
    Thread-safe: each prober thread gates its own node, but membership
    churn can interleave indexes."""

    __slots__ = ("interval_s", "_clock", "_lock", "_attempt_at")

    def __init__(self, interval_s: float, clock=None):
        self.interval_s = float(interval_s)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        #: node index -> monotonic stamp of the last gated attempt
        self._attempt_at: Dict[int, float] = {}

    def due(self, index: int) -> bool:
        """True (and stamp the attempt) when ``index``'s cadence has
        elapsed — the first call for a node is always due."""
        now = self._clock()
        with self._lock:
            last = self._attempt_at.get(index)
            if last is None or now - last >= self.interval_s:
                self._attempt_at[index] = now
                return True
            return False


class _DesiredVoice:
    """One voice's desired state: config path to replay loads from,
    the last recorded synthesis-options payload, and revisions."""

    __slots__ = ("voice_id", "config_path", "revision",
                 "options_payload", "options_revision",
                 "restore_tombstone")

    def __init__(self, voice_id: str, config_path: str, revision: int):
        self.voice_id = voice_id
        self.config_path = config_path
        self.revision = revision
        self.options_payload: Optional[bytes] = None
        self.options_revision = 0
        #: tombstone revision this load cleared (if any), so a rolled-
        #: back load (forget_load) can RESTORE it — a LoadVoice that
        #: reached zero nodes must not silently erase an unload
        self.restore_tombstone: Optional[int] = None


class PlacementPlane:
    """Desired-state voice registry + placement map + reconciler over a
    :class:`~sonata_tpu_torch.serving.mesh.MeshRouter` membership.

    Transport-agnostic like the router itself: the three ``apply_*``
    callables (``apply_load(node, config_path)``,
    ``apply_unload(node, voice_id)``,
    ``apply_options(node, payload)``) are supplied by the frontend
    (real gRPC unaries in ``mesh_server``, plain fakes in the tests),
    so every line of registry/placement/reconcile logic is shared.
    """

    def __init__(self, router, *,
                 replicas: Optional[int] = None,
                 reconcile_interval_s: Optional[float] = None,
                 ram_budget_mb: Optional[float] = None,
                 voice_mb: Optional[float] = None,
                 wait_ms: Optional[float] = None,
                 apply_load: Optional[Callable] = None,
                 apply_unload: Optional[Callable] = None,
                 apply_options: Optional[Callable] = None,
                 clock=None):
        self.router = router
        self._clock = clock if clock is not None else time.monotonic
        self.replicas = max(0, (
            replicas if replicas is not None
            else _env_int(PLACEMENT_REPLICAS_ENV, DEFAULT_REPLICAS)))
        self.reconcile_interval_s = max(0.05, (
            reconcile_interval_s if reconcile_interval_s is not None
            else _env_float(PLACEMENT_RECONCILE_INTERVAL_ENV,
                            DEFAULT_RECONCILE_INTERVAL_S)))
        self.ram_budget_mb = (
            ram_budget_mb if ram_budget_mb is not None
            else _env_float(PLACEMENT_RAM_BUDGET_ENV,
                            DEFAULT_RAM_BUDGET_MB))
        self.voice_mb = max(1e-6, (
            voice_mb if voice_mb is not None
            else _env_float(PLACEMENT_VOICE_MB_ENV, DEFAULT_VOICE_MB)))
        self.wait_budget_s = max(0.0, (
            wait_ms if wait_ms is not None
            else _env_float(PLACEMENT_WAIT_ENV, DEFAULT_WAIT_MS))) / 1e3
        self._apply_load = apply_load
        self._apply_unload = apply_unload
        self._apply_options = apply_options

        self._lock = threading.Lock()
        self._revision = 0
        self._desired: Dict[str, _DesiredVoice] = {}
        #: voice_id -> ordered node indexes (the placement map)
        self._assign: Dict[str, List[int]] = {}
        #: voice_id -> revision at which it was unloaded; a tombstoned
        #: voice found resident on a rejoining node is retired, never
        #: resurrected
        self._tombstones: Dict[str, int] = {}
        #: (node index, voice_id) -> options revision replayed there
        self._applied_opts: Dict[tuple, int] = {}
        #: voice_id -> monotonic stamp of the last pick (the LRU clock)
        self._last_used: Dict[str, float] = {}
        #: per-node reconcile cadence riding the prober threads
        self._cadence = ProbeCadence(self.reconcile_interval_s,
                                     clock=self._clock)
        self.stats = {"cycles": 0, "reconcile_failures": 0,
                      "op_failures": 0, "ops_load": 0, "ops_unload": 0,
                      "ops_set_options": 0, "evictions_ram_budget": 0,
                      "evictions_unplaced": 0}

        # metric bookkeeping (lazy per-voice series, exact teardown)
        self._registry = None
        self._families: dict = {}
        self._series_lock = threading.Lock()
        self._voice_series: Dict[str, list] = {}

    # -- desired-state registry ------------------------------------------------
    def record_load(self, voice_id: str, config_path: str) -> bool:
        """Record a LoadVoice as desired state (clearing any tombstone)
        and place the voice.  Returns whether this call *created* the
        entry — a failed synchronous load uses that to
        :meth:`forget_load` instead of leaving ghost desired state."""
        with self._lock:
            self._revision += 1
            dv = self._desired.get(voice_id)
            created = dv is None
            if created:
                dv = _DesiredVoice(voice_id, config_path, self._revision)
                self._desired[voice_id] = dv
                self._last_used.setdefault(voice_id, self._clock())
            else:
                dv.config_path = config_path
                dv.revision = self._revision
            cleared = self._tombstones.pop(voice_id, None)
            if created and cleared is not None:
                dv.restore_tombstone = cleared
            # a fresh explicit load always places — over-budget nodes
            # shed their LRU voice at the next reconcile (hot in, cold
            # out); only reconcile-time RE-placements respect the
            # budget filter, so an evicted cold voice cannot ping-pong
            # back onto a full node
            self._rebalance_locked(new_vid=voice_id)
        self._ensure_voice_series(voice_id)
        return created

    def forget_load(self, voice_id: str) -> None:
        """Roll back a :meth:`record_load` whose op reached no node at
        all (the RPC failed typed) — as if the load was never asked
        for, INCLUDING re-erecting the tombstone it cleared: a failed
        load must not resurrect a previously unloaded voice."""
        with self._lock:
            dv = self._desired.pop(voice_id, None)
            self._assign.pop(voice_id, None)
            self._last_used.pop(voice_id, None)
            if dv is not None and dv.restore_tombstone is not None:
                self._tombstones[voice_id] = dv.restore_tombstone
        self._drop_voice_series(voice_id)

    def forget_unload(self, voice_id: str) -> None:
        """Roll back a :meth:`record_unload` that failed typed having
        found the voice nowhere (a NOT_FOUND on an id neither the
        registry nor any node knows): the tombstone comes back out, so
        a node later boot-loading that id is not silently retired —
        boot-config voices the router never *successfully* operated on
        stay untouched."""
        with self._lock:
            self._tombstones.pop(voice_id, None)

    def record_unload(self, voice_id: str) -> bool:
        """Record an UnloadVoice: drop desired state and leave a
        tombstone, so any node still resident (or rejoining with the
        voice) is retired by reconcile.  Returns whether the voice was
        desired."""
        with self._lock:
            known = voice_id in self._desired
            self._revision += 1
            self._desired.pop(voice_id, None)
            self._assign.pop(voice_id, None)
            self._last_used.pop(voice_id, None)
            self._tombstones[voice_id] = self._revision
            for key in [k for k in self._applied_opts
                        if k[1] == voice_id]:
                self._applied_opts.pop(key, None)
        self._drop_voice_series(voice_id)
        return known

    def record_options(self, voice_id: str, payload: bytes) -> bool:
        """Record a SetSynthesisOptions payload (replayed verbatim to
        every holder, late joiners included).  Returns False when the
        voice is unknown to the registry (boot-config voices keep the
        fan-out path)."""
        with self._lock:
            dv = self._desired.get(voice_id)
            if dv is None:
                return False
            self._revision += 1
            dv.options_payload = payload
            dv.options_revision = self._revision
        return True

    def has_voice(self, voice_id: str) -> bool:
        with self._lock:
            return voice_id in self._desired

    def desired_count(self, voice_id: str) -> int:
        with self._lock:
            return len(self._assign.get(voice_id, ()))

    def converged_count(self, voice_id: str) -> int:
        """Assigned nodes whose scraped actual set carries the voice."""
        with self._lock:
            idxs = set(self._assign.get(voice_id, ()))
        return sum(1 for n in self.router.nodes
                   if n.index in idxs and n.loaded_voices is not None
                   and voice_id in n.loaded_voices)

    def assigned_nodes(self, voice_id: str) -> list:
        with self._lock:
            idxs = set(self._assign.get(voice_id, ()))
        return [n for n in self.router.nodes if n.index in idxs]

    def note_applied(self, node, voice_id: str) -> None:
        """A synchronous (RPC-path) load reached ``node``: stamp the
        current options revision as applied there, so reconcile does
        not re-send options the fan-out just delivered."""
        with self._lock:
            dv = self._desired.get(voice_id)
            if dv is not None and dv.options_payload is not None:
                self._applied_opts[(node.index, voice_id)] = \
                    dv.options_revision

    # -- routing surface (called under the ROUTER lock) ------------------------
    def routable_for(self, voice_id: str) -> Optional[frozenset]:
        """Node indexes a request for ``voice_id`` may route to, or
        None when the registry does not know the voice (unrestricted —
        boot-config voices keep working).  A node with an *unknown*
        actual set (no metrics plane) stays permissive; a node known
        not to hold the voice is excluded."""
        with self._lock:
            if voice_id not in self._desired:
                return None
        return frozenset(
            n.index for n in self.router.nodes
            if n.loaded_voices is None or voice_id in n.loaded_voices)

    def touch(self, voice_id: str) -> None:
        """Stamp the LRU clock: this voice just took a request.
        Registry-unknown ids (boot-config voices, client typos) are
        ignored — they have no placement to keep warm, and recording
        every id a client ever sent would grow the table unboundedly."""
        with self._lock:
            if voice_id in self._desired:
                self._last_used[voice_id] = self._clock()

    # -- placement map ---------------------------------------------------------
    def _eligible(self, node) -> bool:
        # plain attribute reads — never the router lock (see the module
        # docstring's lock-order note)
        return (node.state != OPEN and node.ready and not node.draining
                and not node.scope_stale)

    def _pressure_locked(self, index: int) -> int:
        return sum(1 for a in self._assign.values() if index in a)

    def _fits_budget_locked(self, index: int) -> bool:
        if self.ram_budget_mb <= 0:
            return True
        return ((self._pressure_locked(index) + 1) * self.voice_mb
                <= self.ram_budget_mb)

    def _target_locked(self) -> int:
        n = len(self.router.nodes)
        return n if self.replicas <= 0 else min(self.replicas, n)

    def _rebalance_locked(self, new_vid: Optional[str] = None) -> None:
        """Recompute the placement map against current eligibility.

        Sticky by construction: a healthy placement never moves.  A
        voice below target gains the least-pressured eligible nodes —
        respecting the RAM-budget filter except for ``new_vid`` (a
        fresh explicit load lands regardless; eviction makes room).
        Once target is met by eligible holders, dead entries are
        dropped (counted ``unplaced``) — but while a voice is *under*
        target its ineligible holders stay assigned, so a
        transiently-tripped only-holder gets a replay on rejoin
        instead of an orphan retirement."""
        nodes = self.router.nodes
        by_index = {n.index: n for n in nodes}
        target = self._target_locked()
        for vid in sorted(self._desired,
                          key=lambda v: self._desired[v].revision):
            assign = [i for i in self._assign.get(vid, [])
                      if i in by_index]
            elig = [i for i in assign if self._eligible(by_index[i])]
            inelig = [i for i in assign if i not in elig]
            if len(elig) < target:
                candidates = [n for n in nodes
                              if self._eligible(n)
                              and n.index not in assign
                              and (vid == new_vid
                                   or self._fits_budget_locked(n.index))]
                candidates.sort(key=lambda n: (
                    self._pressure_locked(n.index), n.index))
                for n in candidates[: target - len(elig)]:
                    elig.append(n.index)
                    log.info("placement: voice %s placed on node %s",
                             vid, n.node_id)
            new_assign = elig[:target]
            if len(new_assign) < target:
                # under-replicated: keep dead holders — they may rejoin
                # still holding the voice, and replay beats retirement
                new_assign = new_assign + inelig
            dropped = [i for i in assign if i not in new_assign]
            if dropped:
                self.stats["evictions_unplaced"] += len(dropped)
                log.info(
                    "placement: voice %s no longer placed on node(s) %s",
                    vid, [by_index[i].node_id for i in dropped])
            self._assign[vid] = new_assign

    def _evict_for_budget_locked(self, node, outstanding: dict) -> None:
        """LRU-evict this node's placed voices down to the RAM budget.
        A voice with in-flight (or resident iteration-loop) streams
        routed through this router is never evicted."""
        if self.ram_budget_mb <= 0:
            return
        idx = node.index
        placed = [vid for vid, a in self._assign.items() if idx in a]
        while len(placed) * self.voice_mb > self.ram_budget_mb:
            victims = sorted(
                (vid for vid in placed
                 if outstanding.get(vid, 0) == 0),
                key=lambda v: self._last_used.get(v, 0.0))
            if not victims:
                # every placed voice has live streams: over budget but
                # nothing is safely evictable — retry next cycle
                log.warning(
                    "placement: node %s is over its %g MB budget but "
                    "every placed voice has in-flight streams; "
                    "deferring eviction", node.node_id,
                    self.ram_budget_mb)
                return
            vid = victims[0]
            self._assign[vid] = [i for i in self._assign[vid]
                                 if i != idx]
            placed.remove(vid)
            self.stats["evictions_ram_budget"] += 1
            log.info("placement: node %s evicted voice %s (LRU, RAM "
                     "budget %g MB)", node.node_id, vid,
                     self.ram_budget_mb)

    # -- reconcile (rides the mesh prober threads) -----------------------------
    def on_probe_cycle(self, node) -> None:
        """Called by the router's prober after every health cycle:
        run one reconcile cycle for ``node`` when the (slower)
        reconcile cadence is due."""
        if self._cadence.due(node.index):
            self.run_cycle(node)

    def run_cycle(self, node) -> bool:
        """One guarded reconcile cycle: a raise — the ``mesh.reconcile``
        failpoint, a failed replay op — is counted and charged to *that
        node's* breaker on the dedicated reconcile-failure counter; a
        clean cycle resets only that counter."""
        try:
            self.reconcile_node(node)
            self.router.note_reconcile_success(node)
            return True
        except Exception as e:
            with self._lock:
                self.stats["reconcile_failures"] += 1
            self.router.note_reconcile_failure(
                node, f"{type(e).__name__}: {e}")
            log.warning("placement: reconcile cycle for node %s "
                        "failed: %s", node.node_id, e)
            return False

    def reconcile_node(self, node) -> list:
        """Diff ``node``'s actual loaded-voice set against desired
        state and replay the difference.  Returns the ops applied
        (``(kind, voice_id)`` tuples).  Raises on an injected fault or
        a failed op — callers wanting breaker accounting go through
        :meth:`run_cycle`."""
        faults.fire("mesh.reconcile")
        actual, outstanding = self.router.voice_load_view(node)
        with self._lock:
            self.stats["cycles"] += 1
            if node.state == OPEN or node.draining:
                # unreachable or mid-deploy: nothing to replay — but a
                # node that went OPEN may be a restart in progress, so
                # forget what options we once applied there (replayed
                # on rejoin; the actual-set scrape re-drives loads)
                for key in [k for k in self._applied_opts
                            if k[0] == node.index]:
                    self._applied_opts.pop(key, None)
                return []
            self._rebalance_locked()
            self._evict_for_budget_locked(node, outstanding)
            ops = self._diff_locked(node, actual, outstanding)
        return self._apply(node, ops)

    def _diff_locked(self, node, actual, outstanding: dict) -> list:
        if actual is None:
            # actual set unknown (no metrics plane / pre-placement
            # backend): nothing can be diffed safely — semantics
            return []
        ops = []
        for vid, dv in self._desired.items():
            if node.index not in self._assign.get(vid, ()):
                continue
            if vid not in actual:
                ops.append(("load", vid, dv.config_path,
                            dv.options_payload, dv.options_revision))
            elif (dv.options_payload is not None
                  and self._applied_opts.get((node.index, vid), 0)
                  < dv.options_revision):
                ops.append(("set_options", vid, dv.options_payload,
                            dv.options_revision))
        for vid in sorted(actual):
            retire = vid in self._tombstones
            orphan = (vid in self._desired
                      and node.index not in self._assign.get(vid, ()))
            if not (retire or orphan):
                continue  # unknown to the registry: boot-config voice
            if outstanding.get(vid, 0) > 0:
                continue  # never unload under live streams; next cycle
            ops.append(("unload", vid))
        return ops

    def _apply(self, node, ops: list) -> list:
        applied, failures = [], []
        for op in ops:
            kind, vid = op[0], op[1]
            try:
                if kind == "load":
                    if self._apply_load is None:
                        continue
                    _, _, config_path, opts, opts_rev = op
                    self._apply_load(node, config_path)
                    self.router.note_voice_loaded(node, vid)
                    with self._lock:
                        self.stats["ops_load"] += 1
                    log.info("placement: replayed voice %s onto node "
                             "%s", vid, node.node_id)
                    if opts is not None and self._apply_options is not None:
                        self._apply_options(node, opts)
                        with self._lock:
                            self._applied_opts[(node.index, vid)] = \
                                opts_rev
                            self.stats["ops_set_options"] += 1
                elif kind == "set_options":
                    if self._apply_options is None:
                        continue
                    _, _, opts, opts_rev = op
                    self._apply_options(node, opts)
                    with self._lock:
                        self._applied_opts[(node.index, vid)] = opts_rev
                        self.stats["ops_set_options"] += 1
                elif kind == "unload":
                    if self._apply_unload is None:
                        continue
                    # atomically stop routing the voice here FIRST
                    # (refused if a stream slipped in since the diff
                    # snapshot): the backend's UnloadVoice fails
                    # in-flight streams typed, so the RPC must never
                    # race a stream this router admitted.  A failed
                    # RPC self-heals — the next scrape restores the
                    # actual set and the op is retried.
                    if not self.router.begin_voice_retire(node, vid):
                        continue  # live streams arrived: next cycle
                    self._apply_unload(node, vid)
                    with self._lock:
                        self.stats["ops_unload"] += 1
                    log.info("placement: retired voice %s from node %s",
                             vid, node.node_id)
                applied.append((kind, vid))
            except Exception as e:
                with self._lock:
                    self.stats["op_failures"] += 1
                failures.append(f"{kind} {vid}: {type(e).__name__}: {e}")
        if failures:
            raise OperationError(
                f"placement: {len(failures)} reconcile op(s) failed on "
                f"node {node.node_id}: " + "; ".join(failures))
        return applied

    # -- introspection ---------------------------------------------------------
    def snapshot(self) -> dict:
        nodes = self.router.nodes
        by_index = {n.index: n for n in nodes}
        now = self._clock()
        with self._lock:
            assign = {vid: list(a) for vid, a in self._assign.items()}
            desired = {vid: dv for vid, dv in self._desired.items()}
            tombstones = sorted(self._tombstones)
            last_used = dict(self._last_used)
            stats = dict(self.stats)
        voices = []
        for vid, dv in sorted(desired.items()):
            assigned = [by_index[i].node_id for i in assign.get(vid, ())
                        if i in by_index]
            converged = [
                by_index[i].node_id for i in assign.get(vid, ())
                if i in by_index
                and by_index[i].loaded_voices is not None
                and vid in by_index[i].loaded_voices]
            voices.append({
                "voice_id": vid, "revision": dv.revision,
                "config_path": dv.config_path,
                "options_revision": (dv.options_revision
                                     if dv.options_payload is not None
                                     else None),
                "assigned": assigned, "converged": converged,
                "last_used_age_s": (
                    None if vid not in last_used
                    else round(now - last_used[vid], 3))})
        node_rows = []
        for n in nodes:
            placed = sorted(vid for vid, a in assign.items()
                            if n.index in a)
            node_rows.append({
                "node_id": n.node_id, "index": n.index,
                "placed": placed,
                "est_ram_mb": round(len(placed) * self.voice_mb, 3),
                "actual": (None if n.loaded_voices is None
                           else sorted(n.loaded_voices))})
        return {"replicas": self.replicas or "all",
                "reconcile_interval_s": self.reconcile_interval_s,
                "ram_budget_mb": self.ram_budget_mb,
                "voice_mb": self.voice_mb,
                "stats": stats, "voices": voices,
                "tombstones": tombstones, "nodes": node_rows}

    # -- metrics export --------------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Attach the placement metric families.  Fixed-label counters
        bind now; per-voice gauge series appear lazily at
        :meth:`record_load` and are torn down exactly by
        :meth:`unregister_voice_series` (the fleetscope idiom)."""
        self._registry = registry
        for name, help in PLACEMENT_GAUGE_FAMILIES:
            self._families[name] = registry.gauge(name, help)
        ops = registry.counter(
            "sonata_placement_reconcile_ops_total",
            "Voice ops replayed by the anti-entropy reconciler, by op "
            "(load / unload / set_options).")
        for op in PLACEMENT_OPS:
            ops.labels(op=op).set_function(
                lambda o=op: float(self.stats.get("ops_" + o, 0)))
        ev = registry.counter(
            "sonata_placement_evictions_total",
            "Voice placements removed from a node, by reason "
            "(ram-budget = LRU under SONATA_PLACEMENT_RAM_BUDGET_MB; "
            "unplaced = the rebalancer replaced a dead or excess "
            "holder).")
        for reason in PLACEMENT_EVICTION_REASONS:
            ev.labels(reason=reason).set_function(
                lambda r=reason: float(self.stats.get(
                    "evictions_" + r.replace("-", "_"), 0)))

    def _ensure_voice_series(self, voice_id: str) -> None:
        if self._registry is None:
            return
        with self._series_lock:
            if voice_id in self._voice_series:
                return
            owned = self._voice_series.setdefault(voice_id, [])
            desired = self._families.get("sonata_placement_desired")
            if desired is not None:
                labels = {"voice": voice_id}
                desired.labels(**labels).set_function(
                    lambda v=voice_id: float(self.desired_count(v)))
                owned.append((desired, labels))
            conv = self._families.get("sonata_placement_converged")
            if conv is not None:
                labels = {"voice": voice_id}
                conv.labels(**labels).set_function(
                    lambda v=voice_id: float(self.converged_count(v)))
                owned.append((conv, labels))

    def _drop_voice_series(self, voice_id: str) -> None:
        with self._series_lock:
            for metric, labels in self._voice_series.pop(voice_id, []):
                metric.remove(**labels)

    def unregister_voice_series(self) -> None:
        """Drop every per-voice labeled series created at record_load
        (the teardown twin of the lazy registration)."""
        with self._series_lock:
            for owned in self._voice_series.values():
                for metric, labels in owned:
                    metric.remove(**labels)
            self._voice_series = {}

    def close(self) -> None:
        self.unregister_voice_series()
