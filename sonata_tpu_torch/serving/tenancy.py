"""sonata-tenancy: multi-tenant admission, weighted-fair QoS, and
per-tenant accounting across node and fleet.

The serving stack federates routing (sonata-mesh), observability
(sonata-fleetscope), voice placement (sonata-placement), and the
synthesis cache (sonata-synthcache/fleetcache) — but until this module
the admission plane treated all traffic as one anonymous stream: one
tenant's burst deepened EVERY tenant's queue wait.  This module is the
tenant control plane:

- **Identity.**  Requests carry ``x-tenant-id`` metadata (unlabeled
  traffic lands in the ``default`` tenant — wire-compatible: no proto
  change, no client change).  Unknown tenant ids also land in
  ``default`` so a client-controlled header can never mint unbounded
  metric label cardinality.
- **Config.**  ``SONATA_TENANTS`` (inline JSON if the value starts
  with ``{``, else a file path) maps tenant name → ``{weight, qps,
  burst, cache_share, shed_priority}``.  The table is hot-reloadable:
  the plane re-stats the file (or re-reads the env value) at most every
  ``SONATA_TENANTS_RELOAD_S`` seconds and swaps the table in place —
  no restart, buckets of unchanged tenants keep their fill.  Unset ⇒
  :func:`from_env` returns None and every request path is byte-for-byte
  the pre-tenancy shape (pinned by tests/test_tenancy.py).
- **Quota.**  Per-tenant token buckets (``qps`` refill, ``burst``
  capacity, 0 = unlimited) charged at the node frontend AFTER the
  synthesis-cache probe — a cache hit costs no device time and must not
  burn quota.  A refusal is typed RESOURCE_EXHAUSTED with a
  ``retry-after-s`` trailer, computed from the bucket's actual deficit.
- **Weighted fairness.**  :class:`FairGate` — deficit round robin (DRR)
  over per-tenant FIFOs — gates stream entry into the synthesis engine.
  Below saturation every stream enters immediately (zero added latency);
  at saturation each tenant queues in ITS OWN FIFO and grants are dealt
  in weight proportion, so a bursting tenant deepens only its own queue.
- **Shed ladder rung.**  Under degradation (the ladder), the
  over-quota / lowest-priority tenant is shed FIRST (typed, counted via
  ``sonata_tenant_shed_total``) before any fleet-wide shed: at level >= 1
  background tenants (``shed_priority`` > 0) shed; at level >= 2 any
  tenant whose bucket is empty sheds.
- **Router tier.**  When fleet-deployed the mesh router runs its own
  plane (one tenant, N backends — quota state belongs where the fleet
  view is), charges quota at ``_routed_stream``, and stamps
  ``x-sonata-tenant`` + ``x-sonata-tenant-quota: router`` on the
  backend hop so nodes skip double-charging (router wins; per-node
  buckets are the router-absent fallback).  The router's config table
  propagates to node planes as desired state — a revisioned document
  POSTed to each node's ``/debug/tenants`` riding the prober threads
  (:class:`ConfigPropagator`, the placement registry's pattern: the
  router re-pushes until the node acks the revision, so a restarted
  node converges with zero operator action).
- **Failure posture.**  The ``tenancy.classify`` failpoint wraps
  identity extraction: an injected (or real) classification error
  degrades the request to the ``default`` tenant — served, counted
  (``sonata_tenancy_classify_errors_total``), never refused.

Tenancy deliberately does NOT join the synthesis-cache key: identical
text across tenants still dedups to one entry (and fleetcache affinity
keys are unchanged).  What IS per-tenant in the cache is the *insert
budget*: see ``SynthCache`` owner accounting (``cache_share``).

Nothing here imports gRPC or jax.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque, namedtuple
from typing import Callable, Dict, Optional

from . import faults

log = logging.getLogger("sonata.serving")

TENANTS_ENV = "SONATA_TENANTS"
RELOAD_S_ENV = "SONATA_TENANTS_RELOAD_S"

#: the client-facing identity header (wire-compatible: plain metadata)
TENANT_HEADER = "x-tenant-id"
#: the router→node hop headers: the router's classification and the
#: marker that quota was already charged at the router tier
ROUTER_TENANT_HEADER = "x-sonata-tenant"
ROUTER_ENFORCED_HEADER = "x-sonata-tenant-quota"
ROUTER_ENFORCED_VALUE = "router"
#: the typed-refusal trailer carrying the bucket's actual deficit
RETRY_AFTER_TRAILER = "retry-after-s"

DEFAULT_TENANT = "default"
DEFAULT_RELOAD_S = 2.0

#: tenant-labeled counter families, registered table-driven in
#: :meth:`TenantPlane.bind_metrics` (the sonata-lint metricsdoc pass
#: resolves loop-registered literal tables); series are created lazily
#: per tenant and torn down exactly by :meth:`TenantPlane.
#: unregister_tenant_series` (the fleetscope idiom)
TENANT_COUNTER_FAMILIES = (
    ("sonata_tenant_admitted_total",
     "Requests admitted past node admission, by tenant (cache hits "
     "included — admission is cheaper than synthesis, quota is not "
     "charged for hits)."),
    ("sonata_tenant_quota_rejections_total",
     "Requests refused RESOURCE_EXHAUSTED by the tenant's token "
     "bucket (retry-after-s trailer carries the bucket deficit)."),
    ("sonata_tenant_shed_total",
     "Requests shed by the per-tenant degradation rung (the noisy / "
     "background tenant sheds before any fleet-wide shed)."),
)
TENANT_GAUGE_FAMILIES = (
    ("sonata_tenant_queue_depth",
     "Streams waiting in the tenant's own weighted-fair FIFO for a "
     "synthesis slot (a bursting tenant deepens only its own queue)."),
)

#: one classified request identity: the tenant name plus whether the
#: mesh router already charged quota for this hop (node buckets then
#: skip the charge — router wins, per-node is the fallback)
TenantIdentity = namedtuple("TenantIdentity", "name router_enforced")


def resolve_reload_s() -> float:
    """``SONATA_TENANTS_RELOAD_S`` (the one default-defining read): the
    minimum seconds between hot-reload checks of the tenant table."""
    raw = os.environ.get(RELOAD_S_ENV, "").strip()
    if not raw:
        return DEFAULT_RELOAD_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.warning("ignoring non-numeric %s=%r", RELOAD_S_ENV, raw)
        return DEFAULT_RELOAD_S


class TenantConfig:
    """One tenant's policy row (parsed, validated, clamped)."""

    __slots__ = ("name", "weight", "qps", "burst", "cache_share",
                 "shed_priority")

    def __init__(self, name: str, *, weight: float = 1.0,
                 qps: float = 0.0, burst: Optional[float] = None,
                 cache_share: float = 0.0, shed_priority: int = 0):
        self.name = str(name)
        self.weight = max(0.1, float(weight))
        self.qps = max(0.0, float(qps))
        #: bucket capacity; defaults to one second of refill (>= 1) so
        #: "qps: 2" alone means what an operator expects
        self.burst = (max(1.0, self.qps) if burst is None
                      else max(1.0, float(burst)))
        self.cache_share = min(1.0, max(0.0, float(cache_share)))
        self.shed_priority = int(shed_priority)

    def to_dict(self) -> dict:
        return {"weight": self.weight, "qps": self.qps,
                "burst": self.burst, "cache_share": self.cache_share,
                "shed_priority": self.shed_priority}

    def policy_key(self) -> tuple:
        return (self.weight, self.qps, self.burst, self.cache_share,
                self.shed_priority)


def parse_tenants(doc: dict) -> Dict[str, TenantConfig]:
    """``{"tenants": {name: {...}}}`` (or a bare name→row mapping) →
    validated config table.  The ``default`` tenant always exists —
    synthesized unlimited/weight-1 when not configured — because
    unlabeled and unknown-tenant traffic must always have a home."""
    rows = doc.get("tenants", doc) if isinstance(doc, dict) else None
    if not isinstance(rows, dict):
        raise ValueError("tenant config must be a JSON object "
                         '({"tenants": {name: {...}}})')
    table: Dict[str, TenantConfig] = {}
    for name, row in rows.items():
        if name in ("tenants", "revision") and not isinstance(row, dict):
            continue
        if not isinstance(row, dict):
            raise ValueError(f"tenant {name!r}: config row must be an "
                             "object")
        known = {"weight", "qps", "burst", "cache_share",
                 "shed_priority"}
        bad = sorted(set(row) - known)
        if bad:
            raise ValueError(f"tenant {name!r}: unknown field(s) "
                             f"{', '.join(bad)}")
        table[str(name)] = TenantConfig(str(name), **row)
    if DEFAULT_TENANT not in table:
        table[DEFAULT_TENANT] = TenantConfig(DEFAULT_TENANT)
    return table


def tenant_from_metadata(metadata) -> Optional[str]:
    """The raw ``x-tenant-id`` value from invocation metadata, or None
    (mirrors ``tracing.request_id_from_metadata``)."""
    for key, value in metadata or ():
        if str(key).lower() == TENANT_HEADER:
            return str(value)
    return None


def _metadata_value(metadata, header: str) -> Optional[str]:
    for key, value in metadata or ():
        if str(key).lower() == header:
            return str(value)
    return None


class TokenBucket:
    """One tenant's quota bucket: ``qps`` tokens/s refill into a
    ``burst``-deep bucket.  Deterministic under an injected clock (the
    test seam); a zero-qps bucket is unlimited."""

    __slots__ = ("qps", "burst", "_tokens", "_last", "_clock", "_lock")

    def __init__(self, qps: float, burst: float, clock=None):
        self.qps = float(qps)
        self.burst = float(burst)
        self._tokens = self.burst
        self._clock = clock if clock is not None else time.monotonic
        self._last = self._clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0):
        """Charge ``n`` tokens.  Returns ``(True, 0.0)`` on success or
        ``(False, retry_after_s)`` — the seconds until the deficit
        refills, the honest number a client should back off by."""
        if self.qps <= 0:
            return True, 0.0
        with self._lock:
            now = self._clock()
            elapsed = max(0.0, now - self._last)
            self._last = now
            self._tokens = min(self.burst, self._tokens + elapsed * self.qps)
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.qps

    def empty(self) -> bool:
        """True when a charge would be refused right now (the shed
        rung's over-quota signal) — read-only, no token movement."""
        if self.qps <= 0:
            return False
        with self._lock:
            now = self._clock()
            tokens = min(self.burst,
                         self._tokens + max(0.0, now - self._last) * self.qps)
            return tokens < 1.0

    def view(self) -> dict:
        with self._lock:
            return {"qps": self.qps, "burst": self.burst,
                    "tokens": round(self._tokens, 3)}


class _Waiter:
    __slots__ = ("event", "granted")

    def __init__(self):
        self.event = threading.Event()
        self.granted = False


class FairGate:
    """Deficit-round-robin stream admission over per-tenant FIFOs.

    ``slots`` concurrent synthesis streams run; below saturation entry
    is immediate (and costs one lock acquisition).  At saturation each
    arriving stream parks in its tenant's own FIFO; every released slot
    is re-dealt by DRR — each pick adds ``weight/max_weight`` to the
    tenant's deficit and a full deficit buys one grant — so admitted
    work converges to weight proportion (2:1 weights → ~2:1 grants,
    pinned by tests/test_tenancy.py) and one tenant's burst can only
    deepen that tenant's queue.  A tenant whose queue drains loses its
    deficit (standard DRR: no banking idle credit).

    Total queued work is bounded upstream by the admission controller's
    capacity, so the per-tenant FIFOs need no cap of their own.
    """

    def __init__(self, weight_of: Callable[[str], float], slots: int):
        self.slots = max(1, int(slots))
        self._weight_of = weight_of
        self._lock = threading.Lock()
        self._active = 0
        #: tenant -> FIFO of parked waiters (insertion order = the DRR
        #: ring's rotation order for newly-active tenants)
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._running: Dict[str, int] = {}
        self._grants: Dict[str, int] = {}
        self._rr: deque = deque()  # tenant rotation ring

    # -- entry/exit ----------------------------------------------------------
    def enter(self, tenant: str, timeout_s: Optional[float] = None) -> bool:
        """Take one synthesis slot for ``tenant`` (blocking fairly when
        saturated).  False = the wait timed out — the stream never ran,
        do not call :meth:`leave`."""
        with self._lock:
            if self._active < self.slots and not self._any_queued_locked():
                self._grant_locked(tenant)
                return True
            waiter = _Waiter()
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._rr.append(tenant)
            q.append(waiter)
        if waiter.event.wait(timeout_s):
            return True
        with self._lock:
            if waiter.granted:
                # the grant raced the timeout: the slot is ours after all
                return True
            try:
                self._queues[tenant].remove(waiter)
            except (KeyError, ValueError):
                pass
            return False

    def leave(self, tenant: str) -> None:
        """Release the slot taken by :meth:`enter` and deal freed slots
        to parked waiters by DRR."""
        with self._lock:
            self._active = max(0, self._active - 1)
            n = self._running.get(tenant, 0)
            if n <= 1:
                self._running.pop(tenant, None)
            else:
                self._running[tenant] = n - 1
            self._deal_locked()

    # -- DRR core (all under self._lock) -------------------------------------
    def _grant_locked(self, tenant: str) -> None:
        self._active += 1
        self._running[tenant] = self._running.get(tenant, 0) + 1
        self._grants[tenant] = self._grants.get(tenant, 0) + 1

    def _any_queued_locked(self) -> bool:
        return any(self._queues.values())

    def _deal_locked(self) -> None:
        while self._active < self.slots:
            waiter, tenant = self._pick_locked()
            if waiter is None:
                break
            self._grant_locked(tenant)
            waiter.granted = True
            waiter.event.set()

    def _pick_locked(self):
        busy = [t for t, q in self._queues.items() if q]
        if not busy:
            # nobody parked: reset deficits so idle tenants bank nothing
            self._deficit.clear()
            return None, None
        wmax = max(self._weight_of(t) for t in busy) or 1.0
        # each ring pass adds >= 0.1/wmax to someone's deficit, so the
        # guard is generous slack, not a correctness bound
        for _ in range(64 * len(self._rr) + 64):
            if not self._rr:
                return None, None
            tenant = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(tenant)
            if q is None or not q:
                self._deficit.pop(tenant, None)
                continue
            credit = self._deficit.get(tenant, 0.0) + (
                self._weight_of(tenant) / wmax)
            if credit >= 1.0:
                self._deficit[tenant] = credit - 1.0
                return q.popleft(), tenant
            self._deficit[tenant] = credit
        return None, None

    # -- observability --------------------------------------------------------
    def queue_depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(tenant)
            return len(q) if q else 0

    def grants(self, tenant: str) -> int:
        with self._lock:
            return self._grants.get(tenant, 0)

    def active_mix(self) -> Dict[str, int]:
        """tenant → running synthesis streams (the padding-waste
        chargeback pro-ration the scope plane consumes)."""
        with self._lock:
            return dict(self._running)

    def view(self) -> dict:
        with self._lock:
            return {"slots": self.slots, "active": self._active,
                    "queued": {t: len(q) for t, q in self._queues.items()
                               if q},
                    "running": dict(self._running)}


class TenantPlane:
    """The per-process tenant control plane: config table + hot reload,
    classification, token buckets, the fair gate (node processes), the
    shed rung, per-tenant counters, and the desired-state apply surface
    the mesh router pushes to.  Built by :func:`from_env`; absent
    (None) when ``SONATA_TENANTS`` is unset — every hook then costs one
    ``is None`` branch and the request path is byte-for-byte pre-PR."""

    def __init__(self, source: str, *, fair_slots: Optional[int] = None,
                 clock=None):
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.RLock()
        self._source = source
        #: None source: an empty table (default tenant only) with no
        #: file/env reloads — the push-only shape tests construct
        self._source_is_path = (source is not None
                                and not source.lstrip().startswith("{"))
        self._reload_s = resolve_reload_s()
        self._last_reload_check = self._clock()
        self._mtime = self._stat_source()
        self.revision = 1
        #: >0 once the mesh router pushed a table: the router is then
        #: authoritative and local file reloads stop (desired state)
        self.remote_revision = 0
        self._tenants = self._parse_source(source)
        self._buckets: Dict[str, TokenBucket] = {}
        self._stats: Dict[str, Dict[str, int]] = {}
        self._classify_errors = 0
        self.fair = (FairGate(self.weight_of, fair_slots)
                     if fair_slots is not None else None)
        # metrics plumbing (bind_metrics / lazy per-tenant series)
        self._registry = None
        self._families: Dict[str, object] = {}
        self._series: Dict[str, list] = {}

    # -- config source --------------------------------------------------------
    def _stat_source(self):
        if not self._source_is_path:
            return None
        try:
            st = os.stat(self._source)
            return (st.st_mtime, st.st_size)
        except OSError:
            return None

    def _parse_source(self, source) -> Dict[str, TenantConfig]:
        if source is None:
            return parse_tenants({})
        if source.lstrip().startswith("{"):
            return parse_tenants(json.loads(source))
        with open(source, "r", encoding="utf-8") as f:
            return parse_tenants(json.load(f))

    def maybe_reload(self) -> bool:
        """Hot-reload check, rate-limited to ``SONATA_TENANTS_RELOAD_S``
        and disabled once a router push took ownership.  A parse error
        keeps the old table (a fat-fingered edit must not drop quota
        enforcement mid-incident).  Returns True when a new table
        swapped in."""
        with self._lock:
            if self.remote_revision > 0:
                return False
            now = self._clock()
            if now - self._last_reload_check < self._reload_s:
                return False
            self._last_reload_check = now
            if self._source_is_path:
                mtime = self._stat_source()
                if mtime is None or mtime == self._mtime:
                    return False
                self._mtime = mtime
                source = self._source
            else:
                source = os.environ.get(TENANTS_ENV, "").strip()
                if not source or source == self._source:
                    return False
                self._source = source
        # parse outside the lock (file I/O must not stall classify/
        # charge on the request path); concurrent reloaders both parse,
        # the swap below is last-writer-wins on the same source
        try:
            table = self._parse_source(source)
        except (OSError, ValueError) as e:
            log.warning("tenant-table reload failed (%s); keeping "
                        "revision %d", e, self.revision)
            return False
        with self._lock:
            if self.remote_revision > 0:
                return False  # a router push raced the parse: it wins
            self._swap_locked(table)
            log.info("tenant table hot-reloaded: revision %d, %d "
                     "tenant(s)", self.revision, len(self._tenants))
            return True

    def apply_remote(self, doc: dict) -> bool:
        """Desired-state apply from the mesh router (``POST
        /debug/tenants``): ``{"revision": N, "tenants": {...}}``.
        Applies only when ``N`` advances past the last applied remote
        revision — re-pushes are idempotent, stale pushes are refused —
        and takes ownership from local reloads."""
        revision = doc.get("revision")
        if not isinstance(revision, int) or revision <= 0:
            raise ValueError("remote tenant config needs a positive "
                             "integer revision")
        table = parse_tenants(doc)
        with self._lock:
            if revision <= self.remote_revision:
                return False
            self.remote_revision = revision
            self._swap_locked(table)
            log.info("tenant table applied from router: remote revision "
                     "%d, %d tenant(s)", revision, len(self._tenants))
            return True

    def _swap_locked(self, table: Dict[str, TenantConfig]) -> None:
        """Swap the config table; buckets whose policy is unchanged keep
        their fill (a reload must not hand every tenant a fresh burst)."""
        for name in list(self._buckets):
            old = self._tenants.get(name)
            new = table.get(name)
            if (old is None or new is None
                    or old.policy_key() != new.policy_key()):
                del self._buckets[name]
        self._tenants = table
        self.revision += 1

    def config_doc(self) -> dict:
        """The propagation payload (router side): the current table
        under this plane's revision."""
        with self._lock:
            return {"revision": self.revision,
                    "tenants": {n: c.to_dict()
                                for n, c in self._tenants.items()}}

    # -- identity -------------------------------------------------------------
    def classify(self, metadata) -> TenantIdentity:
        """Resolve one request's tenant from invocation metadata.

        The ``tenancy.classify`` failpoint wraps the extraction: an
        injected (or real) error degrades to the ``default`` tenant —
        the request is SERVED and counted, never refused on a
        classification failure.  Unknown tenant ids land in ``default``
        too (bounded label cardinality)."""
        try:
            faults.fire("tenancy.classify")
            routed = _metadata_value(metadata, ROUTER_TENANT_HEADER)
            enforced = (_metadata_value(metadata, ROUTER_ENFORCED_HEADER)
                        == ROUTER_ENFORCED_VALUE)
            name = routed if routed is not None else tenant_from_metadata(
                metadata)
            with self._lock:
                if name not in self._tenants:
                    name = DEFAULT_TENANT
            # the router's enforcement marker only counts when it names
            # a tenant this node also knows — a stale marker falls back
            # to local charging, never to a free pass for unknown ids
            return TenantIdentity(name, enforced and routed == name)
        except Exception:
            with self._lock:
                self._classify_errors += 1
            log.debug("tenant classification degraded to %r",
                      DEFAULT_TENANT, exc_info=True)
            return TenantIdentity(DEFAULT_TENANT, False)

    def classify_context(self, context) -> TenantIdentity:
        """:meth:`classify` from a gRPC ServicerContext (the metadata
        fetch rides inside the failpoint's degrade-to-default)."""
        try:
            metadata = context.invocation_metadata()
        except Exception:
            metadata = None
        return self.classify(metadata)

    # -- quota ----------------------------------------------------------------
    def _cfg(self, name: str) -> TenantConfig:
        with self._lock:
            cfg = self._tenants.get(name)
            return cfg if cfg is not None else self._tenants[DEFAULT_TENANT]

    def _bucket(self, name: str) -> Optional[TokenBucket]:
        cfg = self._cfg(name)
        if cfg.qps <= 0:
            return None
        with self._lock:
            bucket = self._buckets.get(name)
            if bucket is None:
                bucket = self._buckets[name] = TokenBucket(
                    cfg.qps, cfg.burst, clock=self._clock)
            return bucket

    def charge(self, identity: TenantIdentity):
        """Token-bucket charge for one SYNTHESIS (cache hits never get
        here).  Returns ``(True, 0.0)`` or ``(False, retry_after_s)``;
        a refusal is counted.  When the mesh router already enforced
        quota for this hop the node charge is skipped — router wins,
        per-node buckets are the fallback."""
        self.maybe_reload()
        if identity.router_enforced:
            return True, 0.0
        bucket = self._bucket(identity.name)
        if bucket is None:
            return True, 0.0
        ok, retry_after = bucket.try_take()
        if not ok:
            self._bump(identity.name, "quota_rejections")
        return ok, retry_after

    # -- shed rung ------------------------------------------------------------
    def shed_rung(self, name: str, level: int) -> bool:
        """The per-tenant rung on the degradation ladder: True when this
        tenant's request should shed BEFORE any fleet-wide rung.  At
        level >= 1 background tenants (``shed_priority`` > 0) shed; at
        level >= 2 any tenant currently over quota (empty bucket) sheds
        too.  The caller counts via :meth:`note_shed` and raises the
        same typed ``Overloaded`` the fleet-wide rung uses."""
        if level < 1:
            return False
        cfg = self._cfg(name)
        if cfg.shed_priority > 0:
            return True
        if level >= 2:
            bucket = self._bucket(name)
            if bucket is not None and bucket.empty():
                return True
        return False

    # -- accounting -----------------------------------------------------------
    def _bump(self, name: str, stat: str) -> None:
        with self._lock:
            stats = self._stats.get(name)
            if stats is None:
                stats = self._stats[name] = {
                    "admitted": 0, "quota_rejections": 0, "shed": 0}
            stats[stat] += 1
        self._ensure_tenant_series(name)

    def note_admitted(self, name: str) -> None:
        self._bump(name, "admitted")

    def note_shed(self, name: str) -> None:
        self._bump(name, "shed")

    def stat(self, name: str, stat: str) -> float:
        with self._lock:
            stats = self._stats.get(name)
            return float(stats[stat]) if stats else 0.0

    @property
    def classify_errors(self) -> int:
        with self._lock:
            return self._classify_errors

    def weight_of(self, name: str) -> float:
        return self._cfg(name).weight

    def cache_share(self, name: Optional[str]) -> Optional[float]:
        """The tenant's fraction of the synthesis-cache byte budget, or
        None (unshared) — the ``SynthCache`` owner-budget resolver."""
        if name is None:
            return None
        share = self._cfg(name).cache_share
        return share if share > 0 else None

    def active_mix(self) -> Dict[str, int]:
        return self.fair.active_mix() if self.fair is not None else {}

    def tenant_names(self) -> list:
        with self._lock:
            return sorted(self._tenants)

    def snapshot(self) -> dict:
        """``GET /debug/tenants``: config + counters + queue state."""
        with self._lock:
            # copy refs under the lock, render views outside it — the
            # bucket/fair views take their own locks and must never
            # nest under the plane lock
            configs = dict(self._tenants)
            stats = {n: dict(s) for n, s in self._stats.items()}
            buckets = dict(self._buckets)
            doc = {"revision": self.revision,
                   "remote_revision": self.remote_revision,
                   "source": ("inline" if not self._source_is_path
                              else self._source),
                   "classify_errors": self._classify_errors}
        doc["tenants"] = {
            name: {**cfg.to_dict(),
                   "counters": stats.get(name, {}),
                   "bucket": (buckets[name].view()
                              if name in buckets else None)}
            for name, cfg in configs.items()}
        if self.fair is not None:
            doc["fair"] = self.fair.view()
            for name, row in doc["tenants"].items():
                row["queue_depth"] = self.fair.queue_depth(name)
        return doc

    # -- metrics --------------------------------------------------------------
    def bind_metrics(self, registry) -> None:
        """Register the tenant families (table-driven) plus the
        classification-degrade counter.  Per-tenant labeled series are
        created lazily on first activity and removed exactly by
        :meth:`unregister_tenant_series` (the fleetscope idiom: a
        labeled series outliving its plane would scrape stale)."""
        self._registry = registry
        for name, help in TENANT_COUNTER_FAMILIES:
            self._families[name] = registry.counter(name, help)
        for name, help in TENANT_GAUGE_FAMILIES:
            self._families[name] = registry.gauge(name, help)
        registry.counter(
            "sonata_tenancy_classify_errors_total",
            "Requests whose tenant classification failed (the "
            "tenancy.classify failpoint or a real extraction error) and "
            "degraded to the default tenant — served, never refused."
        ).set_function(lambda: float(self.classify_errors))
        # configured tenants get their series up front (a dashboard
        # should see zero rows before traffic); unknown-id traffic all
        # lands in `default`, so lazy creation only ever adds tenants a
        # reload introduced
        for name in self.tenant_names():
            self._ensure_tenant_series(name)

    def _ensure_tenant_series(self, tenant: str) -> None:
        if self._registry is None:
            return
        with self._lock:
            if tenant in self._series:
                return
            owned = self._series[tenant] = []
        stats = (("sonata_tenant_admitted_total", "admitted"),
                 ("sonata_tenant_quota_rejections_total",
                  "quota_rejections"),
                 ("sonata_tenant_shed_total", "shed"))
        for family, stat in stats:
            metric = self._families[family]
            labels = {"tenant": tenant}
            metric.labels(**labels).set_function(
                lambda t=tenant, s=stat: self.stat(t, s))
            owned.append((metric, labels))
        depth = self._families["sonata_tenant_queue_depth"]
        labels = {"tenant": tenant}
        depth.labels(**labels).set_function(
            lambda t=tenant: float(self.fair.queue_depth(t))
            if self.fair is not None else 0.0)
        owned.append((depth, labels))

    def unregister_tenant_series(self) -> None:
        with self._lock:
            series, self._series = self._series, {}
        for owned in series.values():
            for metric, labels in owned:
                try:
                    metric.remove(**labels)
                except Exception:
                    pass

    def close(self) -> None:
        self.unregister_tenant_series()


def from_env(*, fair_slots: Optional[int] = None,
             clock=None) -> Optional[TenantPlane]:
    """The runtime's construction gate: a :class:`TenantPlane` when
    ``SONATA_TENANTS`` is set and parses, else None (the default — the
    pre-tenancy request path is then byte-for-byte unchanged, pinned).
    A present-but-broken config logs loudly and stays OFF: a typo must
    not boot a server with surprise quotas."""
    raw = os.environ.get(TENANTS_ENV, "").strip()
    if not raw:
        return None
    try:
        return TenantPlane(raw, fair_slots=fair_slots, clock=clock)
    except (OSError, ValueError) as e:
        log.error("%s=%r did not parse (%s); tenancy stays OFF",
                  TENANTS_ENV, raw, e)
        return None


class ConfigPropagator:
    """Router-side desired-state push of the tenant table to node
    planes (the placement registry's pattern, riding the mesh prober
    threads): each node is POSTed ``/debug/tenants`` whenever its last
    acked revision trails the router's table, on its own cadence, and a
    restarted node (acks reset with its process) converges on the next
    cycle with zero operator action.  A node with tenancy disabled
    answers 404 and is left alone — enabling tenancy is the node
    operator's call, the router only synchronizes tables."""

    def __init__(self, plane: TenantPlane, *, interval_s: float = 5.0,
                 post=None, clock=None):
        from .placement import ProbeCadence

        self.plane = plane
        self._cadence = ProbeCadence(interval_s, clock=clock)
        self._post = post if post is not None else _http_post_json
        self._lock = threading.Lock()
        #: node index -> last revision that node acked
        self._acked: Dict[int, int] = {}
        #: node index -> due cycles skipped since the last push; at
        #: REFRESH_CYCLES the push repeats even when acked — the
        #: anti-entropy floor that re-converges a restarted node (its
        #: process lost the table, the router-side ack did not)
        self._skips: Dict[int, int] = {}
        self.pushes = 0
        self.push_errors = 0

    #: due cycles between forced re-pushes to an acked node (at the
    #: default 5 s cadence: a restarted node is stale for ~2 min worst
    #: case, same order as the placement reconciler's anti-entropy)
    REFRESH_CYCLES = 24

    def on_probe_cycle(self, node) -> None:
        """Mesh prober hook (the attach pattern): converge ``node``'s
        tenant table if due and trailing."""
        if not self._cadence.due(node.index):
            return
        base = node.spec.metrics_base
        if base is None:
            return
        doc = self.plane.config_doc()
        with self._lock:
            if self._acked.get(node.index) == doc["revision"]:
                skips = self._skips.get(node.index, 0) + 1
                if skips < self.REFRESH_CYCLES:
                    self._skips[node.index] = skips
                    return
            self._skips[node.index] = 0
        try:
            reply = self._post(base + "/debug/tenants", doc)
        except Exception as e:
            with self._lock:
                self.push_errors += 1
            log.debug("tenant-config push to node %s failed: %s",
                      node.spec.node_id, e)
            return
        with self._lock:
            self.pushes += 1
            if isinstance(reply, dict) and reply.get("revision"):
                self._acked[node.index] = doc["revision"]

    def forget(self, node) -> None:
        """A node left (or restarted under the same index): drop its
        ack so the next cycle re-pushes."""
        with self._lock:
            self._acked.pop(node.index, None)
            self._skips.pop(node.index, None)

    def view(self) -> dict:
        with self._lock:
            return {"revision": self.plane.revision,
                    "acked": dict(self._acked), "pushes": self.pushes,
                    "push_errors": self.push_errors}


def _http_post_json(url: str, doc: dict, timeout_s: float = 2.0) -> dict:
    """POST one JSON document, JSON reply (the propagation transport —
    same urllib plane the fleet scrape uses, injectable in tests)."""
    import urllib.request

    body = json.dumps(doc).encode("utf-8")
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))
