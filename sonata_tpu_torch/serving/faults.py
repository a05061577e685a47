"""First-party failpoint injection: named fault sites, armed on demand.

The serving stack's failure machinery (breakers, resubmission, deadline
drops, readiness gates) has so far been proven only by ad-hoc
monkeypatching inside individual tests — nothing can arm a fault against
a *running* server, nothing covers a dispatch that *hangs* rather than
raises, and no two chaos runs ever see the same fault schedule.  This
module is the repo's answer: a registry of **named injection sites**
compiled into the serving hot paths, each a single-branch no-op until an
operator or test arms it.

Sites (the canonical list — the sonata-lint ``failpoints`` pass checks
that every name armed anywhere exists here and that every site is
exercised by at least one test):

- ``dispatch.device_call`` — around ``speak_batch`` inside a device
  dispatch (fired on the dispatch thread, inside the breaker wrapper on
  pool replicas so injected errors count toward the breaker);
- ``scheduler.gather``    — the batch scheduler's worker gather loop;
- ``pool.route``          — replica-pool routing, request side;
- ``phonemize``           — the G2P entry every stream mode funnels through;
- ``warmup``              — the readiness-gating warmup synthesis;
- ``metrics.scrape``      — the ``/metrics`` exposition handler;
- ``mesh.route``          — inside every per-node dispatch attempt of the
  sonata-mesh routing tier (an injected fault counts toward that node's
  breaker exactly like a real one);
- ``mesh.health``         — inside every mesh membership health probe
  (how the chaos lane kills/wedges/partitions a whole node
  deterministically without owning real processes);
- ``mesh.reconcile``      — inside every voice-placement reconcile cycle
  (an injected error counts toward that node's breaker on its own
  consecutive reconcile-failure counter — separate, so probe successes
  cannot launder it; a hang stalls only that node's prober thread);
- ``mesh.cache_affinity`` — inside the mesh router's cache-key
  derivation / affinity pick (``serving/fleetcache.py``): an injected
  error degrades that request to plain least-outstanding routing — a
  broken affinity tier can never fail a request;
- ``cache.lookup``        — inside every synthesis-cache probe
  (``serving/synthcache.py``): an injected error degrades that lookup
  to a normal miss — a broken cache can never fail a request;
- ``ledger.emit``         — inside every request-ledger record finalize
  (``serving/ledger.py``): an injected error degrades that finalize to
  no-record — a broken ledger can never fail a request.

Modes:

- ``error``         — raise :class:`InjectedFault` (an ``OperationError``,
  so frontends map it like any operation failure);
- ``hang``          — block (the wedged-chip simulation: no exception, no
  return) until the site is disarmed or the per-arm ``latency_ms``
  cap expires — the scenario the hung-dispatch watchdog exists for;
- ``slow``          — sleep ``latency_ms`` (default 100), then continue;
- ``corrupt-shape`` — return the action string so shape-aware call sites
  (the dispatch path) drop a row from the device result, breaking the
  results-per-request invariant downstream.

Arming — env at process start, endpoint at runtime, or programmatic:

- ``SONATA_FAILPOINTS=site:mode[:rate[:latency_ms[:max_hits]]]`` (comma
  separated for several sites; read when the registry is first touched);
- ``GET /debug/failpoints?arm=spec`` / ``?disarm=site|all`` on the
  metrics plane (no params = JSON state snapshot);
- :func:`registry` ``.arm(...)`` / ``.disarm(...)`` from tests.

**Determinism.**  Whether hit *n* of a site fires is a pure function of
``(SONATA_FAILPOINT_SEED, site, n, rate)`` — a blake2b draw, not a live
PRNG — so a chaos run replays exactly given the same request order (the
chaos smoke pins two seeds in CI).  ``max_hits`` bounds how many times an
arm fires before it is spent (e.g. hang exactly one dispatch).

**Overhead.**  :func:`fire` is the only hot-path surface; with nothing
armed it reads one module-level bool and returns — the chaos smoke
measures this stays in the noise (same bar as tracing's
``trace_overhead`` row in BENCH_STREAMING_CPU_r09).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, Optional

from ..core import OperationError
from . import tracing

log = logging.getLogger("sonata.serving")

FAILPOINTS_ENV = "SONATA_FAILPOINTS"
SEED_ENV = "SONATA_FAILPOINT_SEED"

#: canonical injection sites; arming any other name is a ValueError (and
#: a sonata-lint ``failpoints`` finding at the call site)
SITES = (
    "dispatch.device_call",
    "scheduler.gather",
    "pool.route",
    "phonemize",
    "warmup",
    "metrics.scrape",
    "mesh.route",
    "mesh.health",
    "mesh.reconcile",
    "mesh.cache_affinity",
    "cache.lookup",
    "tenancy.classify",
    "ledger.emit",
)

MODES = ("error", "hang", "slow", "corrupt-shape")

DEFAULT_SLOW_MS = 100.0
#: a hang with no explicit cap still ends eventually — a leaked
#: quarantined thread must not outlive any plausible test or incident
DEFAULT_HANG_CAP_S = 600.0


class InjectedFault(OperationError):
    """A failpoint fired in ``error`` mode (or a hang hit its cap)."""


class _Arm:
    """One armed site's state (mutated under the registry lock)."""

    __slots__ = ("site", "mode", "rate", "latency_ms", "max_hits",
                 "hits", "fires", "release")

    def __init__(self, site: str, mode: str, rate: float,
                 latency_ms: Optional[float], max_hits: Optional[int]):
        self.site = site
        self.mode = mode
        self.rate = rate
        self.latency_ms = latency_ms
        self.max_hits = max_hits
        self.hits = 0    # decisions evaluated (the deterministic index)
        self.fires = 0   # times the fault actually fired
        #: per-arm hang release: threads blocked in this arm's ``hang``
        #: capture THIS event, so disarming one site frees its waiters
        #: without waking hangs armed at other sites (re-arming builds a
        #: fresh _Arm, so a released old arm cannot leak into the new one)
        self.release = threading.Event()

    def snapshot(self) -> dict:
        return {"mode": self.mode, "rate": self.rate,
                "latency_ms": self.latency_ms, "max_hits": self.max_hits,
                "hits": self.hits, "fires": self.fires,
                "spent": (self.max_hits is not None
                          and self.fires >= self.max_hits)}


def _decide(seed: int, site: str, n: int, rate: float) -> bool:
    """Deterministic fire decision for hit ``n`` of ``site``."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.blake2b(f"{seed}:{site}:{n}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64 < rate


class FailpointRegistry:
    """Armed-site table plus the hang release used to free stuck threads."""

    def __init__(self, seed: Optional[int] = None):
        self._lock = threading.Lock()
        self._arms: Dict[str, _Arm] = {}
        #: lifetime fire counts per site — survive disarm, so the metrics
        #: plane and the chaos smoke can assert on a finished schedule
        self._fires_total: Dict[str, int] = {}
        if seed is None:
            try:
                seed = int(os.environ.get(SEED_ENV, "0"))
            except ValueError:
                seed = 0
        self.seed = seed

    # -- arming ---------------------------------------------------------------
    def arm(self, site: str, mode: str, rate: float = 1.0,
            latency_ms: Optional[float] = None,
            max_hits: Optional[int] = None) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown failpoint site {site!r} (registry: "
                f"{', '.join(SITES)})")
        if mode not in MODES:
            raise ValueError(
                f"unknown failpoint mode {mode!r} (modes: "
                f"{', '.join(MODES)})")
        with self._lock:
            old = self._arms.get(site)
            self._arms[site] = _Arm(site, mode, float(rate), latency_ms,
                                    max_hits)
        if old is not None:
            old.release.set()  # the replaced arm's hangs proceed normally
        self._sync_active()
        log.warning("failpoint armed: %s mode=%s rate=%g latency_ms=%s "
                    "max_hits=%s seed=%d", site, mode, rate, latency_ms,
                    max_hits, self.seed)

    def arm_spec(self, spec: str) -> None:
        """Arm from one ``site:mode[:rate[:latency_ms[:max_hits]]]``."""
        parts = spec.strip().split(":")
        if len(parts) < 2 or len(parts) > 5:
            raise ValueError(
                f"bad failpoint spec {spec!r} "
                "(site:mode[:rate[:latency_ms[:max_hits]]])")
        site, mode = parts[0], parts[1]
        try:
            rate = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
            latency = (float(parts[3])
                       if len(parts) > 3 and parts[3] else None)
            hits = int(parts[4]) if len(parts) > 4 and parts[4] else None
        except ValueError:
            raise ValueError(f"bad failpoint spec {spec!r}: rate/"
                             "latency_ms/max_hits must be numeric") from None
        self.arm(site, mode, rate=rate, latency_ms=latency, max_hits=hits)

    def arm_from_env(self) -> int:
        """Arm every spec in ``SONATA_FAILPOINTS``; returns the count."""
        raw = os.environ.get(FAILPOINTS_ENV, "").strip()
        if not raw:
            return 0
        n = 0
        for spec in raw.split(","):
            if spec.strip():
                self.arm_spec(spec)
                n += 1
        return n

    def disarm(self, site: str) -> None:
        """Disarm one site and release any thread hung at it (threads
        hung at OTHER still-armed sites keep waiting)."""
        with self._lock:
            arm = self._arms.pop(site, None)
        if arm is not None:
            arm.release.set()
        self._sync_active()
        log.warning("failpoint disarmed: %s", site)

    def disarm_all(self) -> None:
        """Disarm every site and release any thread stuck in a hang."""
        with self._lock:
            arms = list(self._arms.values())
            self._arms.clear()
        for arm in arms:
            arm.release.set()  # wake hung threads on the event they captured
        self._sync_active()
        log.warning("failpoints disarmed (all); hung threads released")

    def _sync_active(self) -> None:
        """Refresh the module-level fire() fast-path flag — but only
        when *this* is the process-global registry: a private instance
        (tests build their own) must not flip chaos on or off for the
        whole process."""
        if _registry is self:
            _set_active(bool(self._arms))

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> dict:
        # copy under the lock, render outside it: snapshot() must call
        # nothing while holding _lock (introspection can be called while
        # other subsystems hold their own locks)
        with self._lock:
            arms = dict(self._arms)
            fires = dict(self._fires_total)
        return {"seed": self.seed,
                "armed": {s: a.snapshot() for s, a in arms.items()},
                "fires_total": fires,
                "sites": list(SITES)}

    def fires_total(self, site: str) -> int:
        with self._lock:
            return self._fires_total.get(site, 0)

    # -- firing ---------------------------------------------------------------
    def fire(self, site: str) -> Optional[str]:
        """Evaluate ``site``; act out the armed mode when it fires.

        Returns the action string for modes the *caller* must apply
        (``corrupt-shape``), else None.  All decision state is updated
        under the lock; the act itself (sleep / hang / raise) happens
        outside it.
        """
        with self._lock:
            arm = self._arms.get(site)
            if arm is None:
                return None
            if arm.max_hits is not None and arm.fires >= arm.max_hits:
                return None
            n = arm.hits
            arm.hits += 1
            if not _decide(self.seed, site, n, arm.rate):
                return None
            arm.fires += 1
            self._fires_total[site] = self._fires_total.get(site, 0) + 1
            mode, latency = arm.mode, arm.latency_ms
            release = arm.release
        return self._act(site, mode, latency, release)

    def _act(self, site: str, mode: str, latency_ms: Optional[float],
             release: threading.Event) -> Optional[str]:
        with tracing.span("failpoint", site=site, mode=mode):
            if mode == "error":
                raise InjectedFault(
                    f"injected fault at failpoint {site} (mode=error, "
                    f"seed={self.seed})")
            if mode == "slow":
                time.sleep((latency_ms if latency_ms is not None
                            else DEFAULT_SLOW_MS) / 1e3)
                return None
            if mode == "hang":
                # the wedged-device simulation: block with no exception
                # until this site is disarmed (or re-armed); the cap
                # turns an abandoned hang into a loud error instead of a
                # thread leaked forever
                cap_s = (latency_ms / 1e3 if latency_ms is not None
                         else DEFAULT_HANG_CAP_S)
                if release.wait(timeout=cap_s):
                    return None  # released by disarm: proceed normally
                raise InjectedFault(
                    f"injected hang at failpoint {site} exceeded its "
                    f"{cap_s:g}s cap without being disarmed")
            return mode  # corrupt-shape: caller applies it


# ---------------------------------------------------------------------------
# process-global registry + the single-branch hot-path hook
# ---------------------------------------------------------------------------

#: hot-path fast flag: fire() reads this one bool and returns when
#: nothing is armed anywhere in the process
_ACTIVE = False

_registry: Optional[FailpointRegistry] = None
_registry_lock = threading.Lock()


def _set_active(value: bool) -> None:
    global _ACTIVE
    _ACTIVE = value


def registry() -> FailpointRegistry:
    """The process-wide registry (created on first use; arms any
    ``SONATA_FAILPOINTS`` specs present in the environment)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                reg = FailpointRegistry()
                reg.arm_from_env()   # _sync_active no-ops: not global yet
                _registry = reg
                reg._sync_active()
    return _registry


def fire(site: str) -> Optional[str]:
    """The injection hook call sites compile in: a no-op single branch
    until something is armed."""
    if not _ACTIVE:
        return None
    return registry().fire(site)


def corrupt_result(action: Optional[str], rows):
    """Apply a ``corrupt-shape`` firing to a device result: drop the
    trailing row so the caller's row-count check trips loudly.  The one
    place the corruption contract lives — both dispatch paths (the
    pool's breaker wrapper and the bare-model scheduler) call this."""
    if action == "corrupt-shape":
        return list(rows)[:-1]
    return rows


def fires_total(site: str) -> Optional[float]:
    """Lifetime fire count for a site, or None while no registry exists
    (keeps the metrics series absent until chaos tooling shows up)."""
    reg = _registry
    if reg is None:
        return None
    return float(reg.fires_total(site))


#: programmatic opt-in for the HTTP arming plane (chaos tooling and
#: tests that boot a server without touching the environment)
_HTTP_ARMING = False


def enable_http_arming(value: bool = True) -> None:
    """Opt this process into ``/debug/failpoints`` arm/disarm requests."""
    global _HTTP_ARMING
    _HTTP_ARMING = value


def http_arming_allowed() -> bool:
    """Whether ``/debug/failpoints`` may mutate the registry.  Requires
    an explicit opt-in — ``SONATA_FAILPOINTS`` present in the
    environment (even empty: the operator consciously enabled the chaos
    plane) or :func:`enable_http_arming` — so a production metrics port
    is never a remote fault-injection switch."""
    return _HTTP_ARMING or FAILPOINTS_ENV in os.environ


def warn_if_armed(logger: logging.Logger) -> None:
    """Log the loud chaos banner when ``SONATA_FAILPOINTS`` is set —
    shared by every frontend: a process accidentally started with armed
    failpoints is a production incident waiting to be misdiagnosed.
    Present-but-empty gets its own banner: that form arms nothing but
    still opens the HTTP arming plane (:func:`http_arming_allowed`),
    which must never happen silently."""
    if os.environ.get(FAILPOINTS_ENV):
        logger.warning("failpoints armed from the environment: %s",
                       registry().snapshot()["armed"])
    elif FAILPOINTS_ENV in os.environ:
        logger.warning("SONATA_FAILPOINTS is present (empty): no sites "
                       "armed, but /debug/failpoints arming is ENABLED "
                       "on the metrics port")


# arm at import when the env asks for it: frontends import the serving
# package long before the first request, so env-armed chaos runs never
# depend on which code path first calls fire()
if os.environ.get(FAILPOINTS_ENV, "").strip():
    registry()
