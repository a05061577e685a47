"""Per-request wide-event ledger: one structured record per request.

Every tier of the stack already aggregates — scope keeps stage
quantiles, the fleet plane merges burn rates, tenancy meters tenants —
but aggregates cannot answer the operator's actual question: *which*
tenant's requests breached the SLO at 14:32, on which node, with what
cache and retry history?  The ledger answers it by assembling ONE wide
event per request across its whole path:

* **identity** — request_id, rpc, tenant, voice, node_id;
* **admission outcome** — cache hit / miss / follower, and every typed
  refusal (``node-quota``, ``router-quota``, ``tenant-shed``,
  ``fleet-shed``, ``voice-warming``, ``draining``, ``deadline``,
  ``overload``);
* **cost breakdown** — queue wait, decode iterations, dispatch count,
  padding rows, bytes out, TTFB, total duration (extracted from the
  request's trace spans at finalize, so the scheduler's existing
  attribution is the single source of truth);
* **disposition** — ``ok`` / ``error`` / ``refused`` / ``cancelled``.

Records are finalized exactly once at stream close and fed to a
byte-bounded in-memory ring plus an optional rotating NDJSON sink.
``GET /debug/requests`` serves the ring node-side; the mesh router
merges its hop record with the serving node's record by ``x-request-id``
(the stitched-trace pattern), so one document shows router reroutes
next to node-side cost.

Tail-based sampling: errors, refusals, and SLO-threshold violators are
ALWAYS kept; OK traffic is sampled at ``SONATA_LEDGER_SAMPLE``
(deterministic per request id, so router and node agree on keep/drop
without coordination).  The last-kept request id per incident kind is
exported as the ``sonata_ledger_exemplar`` gauge family, linking a
paging counter directly to the offending record.

Knobs (this module is the only reader):

* ``SONATA_LEDGER_MB`` — ring byte budget in MiB; unset/0/unparseable
  = ledger off, byte-for-byte pre-ledger request paths.
* ``SONATA_LEDGER_SAMPLE`` — OK-traffic keep probability in [0, 1]
  (default 1.0 = keep everything).
* ``SONATA_LEDGER_DIR`` — directory for the NDJSON sink
  (``ledger.ndjson``, rotated once to ``ledger.ndjson.1`` at the byte
  budget); unset = ring only.

Failure posture (the ``cache.lookup`` rule): :meth:`RequestLedger.emit`
wraps the whole finalize — including the ``ledger.emit`` failpoint — in
a degrade-to-no-record guard.  A broken ledger can never fail a
request; it only loses its own record and bumps
``sonata_ledger_emit_errors_total``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from . import faults
from .admission import Overloaded
from .deadlines import DeadlineExceeded
from .drain import Draining
from .scope import DEFAULT_SLO, parse_slos

log = logging.getLogger("sonata.ledger")

LEDGER_MB_ENV = "SONATA_LEDGER_MB"
LEDGER_SAMPLE_ENV = "SONATA_LEDGER_SAMPLE"
LEDGER_DIR_ENV = "SONATA_LEDGER_DIR"

#: record dispositions
OUTCOMES = ("ok", "error", "refused", "cancelled")

#: the typed-refusal vocabulary — every admission-refusal path in the
#: frontends lands in the ledger under exactly one of these
REFUSALS = ("node-quota", "router-quota", "tenant-shed", "fleet-shed",
            "voice-warming", "draining", "deadline", "overload")

#: exemplar incident kinds (gauge label values)
EXEMPLAR_KINDS = ("slo_breach", "refusal", "error")

SINK_NAME = "ledger.ndjson"


def resolve_ledger_mb() -> float:
    """Ring budget in MiB from ``SONATA_LEDGER_MB``; 0.0 = off.

    Unset, empty, unparseable, and negative all resolve to 0.0 — the
    ledger is opt-in and a typo'd knob must not take the server down.
    """
    raw = os.environ.get(LEDGER_MB_ENV, "").strip()
    if not raw:
        return 0.0
    try:
        mb = float(raw)
    except ValueError:
        log.warning("ignoring non-numeric %s=%r (ledger stays off)",
                    LEDGER_MB_ENV, raw)
        return 0.0
    return max(mb, 0.0)


def resolve_sample() -> float:
    """OK-traffic keep probability from ``SONATA_LEDGER_SAMPLE``.

    Default 1.0 (keep all); clamped to [0, 1].  Errors / refusals /
    SLO violators ignore this — tail sampling keeps 100% of them.
    """
    raw = os.environ.get(LEDGER_SAMPLE_ENV, "").strip()
    if not raw:
        return 1.0
    try:
        p = float(raw)
    except ValueError:
        log.warning("ignoring non-numeric %s=%r (sampling everything)",
                    LEDGER_SAMPLE_ENV, raw)
        return 1.0
    return min(max(p, 0.0), 1.0)


def resolve_sink_dir() -> Optional[str]:
    """NDJSON sink directory from ``SONATA_LEDGER_DIR`` (None = ring
    only)."""
    raw = os.environ.get(LEDGER_DIR_ENV, "").strip()
    return raw or None


def from_env() -> Optional["RequestLedger"]:
    """Build a ledger from the environment, or None when off.

    ``SONATA_LEDGER_MB`` unset/0 means *no ledger object at all*: no
    metric families, no per-request branches beyond one ``is None``
    check — the pre-ledger request path byte for byte.
    """
    mb = resolve_ledger_mb()
    if mb <= 0:
        return None
    try:
        slos = parse_slos()
    except ValueError:
        # the scope plane owns failing loudly on a typo'd SONATA_SLO;
        # the ledger only needs thresholds for tail sampling, so it
        # falls back to the defaults rather than double-crashing
        log.warning("malformed SONATA_SLO; ledger tail-sampling uses "
                    "the default SLO set", exc_info=True)
        slos = parse_slos(DEFAULT_SLO)
    return RequestLedger(max_bytes=int(mb * (1 << 20)),
                         sample=resolve_sample(),
                         sink_dir=resolve_sink_dir(),
                         slos=slos)


def refusal_kind(exc: BaseException) -> Optional[str]:
    """Map a typed serving exception to its refusal name (None = not a
    refusal — record it as an error instead).

    Quota/shed refusals are raised as plain :class:`Overloaded` from
    several distinct gates, so frontends pass an explicit ``refusal=``
    at those sites; this fallback covers the unambiguous types.
    """
    if isinstance(exc, Draining):
        return "draining"
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, Overloaded):
        return "overload"
    return None


def cost_fields_from_trace(trace) -> dict:
    """Extract the cost breakdown from a request trace's spans.

    The scheduler already attributes queue wait, dispatch membership,
    and padding rows into every participating trace (the Orca
    question); the ledger re-reads those spans rather than growing a
    second accounting channel.  Returns ``{}`` on any surprise — cost
    fields are best-effort garnish on a record that must always emit.
    """
    if trace is None:
        return {}
    try:
        queue_wait = 0.0
        dispatches = 0
        iterations = 0
        padding_rows = 0
        reroutes = 0
        cache = None
        for sp in trace.spans_snapshot():
            name = sp.name
            if name in ("queue-wait", "admission"):
                d = sp.duration_s
                if d:
                    queue_wait += d
            elif name == "dispatch":
                dispatches += 1
                try:
                    padding_rows += int(sp.attrs.get("padding_rows")
                                        or 0)
                except (TypeError, ValueError):
                    pass
            elif name == "decode-window":
                iterations += 1
            elif name == "cache-hit":
                cache = "hit"
            elif name == "cache-follow" or name == "fleetcache-follow":
                cache = "follow"
            elif name == "mesh-reroute":
                reroutes += 1
        out: dict = {"queue_wait_s": round(queue_wait, 6),
                     "dispatches": dispatches,
                     "padding_rows": padding_rows}
        if iterations:
            out["iterations"] = iterations
        if cache is not None:
            out["cache"] = cache
        if reroutes:
            out["reroutes"] = reroutes
        return out
    except Exception:
        log.debug("cost extraction degraded to no-fields",
                  exc_info=True)
        return {}


class LedgerRecord:
    """One request's in-flight wide event (cheap until finalize).

    ``begin()`` stamps identity and a monotonic start; the frontends
    :meth:`note` fields as they learn them; :meth:`RequestLedger.emit`
    finalizes exactly once (the ``emitted`` latch makes double-finalize
    from nested error paths a no-op).
    """

    __slots__ = ("fields", "t0", "emitted")

    def __init__(self, rpc: str, request_id: str, **fields) -> None:
        self.t0 = time.monotonic()
        self.emitted = False
        self.fields: dict = {"request_id": request_id, "rpc": rpc}
        self.note(**fields)

    def note(self, **fields) -> None:
        """Attach fields (None values are skipped, not recorded)."""
        for key, value in fields.items():
            if value is not None:
                self.fields[key] = value


class RequestLedger:
    """Byte-bounded ring + optional NDJSON sink of wide events."""

    def __init__(self, max_bytes: int, sample: float = 1.0,
                 sink_dir: Optional[str] = None,
                 slos=()) -> None:
        self.max_bytes = int(max_bytes)
        self.sample = float(sample)
        self.node_id: Optional[str] = None
        self._slos = tuple(slos)
        self._lock = threading.Lock()
        # (nbytes, record) pairs, oldest first; evicted oldest-OK-first
        # so a burst of healthy traffic can never push an incident
        # record out of the ring
        self._ring: List[tuple] = []
        self._ring_bytes = 0
        self._outcomes: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self._stats: Dict[str, int] = {
            "sampled_out": 0, "emit_errors": 0, "evictions": 0,
            "sink_rotations": 0}
        # last-kept request id per incident kind, exported as the
        # exemplar gauge (value = finalize wall time)
        self._exemplars: Dict[str, tuple] = {}
        self._exemplar_metric = None
        self._exported_rids: Dict[str, str] = {}
        self._node_fetcher: Optional[Callable] = None
        self._closed = False
        # sink state (its own lock: file IO must not serialize behind
        # ring queries)
        self._sink_lock = threading.Lock()
        self._sink_path: Optional[str] = None
        self._sink_bytes = 0
        if sink_dir:
            try:
                os.makedirs(sink_dir, exist_ok=True)
                self._sink_path = os.path.join(sink_dir, SINK_NAME)
                if os.path.exists(self._sink_path):
                    self._sink_bytes = os.path.getsize(self._sink_path)
            except OSError:
                log.warning("ledger sink dir %r unusable (ring only)",
                            sink_dir, exc_info=True)
                self._sink_path = None

    # -- record lifecycle ---------------------------------------------------

    def begin(self, rpc: str, request_id: str, *,
              voice: Optional[str] = None,
              tenant: Optional[str] = None) -> LedgerRecord:
        """Open a record.  Lock-free and allocation-light: the hot path
        pays one dict until finalize."""
        return LedgerRecord(rpc, request_id, voice=voice, tenant=tenant,
                            node_id=self.node_id)

    def emit(self, record: Optional[LedgerRecord], *,
             outcome: str = "ok", error: Optional[str] = None,
             refusal: Optional[str] = None) -> None:
        """Finalize ``record`` — never raises.

        Any exception (including the ``ledger.emit`` failpoint)
        degrades to no-record: the request already succeeded or failed
        on its own terms, and observability must not change that.
        """
        if record is None or record.emitted or self._closed:
            return
        record.emitted = True
        try:
            faults.fire("ledger.emit")
            if refusal is not None:
                outcome = "refused"
            rec = dict(record.fields)
            rec["outcome"] = outcome
            if error is not None:
                rec["error"] = error
            if refusal is not None:
                rec["refusal"] = refusal
            rec["dur_s"] = round(time.monotonic() - record.t0, 6)
            rec["ts"] = round(time.time(), 3)
            self._ingest(rec)
        except Exception:
            with self._lock:
                self._stats["emit_errors"] += 1
            log.debug("ledger emit degraded to no-record",
                      exc_info=True)

    def _ingest(self, rec: dict) -> None:
        outcome = rec.get("outcome", "ok")
        rid = rec.get("request_id", "")
        violated = self._slo_violations(rec) if outcome == "ok" else []
        if violated:
            rec["slo"] = violated
        # tail sampling: every incident is kept; only clean-and-fast
        # OK traffic rolls the (deterministic) dice
        keep = (outcome != "ok" or bool(violated)
                or self.sample_decision(rid))
        exemplar = None
        if violated:
            exemplar = "slo_breach"
        elif outcome == "refused":
            exemplar = "refusal"
        elif outcome == "error":
            exemplar = "error"
        line = json.dumps(rec, separators=(",", ":"), sort_keys=True,
                          default=str)
        nbytes = len(line) + 1
        with self._lock:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
            if not keep:
                self._stats["sampled_out"] += 1
            else:
                self._ring.append((nbytes, rec))
                self._ring_bytes += nbytes
                while self._ring_bytes > self.max_bytes and self._ring:
                    idx = next(
                        (i for i, (_n, r) in enumerate(self._ring)
                         if r.get("outcome") == "ok"), 0)
                    freed, _dropped = self._ring.pop(idx)
                    self._ring_bytes -= freed
                    self._stats["evictions"] += 1
            if exemplar is not None and keep:
                self._exemplars[exemplar] = (rid, rec["ts"])
        if keep:
            self._export_exemplars()
            self._sink_write(line)

    def _slo_violations(self, rec: dict) -> List[str]:
        """Names of latency SLOs this record breaches (error-rate SLOs
        are population properties — not a per-record question)."""
        violated: List[str] = []
        try:
            for spec in self._slos:
                if getattr(spec, "kind", None) != "latency":
                    continue
                stage = getattr(spec, "stage", None)
                if stage == "ttfb":
                    value = rec.get("ttfb_s")
                elif stage == "e2e":
                    value = rec.get("dur_s")
                else:
                    continue
                threshold = getattr(spec, "threshold_s", None)
                if (value is not None and threshold is not None
                        and value > threshold):
                    violated.append(getattr(spec, "name", stage))
        except Exception:
            log.debug("slo check degraded to no-violations",
                      exc_info=True)
            return []
        return violated

    def sample_decision(self, request_id: str) -> bool:
        """Deterministic keep/drop for OK traffic.

        Hash-derived from the request id so every hop (router, node,
        test) agrees on the same decision without coordination, and so
        tests pin exact capture sets with chosen ids.
        """
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        digest = hashlib.blake2b(request_id.encode("utf-8", "replace"),
                                 digest_size=8).digest()
        unit = int.from_bytes(digest, "big") / float(1 << 64)
        return unit < self.sample

    # -- exemplars ----------------------------------------------------------

    def _export_exemplars(self) -> None:
        """Mirror the last-kept incident ids onto the exemplar gauge.

        One series per kind: the previous request_id's series is
        removed before the new one is set, so the family stays bounded
        at ``len(EXEMPLAR_KINDS)`` series no matter the traffic.
        """
        metric = self._exemplar_metric
        if metric is None:
            return
        with self._lock:
            snapshot = dict(self._exemplars)
        for kind, (rid, ts) in snapshot.items():
            try:
                old = self._exported_rids.get(kind)
                if old is not None and old != rid:
                    metric.remove(kind=kind, request_id=old)
                metric.labels(kind=kind, request_id=rid).set(ts)
                self._exported_rids[kind] = rid
            except Exception:
                log.debug("exemplar export degraded", exc_info=True)

    # -- sink ---------------------------------------------------------------

    def _sink_write(self, line: str) -> None:
        if self._sink_path is None:
            return
        data = (line + "\n").encode("utf-8")
        with self._sink_lock:
            rotate = bool(
                self._sink_bytes
                and self._sink_bytes + len(data) > self.max_bytes)
            self._sink_bytes = (len(data) if rotate
                                else self._sink_bytes + len(data))
        # the I/O runs OUTSIDE the lock: the bookkeeping above elects
        # exactly one rotator per threshold crossing, and O_APPEND
        # whole-line writes keep concurrent appenders' lines intact —
        # a line landing in the just-rotated file during the rename
        # window is acceptable for a best-effort debug sink
        try:
            if rotate:
                os.replace(self._sink_path, self._sink_path + ".1")
                with self._lock:
                    self._stats["sink_rotations"] += 1
            fd = os.open(self._sink_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
        except OSError:
            log.debug("ledger sink write degraded to ring-only",
                      exc_info=True)

    # -- queries ------------------------------------------------------------

    def query(self, tenant: Optional[str] = None,
              voice: Optional[str] = None,
              outcome: Optional[str] = None,
              since: Optional[float] = None,
              request_id: Optional[str] = None,
              limit: int = 100) -> List[dict]:
        """Filtered view of the ring, newest first.

        When querying by ``request_id`` on a router whose record names
        a serving node, the node's own record is fetched and merged in
        under ``node_record`` (the stitched-trace pattern) — one
        document, both hops.
        """
        limit = max(int(limit), 0)
        out: List[dict] = []
        with self._lock:
            for _nbytes, rec in reversed(self._ring):
                if tenant is not None and rec.get("tenant") != tenant:
                    continue
                if voice is not None and rec.get("voice") != voice:
                    continue
                if outcome is not None and rec.get("outcome") != outcome:
                    continue
                if since is not None and rec.get("ts", 0) < since:
                    continue
                if (request_id is not None
                        and rec.get("request_id") != request_id):
                    continue
                out.append(dict(rec))
                if len(out) >= limit:
                    break
        fetcher = self._node_fetcher
        if request_id is not None and fetcher is not None:
            for rec in out:
                node = (rec.get("router") or {}).get("node")
                if not node or "node_record" in rec:
                    continue
                try:
                    fetched = fetcher(request_id, node)
                except Exception:
                    log.debug("node-record fetch degraded",
                              exc_info=True)
                    fetched = None
                if fetched:
                    rec["node_record"] = fetched
        return out

    def set_node_record_fetcher(self, fn: Optional[Callable]) -> None:
        """Router-side hook: ``fn(request_id, node_id) -> dict|None``
        fetches the serving node's own record for query-time merge."""
        self._node_fetcher = fn

    # -- stats / metrics ----------------------------------------------------

    def stat(self, name: str) -> float:
        with self._lock:
            if name == "ring_bytes":
                return float(self._ring_bytes)
            if name == "ring_records":
                return float(len(self._ring))
            return float(self._stats.get(name, 0))

    def outcome_total(self, outcome: str) -> float:
        with self._lock:
            return float(self._outcomes.get(outcome, 0))

    def bind_metrics(self, registry) -> None:
        """Register the ledger's families (only when the ledger exists,
        so ``SONATA_LEDGER_MB=0`` pins zero new series)."""
        records = registry.counter(
            "sonata_ledger_records_total",
            "Finalized wide events by disposition.")
        for outcome in OUTCOMES:
            records.labels(outcome=outcome).set_function(
                lambda o=outcome: self.outcome_total(o))
        for family, help_text in (
                ("sonata_ledger_sampled_out_total",
                 "OK records dropped by probabilistic sampling."),
                ("sonata_ledger_emit_errors_total",
                 "Record finalizations degraded to no-record."),
                ("sonata_ledger_evictions_total",
                 "Ring records evicted to hold the byte budget."),
                ("sonata_ledger_sink_rotations_total",
                 "NDJSON sink rotations at the byte budget.")):
            stat_name = family[len("sonata_ledger_"):-len("_total")]
            registry.counter(family, help_text).set_function(
                lambda s=stat_name: self.stat(s))
        registry.gauge(
            "sonata_ledger_ring_bytes",
            "Bytes held by the in-memory record ring.").set_function(
            lambda: self.stat("ring_bytes"))
        registry.gauge(
            "sonata_ledger_ring_records",
            "Records held by the in-memory ring.").set_function(
            lambda: self.stat("ring_records"))
        self._exemplar_metric = registry.gauge(
            "sonata_ledger_exemplar",
            "Last-kept request id per incident kind (value = finalize "
            "unix time); links SLO-breach and refusal counters to the "
            "offending ledger record.")

    def ledger_view(self) -> dict:
        """Point-in-time stats document (debug / tests)."""
        with self._lock:
            return {"ring_records": len(self._ring),
                    "ring_bytes": self._ring_bytes,
                    "max_bytes": self.max_bytes,
                    "sample": self.sample,
                    "outcomes": dict(self._outcomes),
                    **dict(self._stats)}

    def close(self) -> None:
        """Stop accepting emits (ring stays queryable for teardown
        introspection; nothing to flush — the sink writes through)."""
        self._closed = True
