"""Metrics registry and Prometheus text exposition over stdlib HTTP.

The serving stack already *measures* a lot — ``RtfCounter`` aggregates,
``dispatch_stats()`` counters, scheduler coalescing stats — but until now
the only way out was a log line every ~50 utterances.  This module gives
those numbers (plus the admission/deadline counters this subsystem adds)
a pull endpoint any Prometheus-compatible scraper understands:

- :class:`MetricsRegistry` owns named metrics.  Three kinds: ``counter``
  (monotonic), ``gauge`` (settable, or lazily computed via a callback at
  scrape time — how existing stats objects are wired in without adding a
  push call to every hot path), and ``histogram`` (bounded buckets, via
  :class:`~sonata_tpu_torch.utils.profiling.Histogram`).
- Metrics are labelable (``metric.labels(voice="1234").inc()``); series
  for unloaded voices are removed with ``metric.remove(...)``.
- ``render()`` emits `text/plain; version=0.0.4` exposition format;
  :func:`parse_prometheus_text` is the matching validator used by the
  tests and the CI serving smoke.
- :func:`start_http_server` serves ``/metrics`` plus the health plane's
  ``/healthz`` and ``/readyz`` (see :mod:`.health`) from one tiny
  threaded stdlib ``http.server`` — no web framework dependency.

Port comes from ``SONATA_METRICS_PORT`` (0 = ephemeral; unset = no
server).
"""

from __future__ import annotations

import logging
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from ..utils.profiling import Histogram

log = logging.getLogger("sonata.serving")

METRICS_PORT_ENV = "SONATA_METRICS_PORT"
METRICS_HOST_ENV = "SONATA_METRICS_HOST"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_LabelKey = Tuple[Tuple[str, str], ...]


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _label_str(labels: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled series of a metric."""

    __slots__ = ("_value", "_fn", "_hist", "_lock")

    def __init__(self, hist_buckets=None, is_hist: bool = False):
        self._value = 0.0
        self._fn: Optional[Callable[[], Optional[float]]] = None
        self._hist = Histogram(hist_buckets) if is_hist else None
        self._lock = threading.Lock()

    # counter / gauge API
    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_function(self, fn: Callable[[], Optional[float]]) -> None:
        """Compute the value at scrape time (returning None skips the
        series for that scrape)."""
        with self._lock:
            self._fn = fn

    def get(self) -> Optional[float]:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return fn()
        except Exception:
            # a dead callback (e.g. voice unloaded mid-scrape) must never
            # break the whole exposition
            return None

    # histogram API
    def observe(self, value: float) -> None:
        self._hist.observe(value)


class Metric:
    """A named metric family; series are created on first ``labels()``."""

    def __init__(self, name: str, help: str, type: str, buckets=None):
        self.name = name
        self.help = help
        self.type = type
        self._buckets = buckets
        self._children: Dict[_LabelKey, _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **labels) -> _Child:
        key: _LabelKey = tuple(sorted(labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Child(self._buckets,
                               is_hist=self.type == "histogram")
                self._children[key] = child
            return child

    def remove(self, **labels) -> None:
        key: _LabelKey = tuple(sorted(labels.items()))
        with self._lock:
            self._children.pop(key, None)

    def attach(self, hist, **labels) -> None:
        """Expose an externally-owned
        :class:`~sonata_tpu_torch.utils.profiling.Histogram` as this metric's
        series for ``labels`` — the histogram twin of a gauge callback:
        the owner (e.g. the batch scheduler's queue-wait histogram) keeps
        observing on its hot path, the scrape reads a snapshot."""
        if self.type != "histogram":
            raise ValueError(
                f"attach() needs a histogram metric, {self.name!r} is "
                f"{self.type}")
        key: _LabelKey = tuple(sorted(labels.items()))
        with self._lock:
            child = _Child()
            child._hist = hist
            self._children[key] = child

    # unlabeled convenience: metric.inc() == metric.labels().inc()
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def set_function(self, fn: Callable[[], Optional[float]]) -> None:
        self.labels().set_function(fn)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def get(self, **labels) -> Optional[float]:
        return self.labels(**labels).get()

    # -- exposition ----------------------------------------------------------
    def render(self) -> str:
        with self._lock:
            children = list(self._children.items())
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type}"]
        n_series = 0
        for key, child in children:
            if self.type == "histogram":
                snap = child._hist.snapshot()
                for bound, cum in zip(snap.buckets, snap.counts):
                    le = 'le="' + _format_value(bound) + '"'
                    lines.append(
                        f"{self.name}_bucket{_label_str(key, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(f"{self.name}_bucket{_label_str(key, inf)} "
                             f"{snap.total}")
                lines.append(f"{self.name}_sum{_label_str(key)} "
                             f"{_format_value(snap.sum)}")
                lines.append(f"{self.name}_count{_label_str(key)} "
                             f"{snap.total}")
                n_series += 1
                continue
            value = child.get()
            if value is None:
                continue
            lines.append(f"{self.name}{_label_str(key)} "
                         f"{_format_value(value)}")
            n_series += 1
        if n_series == 0:
            return ""
        return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Named metric families, rendered together in one exposition."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, help: str, type: str,
                  buckets=None) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.type != type:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type}")
                return existing
            m = Metric(name, help, type, buckets=buckets)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str) -> Metric:
        return self._register(name, help, "counter")

    def gauge(self, name: str, help: str) -> Metric:
        return self._register(name, help, "gauge")

    def histogram(self, name: str, help: str, buckets=None) -> Metric:
        return self._register(name, help, "histogram", buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return "".join(m.render() for m in metrics)


def _unescape_label(v: str) -> str:
    """Invert :func:`_escape_label` (``\\\\`` ``\\n`` ``\\"``), so parsed
    label values round-trip to exactly what ``labels(...)`` was given."""
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt,
                                                             "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus_text(text: str) -> Dict[str, list]:
    """Strict-enough exposition parser: ``{series_name: [(labels, value)]}``.

    Raises ``ValueError`` on malformed lines.  Used by the tests and the
    CI serving smoke to assert ``render()`` output actually parses —
    the exporter ships with its own format check.  Label values are
    unescaped, so ``render()`` → ``parse`` round-trips exactly.
    """
    import re

    series: Dict[str, list] = {}
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(\{([^}]*)\})?'
        r'\s+(-?[0-9.eE+-]+|NaN|[+-]Inf)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        if line.startswith("#"):
            raise ValueError(f"line {lineno}: bad comment {line!r}")
        m = sample_re.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparseable sample {line!r}")
        name, _, labelblock, raw = m.groups()
        labels = {}
        if labelblock:
            consumed = label_re.sub("", labelblock).strip(", \t")
            if consumed:
                raise ValueError(
                    f"line {lineno}: bad label syntax {labelblock!r}")
            labels = {k: _unescape_label(v)
                      for k, v in label_re.findall(labelblock)}
        if raw == "+Inf":
            value = math.inf
        elif raw == "-Inf":
            value = -math.inf
        elif raw == "NaN":
            value = math.nan
        else:
            value = float(raw)
        series.setdefault(name, []).append((labels, value))
    return series


# ---------------------------------------------------------------------------
# HTTP plane: /metrics + /healthz + /readyz on one stdlib server
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # set per-server via type() in start_http_server
    registry: MetricsRegistry = None
    health = None
    tracer = None
    scope = None
    fleet = None
    tenancy = None
    ledger = None

    def do_GET(self):  # noqa: N802 (http.server API)
        from . import faults

        path, _, query = self.path.partition("?")
        if path == "/metrics":
            try:
                faults.fire("metrics.scrape")
            except faults.InjectedFault as e:
                # an injected scrape fault degrades exactly one scrape —
                # the handler thread answers 503 and the server lives on
                self._reply(503, f"{e}\n".encode())
                return
            body = self.registry.render().encode("utf-8")
            self._reply(200, body, CONTENT_TYPE)
        elif path == "/healthz":
            live = self.health is None or self.health.live
            self._reply(200 if live else 503,
                        b"ok\n" if live else b"unhealthy\n")
        elif path == "/readyz":
            # the node tag names this process in fleet-side probe logs
            # (the sonata-mesh router scrapes /readyz for membership)
            nid = getattr(self.health, "node_id", None)
            tag = f"node={nid}\n".encode() if nid else b""
            # the loaded-voice set is the placement reconciler's
            # ACTUAL state — emitted even when empty (a restarted
            # node's empty set is exactly the news that triggers the
            # replay), on both the 200 and 503 bodies (a warming node
            # already holds its voices)
            voices_view = getattr(self.health, "voices_view", None)
            if voices_view is not None:
                tag += ("voices=" + ",".join(voices_view())
                        + "\n").encode()
            if self.health is None or self.health.ready:
                self._reply(200, b"ready\n" + tag)
            else:
                reason = (self.health.reason or "not ready").encode()
                self._reply(503, b"not ready: " + reason + b"\n" + tag)
        elif path in ("/debug/traces", "/debug/slowest"):
            self._reply_traces(path, query)
        elif path == "/debug/profile":
            self._reply_profile(query)
        elif path == "/debug/failpoints":
            self._reply_failpoints(query)
        elif path in ("/debug/quantiles", "/debug/buckets",
                      "/debug/timeline", "/debug/scope/export"):
            self._reply_scope(path, query)
        elif path in ("/debug/fleet", "/debug/traces/stitched"):
            self._reply_fleet(path, query)
        elif path == "/debug/tenants":
            self._reply_tenants()
        elif path == "/debug/requests":
            self._reply_requests(query)
        else:
            self._reply(404, b"not found\n")

    def do_POST(self):  # noqa: N802 (http.server API)
        """``POST /debug/tenants`` — the mesh router's desired-state
        tenant-config push (sonata-tenancy): a revisioned table the
        node plane applies idempotently.  404 on tenancy-off processes
        (enabling tenancy stays the node operator's call — the router
        only synchronizes tables, it cannot switch the feature on)."""
        import json

        path, _, _ = self.path.partition("?")
        if path != "/debug/tenants":
            self._reply(404, b"not found\n")
            return
        if self.tenancy is None:
            self._reply(404, b"tenancy not enabled on this server\n")
            return
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
            doc = json.loads(self.rfile.read(length).decode("utf-8"))
            applied = self.tenancy.apply_remote(doc)
        except (ValueError, UnicodeDecodeError) as e:
            self._reply(400, (str(e) + "\n").encode())
            return
        body = json.dumps({"applied": applied,
                           "revision": self.tenancy.revision,
                           "remote_revision":
                               self.tenancy.remote_revision})
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    # -- tenant control plane (serving/tenancy.py) ---------------------------
    def _reply_tenants(self) -> None:
        """``GET /debug/tenants``: the tenant table + per-tenant
        counters/queue state.  Same gate as the scope/tracer siblings:
        tenancy off, no surface."""
        import json

        if self.tenancy is None:
            self._reply(404, b"tenancy not enabled on this server\n")
            return
        body = json.dumps(self.tenancy.snapshot())
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    # -- aggregation plane (serving/scope.py) --------------------------------
    def _reply_scope(self, path: str, query: str) -> None:
        """``/debug/quantiles`` (rolling per-stage quantiles + SLO
        state), ``/debug/buckets`` (dispatch padding-waste tables),
        ``/debug/timeline`` (flight-recorder ring; ``?format=chrome``
        for counter tracks)."""
        import json
        from urllib.parse import parse_qs

        if self.scope is None:
            # same posture as the tracer-gated /debug siblings: no
            # aggregation plane configured, no debug surface
            self._reply(404, b"scope not enabled on this server\n")
            return
        if path == "/debug/scope/export":
            # the fleet hop: the whole aggregation plane as
            # a compact mergeable payload, tagged with this node's id
            doc = self.scope.export_snapshot()
            doc["node_id"] = getattr(self.health, "node_id", None)
            body = json.dumps(doc)
        elif path == "/debug/quantiles":
            body = json.dumps({**self.scope.quantiles_snapshot(),
                               **self.scope.slo_snapshot()})
        elif path == "/debug/buckets":
            body = json.dumps(self.scope.buckets_snapshot())
        else:
            params = parse_qs(query)
            if params.get("format", [""])[0] == "chrome":
                body = json.dumps(self.scope.timeline_chrome())
            else:
                snaps = self.scope.timeline_snapshot()
                body = json.dumps({
                    "count": len(snaps),
                    "interval_s": self.scope.tick_interval_s,
                    "snapshots": snaps})
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    # -- fleet aggregation plane (serving/fleetscope.py) ---------------------
    def _reply_fleet(self, path: str, query: str) -> None:
        """``/debug/fleet`` (the fleet scoreboard) and
        ``/debug/traces/stitched?id=`` (router + serving-node spans in
        one Chrome-trace document).  Router-only surfaces: 404 on
        servers with no fleet plane, same gate as the scope/tracer
        siblings."""
        import json
        from urllib.parse import parse_qs

        if self.fleet is None:
            self._reply(404, b"fleet aggregation not enabled on this "
                             b"server\n")
            return
        if path == "/debug/fleet":
            code, doc = 200, self.fleet.fleet_snapshot()
        else:
            params = parse_qs(query)
            code, doc = self.fleet.stitched_trace(
                params.get("id", [""])[0])
        self._reply(code, json.dumps(doc).encode("utf-8"),
                    "application/json; charset=utf-8")

    # -- failpoint arming plane (serving/faults.py) --------------------------
    def _reply_failpoints(self, query: str) -> None:
        """``GET /debug/failpoints`` — no params: JSON state snapshot;
        ``?arm=site:mode[:rate[:latency_ms[:max_hits]]]`` (repeatable)
        arms; ``?disarm=site`` / ``?disarm=all`` disarms (releasing the
        threads stuck in the disarmed sites' ``hang``)."""
        import json
        from urllib.parse import parse_qs

        from . import faults

        params = parse_qs(query)
        wants_mutation = bool(params.get("arm") or params.get("disarm"))
        if wants_mutation and not faults.http_arming_allowed():
            # same posture as the tracer-gated /debug siblings: a metrics
            # port reachable cluster-wide must not double as a remote
            # fault-injection switch without an explicit opt-in
            self._reply(403, b"failpoint arming not enabled on this "
                             b"server (set SONATA_FAILPOINTS or call "
                             b"faults.enable_http_arming())\n")
            return
        try:
            for spec in params.get("arm", []):
                faults.registry().arm_spec(spec)
            for site in params.get("disarm", []):
                if site == "all":
                    faults.registry().disarm_all()
                else:
                    faults.registry().disarm(site)
        except ValueError as e:
            self._reply(400, (str(e) + "\n").encode())
            return
        body = json.dumps(faults.registry().snapshot(), indent=2,
                          sort_keys=True)
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    # -- request-trace debug plane (serving/tracing.py) ----------------------
    def _reply_traces(self, path: str, query: str) -> None:
        import json
        from urllib.parse import parse_qs

        if self.tracer is None:
            self._reply(404, b"tracing not enabled on this server\n")
            return
        params = parse_qs(query)
        traces = (self.tracer.slowest_traces() if path == "/debug/slowest"
                  else self.tracer.recent_traces())
        wanted_id = params.get("id", [""])[0]
        if wanted_id:
            # exact-id lookup: what the mesh router's stitched-trace
            # fetch uses to pull one node trace instead of the ring
            traces = [t for t in traces if t.request_id == wanted_id]
        try:
            limit = int(params.get("limit", ["0"])[0])
        except ValueError:
            limit = 0
        if limit > 0:
            traces = traces[:limit]
        if params.get("format", [""])[0] == "chrome":
            body = json.dumps(self.tracer.chrome_trace(traces))
        else:
            body = json.dumps({
                "count": len(traces),
                "order": ("slowest-first" if path == "/debug/slowest"
                          else "newest-first"),
                "traces": [t.to_dict() for t in traces]})
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    def _reply_profile(self, query: str) -> None:
        import json
        from urllib.parse import parse_qs

        from ..utils.profiling import capture_profile

        if self.tracer is None:
            # same gate as /debug/traces: no tracer, no debug plane — a
            # device capture blocks a handler thread and writes to disk,
            # which an operator who disabled tracing did not sign up for
            self._reply(404, b"tracing not enabled on this server\n")
            return
        params = parse_qs(query)
        try:
            seconds = float(params.get("seconds", ["2"])[0])
        except ValueError:
            self._reply(400, b"seconds must be a number\n")
            return
        try:
            log_dir = capture_profile(seconds)
        except RuntimeError as e:  # capture already running
            self._reply(409, (str(e) + "\n").encode())
            return
        except Exception as e:  # jax profiler unavailable on this build
            self._reply(503, f"profiler capture failed: {e}\n".encode())
            return
        body = json.dumps({"log_dir": log_dir, "seconds": seconds,
                           "view": "tensorboard --logdir <log_dir> "
                                   "(or load into Perfetto/XProf)"})
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    # -- request ledger (serving/ledger.py) ----------------------------------
    def _reply_requests(self, query: str) -> None:
        """``GET /debug/requests`` — the wide-event ring, filterable by
        ``tenant=&voice=&outcome=&since=&id=&limit=`` (newest first).
        ``id=`` on a mesh router also merges the serving node's own
        record into the hop record (the stitched-trace pattern).  404
        on ledger-off processes, like the scope/tracer siblings."""
        import json
        from urllib.parse import parse_qs

        if self.ledger is None:
            self._reply(404, b"ledger not enabled on this server\n")
            return
        params = parse_qs(query)

        def first(key):
            return params.get(key, [""])[0] or None

        since = first("since")
        if since is not None:
            try:
                since = float(since)
            except ValueError:
                self._reply(400, b"since must be a unix timestamp\n")
                return
        try:
            limit = int(first("limit") or 100)
        except ValueError:
            self._reply(400, b"limit must be an integer\n")
            return
        records = self.ledger.query(
            tenant=first("tenant"), voice=first("voice"),
            outcome=first("outcome"), since=since,
            request_id=first("id"), limit=limit)
        body = json.dumps({"count": len(records), "records": records})
        self._reply(200, body.encode("utf-8"),
                    "application/json; charset=utf-8")

    def _reply(self, code: int, body: bytes,
               content_type: str = "text/plain; charset=utf-8") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes every few seconds —
        log.debug("metrics http: " + fmt, *args)  # keep them off INFO


class MetricsHTTPServer:
    """Owns the background thread serving the metrics/health plane."""

    def __init__(self, server: ThreadingHTTPServer):
        self._server = server
        self.port = server.server_address[1]
        self._thread = threading.Thread(target=server.serve_forever,
                                        name="sonata_metrics_http",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


def resolve_metrics_port(port: Optional[int] = None) -> Optional[int]:
    """Explicit port wins; else ``SONATA_METRICS_PORT``; else disabled.

    Returns None when no metrics server should start (0 is a valid
    request: bind an ephemeral port)."""
    if port is not None:
        return port
    raw = os.environ.get(METRICS_PORT_ENV)
    if raw is None or raw.strip() == "":
        return None
    try:
        return int(raw)
    except ValueError:
        log.warning("ignoring non-integer %s=%r", METRICS_PORT_ENV, raw)
        return None


def start_http_server(registry: MetricsRegistry, health=None,
                      port: Optional[int] = None,
                      host: Optional[str] = None,
                      tracer=None, scope=None,
                      fleet=None, tenancy=None,
                      ledger=None) -> MetricsHTTPServer:
    """Serve ``/metrics``, ``/healthz``, ``/readyz`` — plus, when a
    :class:`~sonata_tpu_torch.serving.tracing.Tracer` is given,
    ``/debug/traces``, ``/debug/slowest``, and ``/debug/profile``; when
    a :class:`~sonata_tpu_torch.serving.scope.Scope` is given,
    ``/debug/quantiles``, ``/debug/buckets``, ``/debug/timeline``, and
    ``/debug/scope/export``; and, when a
    :class:`~sonata_tpu_torch.serving.fleetscope.FleetScope` is given (mesh
    routers), ``/debug/fleet`` and ``/debug/traces/stitched`` — in a
    daemon thread."""
    host = host or os.environ.get(METRICS_HOST_ENV, "127.0.0.1")
    handler = type("BoundHandler", (_Handler,),
                   {"registry": registry, "health": health,
                    "tracer": tracer, "scope": scope, "fleet": fleet,
                    "tenancy": tenancy, "ledger": ledger})
    httpd = ThreadingHTTPServer((host, port or 0), handler)
    httpd.daemon_threads = True
    return MetricsHTTPServer(httpd)
