"""Structured logging for the serving frontends.

Two things the bare ``logging.basicConfig`` the frontends used could not
do:

- **Request correlation**: every record carries the active request's
  ``request_id`` (and its ``voice``), injected by
  :class:`TraceContextFilter` from the request trace the frontend opened
  (:mod:`.tracing`) — no call site has to remember to pass it.  Records
  emitted with ``extra={"request_id": ..., "replica": ...}`` (e.g. the
  replica pool's resubmission warning, which runs on a callback thread
  where the trace context is gone) keep their explicit values.
- **Machine-readable lines**: ``--log-format json`` (or
  ``SONATA_LOG_FORMAT=json``) switches to one JSON object per line —
  ``{"ts", "level", "logger", "message", "request_id"?, "voice"?,
  "replica"?, "degradation"?, "slo_breach"?}`` — which is what a log
  pipeline joins against the trace export from ``SONATA_TRACE_LOG``
  and the flight-recorder timeline (``/debug/timeline``): every line
  carries the degradation-ladder level at emit time, and ``slo_breach``
  appears whenever an SLO's fast-window burn rate exceeded 1.0 at the
  scope's last tick.

The text format stays the familiar ``asctime name level message``, with
`` rid=<request_id>`` appended whenever one is known — plus
`` lvl=<level>`` / `` slo_breach`` only while the process is degraded
or breaching — so grepping a request (or an incident) across the
server log works in either mode.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

from . import degradation, scope, tracing

LOG_FORMAT_ENV = "SONATA_LOG_FORMAT"

#: fields TraceContextFilter injects / JsonLineFormatter surfaces
_CONTEXT_FIELDS = ("request_id", "voice", "replica", "degradation",
                   "slo_breach")


class TraceContextFilter(logging.Filter):
    """Attach the active trace's request_id/voice — plus the process
    health context (degradation level, SLO-breach flag) — to every
    record.

    Explicit ``extra=`` values win; records logged outside any request
    context get ``None`` (rendered as absent).  ``degradation`` is the
    ladder level at emit time (present whenever a ladder is installed,
    0 included, so log lines join against the flight-recorder
    timeline); ``slo_breach`` appears — as ``True`` — only while some
    SLO's fast-window burn exceeds 1.0."""

    def filter(self, record: logging.LogRecord) -> bool:
        trace = tracing.current_trace()
        if getattr(record, "request_id", None) is None:
            record.request_id = trace.request_id if trace else None
        if getattr(record, "voice", None) is None:
            record.voice = trace.attrs.get("voice") if trace else None
        if getattr(record, "replica", None) is None:
            record.replica = None
        if getattr(record, "degradation", None) is None:
            ladder = degradation.installed()
            record.degradation = (ladder.current_level()
                                  if ladder is not None else None)
        if getattr(record, "slo_breach", None) is None:
            sc = scope.installed()
            # cached at the scope's 1 Hz tick: an attribute read here,
            # never burn-rate math per log record
            record.slo_breach = True if (sc is not None
                                         and sc.slo_breach) else None
        return True


class JsonLineFormatter(logging.Formatter):
    """One JSON object per line; context fields included when present."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.localtime(record.created))
                  + f".{int(record.msecs):03d}",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        for field in _CONTEXT_FIELDS:
            value = getattr(record, field, None)
            if value is not None and value != "":
                entry[field] = value
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, ensure_ascii=False)


class TextFormatter(logging.Formatter):
    """The classic line format plus `` rid=<id>`` when a request is
    known — and, only while the process is degraded or breaching an
    SLO, `` lvl=<n>`` / `` slo_breach`` (healthy lines stay clean)."""

    def __init__(self):
        super().__init__("%(asctime)s %(name)s %(levelname)s %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        rid = getattr(record, "request_id", None)
        if rid:
            line += f" rid={rid}"
        level = getattr(record, "degradation", None)
        if level:
            line += f" lvl={level}"
        if getattr(record, "slo_breach", None):
            line += " slo_breach"
        return line


def configure_logging(level: Optional[str] = None,
                      fmt: Optional[str] = None, *,
                      env_level_var: str = "SONATA_LOG",
                      stream=None) -> None:
    """Install the serving log pipeline on the root logger.

    Precedence: explicit args (the ``--log-level`` / ``--log-format``
    flags) > env (``env_level_var`` for level — ``SONATA_GRPC`` for the
    server, ``SONATA_LOG`` for the CLI, both preserved from the
    reference — and ``SONATA_LOG_FORMAT``) > defaults (INFO, text).
    Replaces existing root handlers, so it is safe to call once at each
    frontend's entry point.
    """
    level_name = (level or os.environ.get(env_level_var) or "INFO").upper()
    resolved = getattr(logging, level_name, None)
    if not isinstance(resolved, int):
        resolved = logging.INFO
    fmt = (fmt or os.environ.get(LOG_FORMAT_ENV) or "text").lower()
    handler = logging.StreamHandler(stream if stream is not None
                                    else sys.stderr)
    handler.addFilter(TraceContextFilter())
    handler.setFormatter(JsonLineFormatter() if fmt == "json"
                         else TextFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(resolved)
