"""Streaming gRPC server.

Port of ``sonata_tpu/frontends/grpc_server.py`` on the PyTorch voices.  The
same service, messages, status mapping, serving runtime, replica pool,
drain and warm-up, with these differences:

- voices load on ``--device`` / ``create_server(device=)`` (default: the
  GPU; the tests pass ``cpu``), and a replica pool puts one voice per card;
- no persistent compile cache (there is no compile: what a first request
  pays is cuDNN's per-thread plans, which the warm-up lattice builds on the
  serving threads, see ``PiperVoice.warm_shape``), so each voice's batch
  worker — its scheduler, each replica's, or, without
  ``--continuous-batching``, the voice's own batch thread that every
  handler thread hands its batch synthesis to — is attached to the voice
  for the lattice to warm through;
- under ``--continuous-batching``, ``SynthesizeUtterance`` with speech
  args also goes through the scheduler (the results are post-processed
  after it), where the reference synthesizes those on the handler thread;
- with a replica pool, the warm-up also calibrates and warms the loaded
  voice itself: realtime streams ride its stream engines, not a
  replica's;
- no device mesh: ``--mesh-devices`` is refused until the multi-GPU slice
  of the port.

Analogue of the reference's ``sonata-grpc`` frontend
(``crates/frontends/grpc/src/main.rs``):

- same service surface (see :mod:`.grpc_messages`);
- voice registry keyed by a stable hash of the canonical config path,
  idempotent per path (``main.rs:83-98``; the reference uses
  ``xxh3_64(path)/10^13`` — we use blake2b since ids are opaque strings);
- ``SynthesizeUtterance`` streams per-sentence ``SynthesisResult`` with RTF
  (``main.rs:321-355``); unlike the reference — which ignores
  ``synthesis_mode`` and always goes lazy (``:332-333``, MODE_BATCHED
  vestigial) — batched mode is honored here, because batched is where the
  accelerator wins;
- ``SynthesizeUtteranceRealtime`` streams raw wave chunks with
  chunk 55 / padding 3 (``main.rs:383``);
- synthesis runs on the shared synthesis pool so the gRPC threads stay
  responsive (the reference's ``spawn_blocking`` + channel bridge,
  ``main.rs:381-409``, maps onto grpc's own worker threads plus our pool);
- error mapping SonataError → Status (``main.rs:47-59``);
- binds ``127.0.0.1:$SONATA_GRPC_SERVER_PORT``, default 49314
  (``main.rs:17,437-440``); logging env ``SONATA_GRPC`` (``:413-416``).

Unlike the reference — which queues unboundedly and waits forever — the
server runs behind a :class:`~sonata_tpu_torch.serving.ServingRuntime`
(admission control, per-request deadlines, a Prometheus ``/metrics`` +
``/healthz``/``/readyz`` HTTP plane, and a ``CheckHealth`` unary):
excess load sheds with ``RESOURCE_EXHAUSTED``, requests that outlive
their (client or ``SONATA_REQUEST_TIMEOUT_S`` default) deadline fail
with ``DEADLINE_EXCEEDED`` before reaching a device dispatch, and
readiness flips only after preloaded voices complete a warmup
synthesis (see docs/DEPLOY.md "Serving runtime").

grpcio is used through a ``GenericRpcHandler`` with our own message codec —
no protoc plugin exists in this environment.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from concurrent.futures import CancelledError
from concurrent.futures import TimeoutError as FutureTimeoutError
from pathlib import Path
from typing import Iterator, Optional

import grpc

from .. import __version__
from ..core import FailedToLoadResource, OperationError, SonataError
from ..models import PiperVoice, from_config_path
from ..serving import (
    Deadline,
    DeadlineExceeded,
    Draining,
    Overloaded,
    ServingRuntime,
    faults,
    synthcache,
    tracing,
)
from ..serving import ledger as ledger_mod
from ..serving import tenancy as tenancy_mod
from ..serving import warmup as serving_warmup
from ..serving.logs import configure_logging
from ..synth import AudioOutputConfig, SpeechSynthesizer
from ..utils.profiling import RtfCounter
from . import grpc_messages as pb

log = logging.getLogger("sonata.grpc")

DEFAULT_PORT = 49314  # main.rs:17
_SERVICE_PATH = f"{pb.PACKAGE}.{pb.SERVICE}"


def voice_id_for(config_path: str) -> str:
    """Stable opaque id per canonical path (``main.rs:18,83-95``)."""
    canon = str(Path(config_path).resolve())
    digest = hashlib.blake2b(canon.encode(), digest_size=8).hexdigest()
    return str(int(digest, 16) // 10**13)


class _Voice:
    def __init__(self, voice: PiperVoice, config_path: str, voice_id: str,
                 continuous_batching: bool = False, replicas: int = 0):
        self.voice = voice
        self.config_path = config_path
        self.voice_id = voice_id
        self.rtf = RtfCounter()  # aggregate serving metrics (SURVEY §5)
        self.rtf_logged_at = 0  # watermark for periodic aggregate logging
        self.scheduler = None
        self.pool = None
        # the voice id rides the iteration loop's per-iteration scope
        # attribution (the scheduler path names the voice via
        # trace_attrs below; the streaming path has no scheduler)
        voice.scope_voice = voice_id
        if replicas:
            # replica pool: one device-pinned copy of the voice per chip,
            # each with its own continuous-batching scheduler; the pool
            # slots into the scheduler's place (same submit/stats/shutdown
            # surface), so every downstream path is shared
            from ..serving.replicas import ReplicaPool

            self.pool = ReplicaPool.for_voice(
                voice, replicas if replicas > 0 else None, name=voice_id)
            self.scheduler = self.pool
            # the lattice warms each replica's batch path on its own
            # scheduler's thread (a breaker trip rebuilds the scheduler,
            # so the worker is looked up at warm time)
            for replica in self.pool.replicas:
                replica.model.attach_batch_worker(
                    lambda r=replica: r.scheduler)
        elif continuous_batching:
            from ..synth.scheduler import BatchScheduler

            # the voice id rides the dispatch attribution so traces and
            # the scope's padding-waste accounting name the voice
            self.scheduler = BatchScheduler(
                voice, trace_attrs={"voice": voice_id})
            voice.attach_batch_worker(lambda: self.scheduler)
        else:
            # no scheduler: batch synthesis would run on whichever gRPC
            # handler thread took the call, and each would meet every
            # shape cold (cuDNN's plans are per thread); one batch thread
            # of the voice's serves them all, and the lattice warms it
            voice.serve_batches_on_thread()
        self.synth = SpeechSynthesizer(voice, replica_pool=self.pool)


def _status_for(e: SonataError) -> grpc.StatusCode:
    # main.rs:47-59 mapping, extended with the serving-runtime errors
    if isinstance(e, Draining):
        # a deploy, not overload: UNAVAILABLE (with a "draining" detail)
        # tells clients "retry another replica now" and keeps the
        # degradation ladder's shed accounting clean
        return grpc.StatusCode.UNAVAILABLE
    if isinstance(e, Overloaded):
        return grpc.StatusCode.RESOURCE_EXHAUSTED
    if isinstance(e, DeadlineExceeded):
        return grpc.StatusCode.DEADLINE_EXCEEDED
    if isinstance(e, FailedToLoadResource):
        return grpc.StatusCode.NOT_FOUND
    if isinstance(e, OperationError):
        return grpc.StatusCode.ABORTED
    return grpc.StatusCode.UNKNOWN


def _context_request_id(context) -> str:
    """Resolve (and memoize) the request id for this RPC: the client's
    ``x-request-id`` metadata when present, else generated ONCE — so
    the trace, the ledger record, and the wire trailer all carry the
    same id, including for refused requests that never reach a trace."""
    rid = getattr(context, "_sonata_rid", None)
    if rid is None:
        rid = (tracing.request_id_from_context(context)
               or tracing.new_request_id())
        try:
            context._sonata_rid = rid
        except Exception:
            pass  # frozen context double: regenerate if asked again
    return rid


def _add_trailers(context, *pairs) -> None:
    """Accumulate trailing metadata.  ``set_trailing_metadata`` REPLACES
    the previous tuple wholesale, so every trailer producer (request id,
    node id, retry-after) funnels through this helper, which keeps the
    union on the context and re-sets the whole of it each time."""
    set_tm = getattr(context, "set_trailing_metadata", None)
    if set_tm is None:
        return
    acc = getattr(context, "_sonata_trailers", None)
    if acc is None:
        acc = []
        try:
            context._sonata_trailers = acc
        except Exception:
            pass
    acc.extend(pairs)
    try:
        set_tm(tuple(acc))
    except Exception:
        pass  # terminated context / test double


def _ledger_record(runtime, context, rpc: str, voice=None):
    """Open (and memoize on the context) this request's wide-event
    record; None when the ledger is off.  Shared by the node frontend
    and the mesh router — both memoize, so an abort after ``begin``
    finalizes the SAME record, never a second one."""
    lg = runtime.ledger
    if lg is None:
        return None
    rec = getattr(context, "_sonata_ledger_rec", None)
    if rec is None:
        rec = lg.begin(rpc, _context_request_id(context), voice=voice)
        try:
            context._sonata_ledger_rec = rec
        except Exception:
            pass  # frozen context double: a fresh record per caller
    return rec


class SonataGrpcService:
    """RPC implementations over a lock-protected voice registry
    (``main.rs:76``)."""

    def __init__(self, seed: int = 0, continuous_batching: bool = False,
                 runtime: Optional[ServingRuntime] = None,
                 replicas: int = 0, device=None):
        self._voices: dict[str, _Voice] = {}
        self._lock = threading.RLock()
        self._loading: dict[str, threading.Lock] = {}
        #: where voices load: None is the GPU, "cpu" the host
        self._device = device
        self._seed = seed
        self._continuous_batching = continuous_batching
        #: 0 = no pool; >0 = that many replicas; <0 = one per local
        #: device.  SONATA_REPLICAS>0 turns the pool on even without the
        #: flag (resolve_replica_count applies the env inside the pool).
        self._replicas = replicas
        if not replicas:
            from ..serving.replicas import env_replica_count

            if env_replica_count() > 0:
                self._replicas = -1  # env-enabled: env decides the count
        self.runtime = runtime if runtime is not None else ServingRuntime()
        self._draining = threading.Event()

    # -- helpers -------------------------------------------------------------
    def _get(self, voice_id: str, context) -> _Voice:
        with self._lock:
            v = self._voices.get(voice_id)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"voice {voice_id!r} not loaded")
        return v

    def _voice_info(self, v: _Voice) -> pb.VoiceInfo:
        # main.rs:124-170
        sc = v.voice.get_fallback_synthesis_config()
        info = v.voice.audio_output_info()
        return pb.VoiceInfo(
            voice_id=v.voice_id,
            synth_options=pb.SynthesisOptions(
                speaker=sc.speaker[0] if sc.speaker else None,
                length_scale=sc.length_scale,
                noise_scale=sc.noise_scale,
                noise_w=sc.noise_w,
            ),
            speakers=v.voice.get_speakers() or {},
            audio=pb.AudioInfo(sample_rate=info.sample_rate,
                               num_channels=info.num_channels,
                               sample_width=info.sample_width),
            language=v.voice.get_language(),
            quality=pb.Quality.from_string(v.voice.config.quality),
            supports_streaming_output=v.voice.supports_streaming_output(),
        )

    @staticmethod
    def _maybe_log_rtf(v: "_Voice", every: int = 50) -> None:
        """Log aggregate serving RTF roughly every ``every`` utterances
        (watermark, not modulo: multi-sentence requests advance the count
        in jumps)."""
        stats = v.rtf.snapshot()
        if stats.utterances - v.rtf_logged_at >= every:
            v.rtf_logged_at = stats.utterances
            log.info("voice %s: %d utterances, aggregate RTF %.4f "
                     "(%.1f audio-s/s)", v.voice_id, stats.utterances,
                     stats.rtf, stats.audio_seconds_per_second)
            # per-dispatch counters ride the same cadence: requests vs
            # device dispatches per stage shows whether coalescing is
            # actually happening under the current policy
            dispatch_stats = getattr(v.voice, "dispatch_stats", None)
            if dispatch_stats is not None:
                ds = dispatch_stats()
                if v.scheduler is not None:
                    ds["scheduler"] = v.scheduler.stats_view()
                log.info("voice %s dispatch: %s", v.voice_id,
                         {k: val for k, val in ds.items()
                          if k != "policy"})

    # -- unary RPCs -----------------------------------------------------------
    def GetSonataVersion(self, request: pb.Empty, context) -> pb.Version:
        return pb.Version(version=__version__)

    def LoadVoice(self, request: pb.VoicePath, context) -> pb.VoiceInfo:
        if not request.config_path:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "config_path is required")
        if self.runtime.drain.draining:
            # a voice loaded mid-drain would race the teardown that is
            # about to close every voice — refuse typed, like admissions
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          "draining: server is shutting down for a "
                          "restart; not loading new voices")
        vid = voice_id_for(request.config_path)
        # per-voice load lock: concurrent loads of the same path block on
        # one load instead of each importing the model (the reference holds
        # its registry lock across the load, main.rs:83-98; a per-voice
        # lock keeps other voices servable meanwhile)
        while True:
            with self._lock:
                existing = self._voices.get(vid)
                if existing is None:
                    load_lock = self._loading.setdefault(
                        vid, threading.Lock())
            if existing is not None:  # idempotent per path (main.rs:96-98)
                return self._voice_info(existing)
            with load_lock:
                with self._lock:
                    # a failed load pops its _loading entry (below), so a
                    # lock acquired before that pop may be stale — a later
                    # caller could already be loading under a fresh lock.
                    # Only the holder of the CURRENTLY mapped lock may
                    # load; stale holders retry from the top (and then
                    # either find the voice or serialize on the new lock).
                    if self._loading.get(vid) is not load_lock:
                        continue
                    existing = self._voices.get(vid)
                if existing is not None:
                    return self._voice_info(existing)
                # the finally pops the load-lock entry on EVERY exit: a
                # failed load used to leak it (context.abort raises,
                # skipping the pop), growing _loading by one dead Lock
                # per bad path
                try:
                    try:
                        voice = from_config_path(request.config_path,
                                                 seed=self._seed,
                                                 device=self._device)
                    except SonataError as e:
                        context.abort(_status_for(e), str(e))
                    try:
                        v = _Voice(
                            voice, request.config_path, vid,
                            continuous_batching=self._continuous_batching,
                            replicas=self._replicas)
                    except SonataError as e:
                        # pool/scheduler construction failed (e.g. params
                        # don't fit N times): release the loaded voice's
                        # worker threads and map the status instead of
                        # leaking it behind an UNKNOWN
                        voice.close()
                        context.abort(_status_for(e), str(e))
                    with self._lock:
                        self._voices[vid] = v
                    break
                finally:
                    with self._lock:
                        self._loading.pop(vid, None)
        log.info("loaded voice %s from %s", vid, request.config_path)
        # export the voice's existing observability (RTF aggregate,
        # dispatch counters, scheduler queue, per-replica gauges) on the
        # metrics plane
        self.runtime.register_voice(vid, rtf_counter=v.rtf,
                                    dispatch_stats=v.synth.dispatch_stats,
                                    scheduler=v.scheduler,
                                    replica_pool=v.pool)
        if v.pool is not None:
            # zero healthy replicas must flip /readyz: the load balancer
            # routes around this host until a probe restores a replica
            self.runtime.health.add_readiness_gate(
                f"replicas:{vid}",
                lambda pool=v.pool: pool.healthy_count() > 0)
            log.info("voice %s: replica pool over %d device(s): %s", vid,
                     len(v.pool.replicas),
                     [str(r.device) for r in v.pool.replicas])
        # resolve + surface the backend-adaptive dispatch policy at load
        # time, so the serving shape (coalescing on/off, batch/wait knobs,
        # probe constants) is in the log before traffic arrives
        try:
            log.info("voice %s %s", vid, voice.dispatch_policy.describe())
        except Exception:  # policy must never block serving
            log.exception("dispatch-policy resolution failed "
                          "(serving continues on defaults)")
        return self._voice_info(v)

    def GetVoiceInfo(self, request: pb.VoiceIdentifier, context) -> pb.VoiceInfo:
        return self._voice_info(self._get(request.voice_id, context))

    def GetSynthesisOptions(self, request: pb.VoiceIdentifier,
                            context) -> pb.SynthesisOptions:
        v = self._get(request.voice_id, context)
        return self._voice_info(v).synth_options

    def SetSynthesisOptions(self, request: pb.VoiceSynthesisOptions,
                            context) -> pb.SynthesisOptions:
        # main.rs:211-255
        v = self._get(request.voice_id, context)
        opts = request.synthesis_options
        sc = v.voice.get_fallback_synthesis_config()
        if opts is not None:
            if opts.speaker is not None:
                sid = v.voice.speaker_name_to_id(opts.speaker)
                if sid is None and opts.speaker.isdigit():
                    sid = int(opts.speaker)
                if sid is None:
                    context.abort(grpc.StatusCode.NOT_FOUND,
                                  f"unknown speaker {opts.speaker!r}")
                sc.speaker = (opts.speaker, sid)
            if opts.length_scale is not None:
                sc.length_scale = opts.length_scale
            if opts.noise_scale is not None:
                sc.noise_scale = opts.noise_scale
            if opts.noise_w is not None:
                sc.noise_w = opts.noise_w
        v.voice.set_fallback_synthesis_config(sc)
        return self._voice_info(v).synth_options

    # -- streaming RPCs --------------------------------------------------------
    @staticmethod
    def _speech_args_config(args: Optional[pb.SpeechArgs]):
        if args is None:
            return None
        if all(x is None for x in (args.rate, args.volume, args.pitch,
                                   args.appended_silence_ms)):
            return None
        return AudioOutputConfig(rate=args.rate, volume=args.volume,
                                 pitch=args.pitch,
                                 appended_silence_ms=args.appended_silence_ms)

    # -- serving-runtime helpers ----------------------------------------------
    def _abort_sonata(self, context, rpc: str, e: SonataError,
                      refusal: Optional[str] = None) -> None:
        """Record the failure on the metrics plane and in the request
        ledger (a typed refusal when the site passes one or the
        exception type implies one, an error record otherwise), stamp
        ``x-request-id`` on the wire — refused requests are debuggable
        too — then abort (raises)."""
        code = _status_for(e)
        self.runtime.failures.labels(rpc=rpc, code=code.name).inc()
        _add_trailers(context,
                      ("x-request-id", _context_request_id(context)))
        lg = self.runtime.ledger
        if lg is not None:
            if refusal is None:
                refusal = ledger_mod.refusal_kind(e)
            rec = _ledger_record(self.runtime, context, rpc)
            ident = getattr(context, "_sonata_tenant", None)
            if ident is not None:
                rec.note(tenant=ident.name)
            if refusal is not None:
                lg.emit(rec, refusal=refusal)
            else:
                lg.emit(rec, outcome="error", error=type(e).__name__)
        context.abort(code, str(e))

    @staticmethod
    def _await_future(fut, deadline: Optional[Deadline]):
        """Wait for a scheduler future, bounded by the request deadline.

        The scheduler's gather loop fails expired items itself; this
        guard covers the remaining window — an item already packed into a
        long-running dispatch when its deadline passes, where only the
        waiter can observe the expiry promptly."""
        timeout = None
        if deadline is not None:
            rem = deadline.remaining()
            if rem is not None:
                # small grace so the scheduler's own expiry (the accurate
                # error) wins the race when both fire together
                timeout = max(rem, 0.0) + 0.05
        try:
            return fut.result(timeout=timeout)
        except FutureTimeoutError:
            fut.cancel()  # may already be running; best effort
            raise DeadlineExceeded(
                "deadline exceeded waiting for device dispatch") from None
        except CancelledError:
            # the scheduler cancelled it because the client went away
            raise DeadlineExceeded("request cancelled") from None

    # -- multi-tenant QoS (serving/tenancy.py) ----------------------
    def _tenant_identity(self, context):
        """Resolve (and memoize on the context) this request's tenant.
        Classification runs ONCE per RPC even though the cache, quota,
        fair-gate, and accounting paths each need it — and the
        ``tenancy.classify`` failpoint therefore fires once too.
        Returns None when tenancy is off."""
        tn = self.runtime.tenancy
        if tn is None:
            return None
        ident = getattr(context, "_sonata_tenant", None)
        if ident is None:
            ident = tn.classify_context(context)
            try:
                context._sonata_tenant = ident
            except Exception:
                pass  # frozen context double: classify again if asked
        return ident

    def _tenant_synth_gate(self, context, rpc: str):
        """Per-tenant admission for one SYNTHESIS stream — cache hits
        and single-flight followers never reach here, so quota is only
        burned by work that costs a dispatch (the probe-before-charge
        order the PR pins).  In order: the per-tenant shed rung (ahead
        of the fleet-wide ``reject_heavy`` rung), the token-bucket
        charge (typed RESOURCE_EXHAUSTED refusal with a
        machine-readable ``retry-after-s`` trailer), then the
        weighted-fair gate slot.  Returns ``(gate, tenant)`` with the
        slot held — the caller must ``gate.leave(tenant)`` in a
        finally — or ``(None, None)`` when tenancy is off."""
        rt = self.runtime
        tn = rt.tenancy
        if tn is None:
            return None, None
        ident = self._tenant_identity(context)
        name = ident.name
        if tn.shed_rung(name, rt.degradation.current_level()):
            # the tenancy rung sheds over-quota / background tenants
            # BEFORE any fleet-wide degradation touches foreground work;
            # sonata_shed_total{source="tenancy"} reads the plane's
            # counter via set_function, so note_shed is the only bump
            tn.note_shed(name)
            self._abort_sonata(context, rpc, Overloaded(
                f"degraded ({rt.degradation.level_name}): tenant "
                f"{name!r} shed (background priority or over quota)"),
                refusal="tenant-shed")
        ok, retry_after = tn.charge(ident)
        if not ok:
            _add_trailers(context, (tenancy_mod.RETRY_AFTER_TRAILER,
                                    f"{retry_after:.3f}"))
            self._abort_sonata(context, rpc, Overloaded(
                f"tenant {name!r} over quota; retry in "
                f"{retry_after:.3f}s"), refusal="node-quota")
        tn.note_admitted(name)
        gate = tn.fair
        if gate is None:
            return None, name
        deadline = rt.deadline_for(context)
        rem = deadline.remaining() if deadline is not None else None
        if not gate.enter(name, timeout_s=(max(0.0, rem)
                                           if rem is not None else 30.0)):
            tn.note_shed(name)
            self._abort_sonata(context, rpc, Overloaded(
                f"tenant {name!r}: weighted-fair queue wait exceeded "
                "the request deadline"), refusal="tenant-shed")
        return gate, name

    def _tenant_gated(self, request, context, rpc: str, miss_fn):
        """Run one miss body inside the tenant synth gate (quota +
        DRR slot); with tenancy off this is exactly ``miss_fn``."""
        gate, name = self._tenant_synth_gate(context, rpc)
        if gate is None:
            yield from miss_fn(request, context)
            return
        try:
            yield from miss_fn(request, context)
        finally:
            gate.leave(name)

    def _tenant_observed(self, request, context, body):
        """Tenant-attributed TTFB/e2e/error accounting around one
        admitted stream body (called only with tenancy on — the off
        path stays byte-for-byte).  Feeds the tenant's own SLO counter
        rings on the scope plane; the global rings remain trace-fed."""
        rt = self.runtime
        ident = self._tenant_identity(context)
        tenant = ident.name if ident is not None else None
        scope = rt.scope
        t0 = time.monotonic()
        ok = True
        try:
            first = True
            for msg in body(request, context):
                if first:
                    first = False
                    if scope is not None:
                        scope.observe_tenant(tenant, "ttfb",
                                             time.monotonic() - t0)
                yield msg
            if scope is not None:
                scope.observe_tenant(tenant, "e2e",
                                     time.monotonic() - t0)
        except GeneratorExit:
            raise  # client hangup: not a server-attributed error
        except BaseException:
            ok = False
            raise
        finally:
            if scope is not None:
                scope.note_tenant_error(tenant, ok)

    def _admitted(self, request, context, rpc: str, body):
        """Run a streaming RPC body inside one admission slot and one
        request trace; sheds with RESOURCE_EXHAUSTED when the controller
        is at capacity.

        The trace (``serving/tracing.py``) is the request's span tree:
        its id comes from ``x-request-id`` metadata when the client sent
        one (so client-side and server-side traces correlate), else it is
        generated.  Everything the body logs while the trace is active
        carries the request_id (see ``serving/logs.py``); an admission
        shed still produces a finished (error-status) trace, so shed
        requests are debuggable too.

        The same id seeds the request's wide-event ledger record
        (``serving/ledger.py``): this wrapper counts chunks / bytes /
        TTFB as the stream flows, then finalizes the record at stream
        close with the cost breakdown re-read from the trace spans —
        one record per request, whatever the disposition.
        """
        from contextlib import ExitStack, closing

        rt = self.runtime
        rid = _context_request_id(context)
        rec = _ledger_record(
            self.runtime, context, rpc,
            voice=getattr(request, "voice_id", None) or None)
        if rec is not None:
            rec.note(text_len=len(getattr(request, "text", "") or ""))
        try:
            with rt.tracer.trace_request(
                    rpc,
                    request_id=rid,
                    voice=getattr(request, "voice_id", None) or "") as trace:
                with ExitStack() as stack:
                    # the span covers only slot ACQUISITION (the shed /
                    # wait cost); the stack holds the slot for the body
                    # with real exception info reaching release
                    with tracing.span("admission"):
                        # drain beats admission: a restarting process
                        # refuses new work typed (UNAVAILABLE) BEFORE
                        # taking a slot, so the in-flight count the
                        # drain waits on only ever shrinks — in-flight
                        # requests already hold their slot and finish
                        rt.drain.raise_if_draining()
                        stack.enter_context(rt.admission.admit())
                    rt.requests.labels(rpc=rpc).inc()
                    # name this backend and the request id in the
                    # response trailers so the sonata-mesh router (and
                    # any client) can log WHICH node served the stream
                    # and correlate it with the ledger record
                    trailers = [("x-request-id", rid)]
                    if rt.node_id:
                        trailers.append(("x-sonata-node-id", rt.node_id))
                    _add_trailers(context, *trailers)
                    if rt.tenancy is None:
                        inner = body(request, context)
                    else:
                        inner = self._tenant_observed(request, context,
                                                      body)
                    t0 = time.monotonic()
                    chunks = 0
                    bytes_out = 0
                    first_at = None
                    # closing(): a client hangup (GeneratorExit at the
                    # yield) must close the BODY generator while this
                    # trace is still active — an abandoned suspended
                    # body would unwind its spans after trace_request
                    # exits and re-install a stale current trace (the
                    # ordering `yield from` used to provide)
                    with closing(inner):
                        for msg in inner:
                            chunks += 1
                            payload = getattr(msg, "wav_samples", None)
                            if payload:
                                bytes_out += len(payload)
                            if first_at is None:
                                first_at = time.monotonic()
                            yield msg
                    if rec is not None:
                        ident = getattr(context, "_sonata_tenant", None)
                        rec.note(
                            chunks=chunks, bytes_out=bytes_out,
                            ttfb_s=(first_at - t0
                                    if first_at is not None else None),
                            tenant=(ident.name if ident is not None
                                    else None),
                            **ledger_mod.cost_fields_from_trace(trace))
                        rt.ledger.emit(rec)
        except (Draining, Overloaded) as e:
            self._abort_sonata(context, rpc, e)
        except GeneratorExit:
            # client hangup mid-stream: the record's disposition is
            # "cancelled" — not ok, and not a server-attributed error
            if rec is not None:
                rt.ledger.emit(rec, outcome="cancelled")
            raise
        except BaseException as e:
            # typed SonataErrors abort inside the body (the record was
            # emitted there, so this is a no-op for them); this arm
            # catches whatever nothing else did, so no admitted request
            # can vanish from the ledger
            if rec is not None and not rec.emitted:
                rt.ledger.emit(rec, outcome="error",
                               error=type(e).__name__)
            raise

    def SynthesizeUtterance(self, request: pb.Utterance,
                            context) -> Iterator[pb.SynthesisResult]:
        return self._admitted(request, context, "SynthesizeUtterance",
                              self._synthesize_utterance)

    # -- synthesis cache (serving/synthcache.py) --------------------
    def _cache_key_for(self, v: "_Voice", request: pb.Utterance,
                       kind: str) -> str:
        """Canonical request identity: normalized text + voice/speaker/
        scales + output format + the stream-shape fields.  The speaker
        and scales are snapshotted from the voice's fallback config
        exactly like the synthesis paths snapshot them, so the key and
        the audio can never disagree about identity."""
        sc = v.voice.get_fallback_synthesis_config()
        sid = sc.speaker[1] if sc.speaker else None
        info = v.voice.audio_output_info()
        # the request-shape half of the derivation is shared with the
        # mesh router's affinity tier (synthcache.utterance_key), so the
        # two sides cannot drift on how an Utterance maps into the key
        return synthcache.utterance_key(
            kind, request, voice_id=v.voice_id, speaker=sid,
            length_scale=sc.length_scale, noise_scale=sc.noise_scale,
            noise_w=sc.noise_w, sample_rate=info.sample_rate,
            sample_width=info.sample_width, channels=info.num_channels)

    def _cached_stream(self, cache, request, context, *, rpc: str,
                       kind: str, body, to_msg, payload_of):
        """Serve one streaming RPC through the synthesis cache.

        The probe sits AHEAD of pool/iteration-loop admission: a hit
        replays the committed chunk sequence (zero dispatches, zero
        queue wait) under a ``cache-hit`` span; a concurrent identical
        request follows the single-flight leader's filling entry; a
        miss makes this request the leader — every emitted chunk is
        teed into the fill handle, committed only when the stream
        finishes fully (any other exit aborts the fill, so a failed/
        cancelled/deadline-expired stream never caches a truncated
        result).
        """
        v = self._get(request.voice_id, context)
        key = self._cache_key_for(v, request, kind)
        # the tenant OWNS the bytes a fill inserts (cache-share budget)
        # but is never part of the key: identical text dedups across
        # tenants, and a hit costs nobody quota
        ident = self._tenant_identity(context)
        outcome, handle = cache.lookup(
            key, tag=v.voice_id,
            owner=ident.name if ident is not None else None)
        if outcome == "hit":
            yield from self._replay_cached(handle, context, rpc, to_msg)
            return
        if outcome == "follow":
            served = yield from self._follow_cached(handle, context, rpc,
                                                    to_msg)
            if served:
                return
            # leader failed/stalled before any of THIS stream's audio
            # left: recover via independent synthesis, cache untouched
            # (a leader error must not fan out)
            outcome = "bypass"
        if outcome != "fill":  # bypass: degraded lookup — plain miss
            yield from body()
            return
        # a client disconnect can surface as the deadline's cancel flag,
        # which makes the miss bodies RETURN normally mid-stream — this
        # flag (fed by the same context callback) lets the commit below
        # tell that truncated exit from a genuinely finished stream
        cancelled = Deadline.none()
        add_cb = getattr(context, "add_callback", None)
        if add_cb is not None:
            try:
                add_cb(cancelled.cancel)
            except Exception:
                pass  # context already terminated
        committed = False
        try:
            for msg in body():
                handle.add_chunk(*payload_of(msg))
                yield msg
            # commit ONLY a fully-successful stream: not one cut short
            # by a client disconnect, and not one whose identity drifted
            # mid-fill (a concurrent SetSynthesisOptions changes the
            # scales the lazy path reads live — the re-derived key must
            # still match the one the entry was filed under)
            if not cancelled.cancelled \
                    and self._cache_key_for(v, request, kind) == key:
                handle.commit_fill()
                committed = True
        finally:
            if not committed:
                handle.abort_fill()

    def _replay_cached(self, chunks, context, rpc: str, to_msg):
        """A cache hit: replay the stored chunk sequence byte for byte
        (same chunk boundaries the filling synthesis produced), with
        the standard TTFB/latency accounting and a ``cache-hit`` span
        instead of the dispatch tree."""
        rt = self.runtime
        deadline = rt.deadline_for(context)
        t0 = time.monotonic()
        try:
            with tracing.span("cache-hit", chunks=len(chunks)) as sp:
                first = True
                for payload, aux in chunks:
                    if deadline.cancelled:
                        return  # client went away mid-replay
                    deadline.raise_if_expired()
                    if first:
                        first = False
                        ttfb = time.monotonic() - t0
                        rt.ttfb.observe(ttfb)
                        sp.annotate(ttfb_ms=round(ttfb * 1e3, 3))
                    yield to_msg(payload, aux)
            rt.synth_latency.observe(time.monotonic() - t0)
        except DeadlineExceeded as e:
            rt.expired.inc()
            self._abort_sonata(context, rpc, e)

    def _follow_cached(self, follower, context, rpc: str, to_msg):
        """Single-flight follower: stream chunks from the leader's
        filling entry as they land (bounded per-chunk wait).  Returns
        True when served to completion, False when the leader failed
        before ANY audio left this stream (the caller then falls back
        to independent synthesis).  A leader failure after audio left
        fails this stream typed — splicing in chunks from a fresh,
        differently-noised synthesis would be worse than failing."""
        rt = self.runtime
        deadline = rt.deadline_for(context)
        t0 = time.monotonic()
        n = 0
        try:
            with tracing.span("cache-follow") as sp:
                for payload, aux in follower:
                    if deadline.cancelled:
                        return True  # client gone; nothing to recover
                    deadline.raise_if_expired()
                    n += 1
                    if n == 1:
                        ttfb = time.monotonic() - t0
                        rt.ttfb.observe(ttfb)
                        sp.annotate(ttfb_ms=round(ttfb * 1e3, 3))
                    yield to_msg(payload, aux)
                sp.annotate(chunks=n)
            rt.synth_latency.observe(time.monotonic() - t0)
            return True
        except synthcache.LeaderFailed as e:
            if n == 0:
                return False
            self._abort_sonata(context, rpc, e)
        except DeadlineExceeded as e:
            rt.expired.inc()
            self._abort_sonata(context, rpc, e)
        finally:
            # a follower whose client went away mid-follow (cancel flag
            # or generator close) would otherwise never reach a terminal
            # state — resolve it as a miss so hits+misses keeps counting
            # every resolved lookup (no-op once already resolved)
            follower.abandon()

    def _synthesize_utterance(self, request: pb.Utterance,
                              context) -> Iterator[pb.SynthesisResult]:
        cache = self.runtime.synth_cache
        if cache is None:  # default: byte-for-byte the pre-cache path
            yield from self._tenant_gated(
                request, context, "SynthesizeUtterance",
                self._synthesize_utterance_miss)
            return
        yield from self._cached_stream(
            cache, request, context, rpc="SynthesizeUtterance",
            kind="utterance",
            body=lambda: self._tenant_gated(
                request, context, "SynthesizeUtterance",
                self._synthesize_utterance_miss),
            to_msg=lambda payload, aux: pb.SynthesisResult(
                wav_samples=payload, rtf=aux if aux is not None else 0.0),
            payload_of=lambda msg: (msg.wav_samples, msg.rtf))

    def _synthesize_utterance_miss(self, request: pb.Utterance,
                                   context) -> Iterator[pb.SynthesisResult]:
        rt = self.runtime
        v = self._get(request.voice_id, context)
        cfg = self._speech_args_config(request.speech_args)
        deadline = rt.deadline_for(context)
        t0 = time.monotonic()
        first_at: Optional[float] = None
        # degradation level >= 2: batch/long-form synthesis sheds before
        # interactive work is touched (the realtime RPC and default lazy
        # mode keep serving) — recovery re-admits it automatically
        if request.synthesis_mode in (pb.SynthesisMode.PARALLEL,
                                      pb.SynthesisMode.BATCHED) \
                and rt.degradation.reject_heavy():
            rt.shed.labels(source="degradation").inc()
            self._abort_sonata(context, "SynthesizeUtterance", Overloaded(
                f"degraded ({rt.degradation.level_name}): batch "
                "synthesis rejected; interactive requests only"),
                refusal="fleet-shed")
        try:
            if v.scheduler is not None:
                # continuous batching: submit every sentence up front so a
                # request coalesces with itself AND with concurrent
                # requests, then stream results in order.  Speech args
                # (rate, volume, pitch, silence) post-process each result
                # here, so their requests also ride the worker the
                # warm-up lattice warmed.  The speaker is
                # snapshotted per request — concurrent clients that set
                # different speakers via SetSynthesisOptions each keep
                # their own voice inside a shared dispatch.  Every item
                # carries the request deadline, so queue-stuck sentences
                # are dropped before they reach a device dispatch.
                sc = v.voice.get_fallback_synthesis_config()
                sid = sc.speaker[1] if sc.speaker else None
                futures = []
                try:
                    # the submit fan-out sits INSIDE the cancel block: a
                    # submit that fails partway (queue full on sentence
                    # k) must cancel sentences 1..k-1 already queued, or
                    # they synthesize into a request that already aborted
                    for sentence in v.synth.phonemize_text(request.text):
                        futures.append(v.scheduler.submit(
                            sentence, speaker=sid, scales=sc,
                            deadline=deadline))
                    with tracing.span("stream-emit") as emit_sp:
                        for fut in futures:
                            audio = v.synth._post_process(
                                self._await_future(fut, deadline), cfg)
                            v.rtf.record(audio)
                            if first_at is None:
                                first_at = time.monotonic()
                                rt.ttfb.observe(first_at - t0)
                                emit_sp.annotate(
                                    ttfb_ms=round((first_at - t0) * 1e3,
                                                  3))
                            yield pb.SynthesisResult(
                                wav_samples=audio.as_wave_bytes(),
                                rtf=audio.real_time_factor())
                        emit_sp.annotate(items=len(futures))
                finally:
                    # client went away (or an item failed) with sentences
                    # still in flight: cancel what hasn't dispatched —
                    # via the deadline, so the gather loop drops queued
                    # items — instead of synthesizing into a dead stream
                    pending = [f for f in futures if not f.done()]
                    if pending:
                        deadline.cancel()
                        for f in pending:
                            f.cancel()
                rt.synth_latency.observe(time.monotonic() - t0)
                self._maybe_log_rtf(v)
                return
            if request.synthesis_mode in (pb.SynthesisMode.PARALLEL,
                                          pb.SynthesisMode.BATCHED):
                stream = v.synth.synthesize_parallel(request.text, cfg)
            else:
                stream = v.synth.synthesize_lazy(request.text, cfg)
            with tracing.span("stream-emit") as emit_sp:
                n_items = 0
                for audio in stream:
                    if deadline.cancelled:
                        return  # client went away; stop synthesizing
                    deadline.raise_if_expired()
                    v.rtf.record(audio)
                    n_items += 1
                    if first_at is None:
                        first_at = time.monotonic()
                        rt.ttfb.observe(stream.ttfb_s or (first_at - t0))
                        emit_sp.annotate(
                            ttfb_ms=round((first_at - t0) * 1e3, 3))
                    yield pb.SynthesisResult(
                        wav_samples=audio.as_wave_bytes(),
                        rtf=audio.real_time_factor())  # main.rs:345-348
                emit_sp.annotate(items=n_items)
            rt.synth_latency.observe(time.monotonic() - t0)
            self._maybe_log_rtf(v)
        except DeadlineExceeded as e:
            rt.expired.inc()
            self._abort_sonata(context, "SynthesizeUtterance", e)
        except SonataError as e:
            self._abort_sonata(context, "SynthesizeUtterance", e)

    def UnloadVoice(self, request: pb.VoiceIdentifier,
                    context) -> pb.Empty:
        """Drop a loaded voice and stop its coalescer threads (sonata-tpu
        extension; the reference only unloads via the C API,
        ``capi/src/lib.rs:228``).  In-flight streams on the voice fail
        with an OperationError-mapped status rather than hanging."""
        with self._lock:
            v = self._voices.pop(request.voice_id, None)
        if v is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no voice with id {request.voice_id}")
        self._close_voice(v)
        log.info("unloaded voice %s", request.voice_id)
        return pb.Empty()

    def _close_voice(self, v: _Voice) -> None:
        """Tear one voice down in dependency order: scheduler/pool first
        (its queued futures fail with the OperationError the docstring
        promises, before the model underneath disappears), then the
        voice's own worker threads, then the readiness gate and metrics
        series."""
        if self.runtime.synth_cache is not None:
            # drop the voice's cached streams: a reload at the same
            # config path reuses the voice id, and entries filled by the
            # OLD model must not replay as hits against the new one
            self.runtime.synth_cache.drop_tag(v.voice_id)
        if v.scheduler is not None:
            v.scheduler.shutdown()  # a ReplicaPool drains every replica
        if v.pool is not None:
            for replica in v.pool.replicas:
                close = getattr(replica.model, "close", None)
                if close is not None:
                    close()
            self.runtime.health.remove_readiness_gate(
                f"replicas:{v.voice_id}")
        v.voice.close()
        self.runtime.unregister_voice(v.voice_id)

    def shutdown(self) -> None:
        """Close every loaded voice immediately (server termination
        path; the graceful sibling is :meth:`drain`, which waits for
        in-flight work first and then funnels into the same teardown)."""
        # same lock as the warmup's check-and-set_ready: the pair must be
        # atomic or a warmup finishing mid-shutdown could re-flip a
        # closed replica to ready
        with self._lock:
            self._draining.set()
            self.runtime.health.set_not_ready("shutting down")
        # flag only (health is already not-ready with the pinned
        # reason): admissions refuse typed while the teardown runs
        self.runtime.drain.begin("shutdown")
        with self._lock:
            voices = list(self._voices.values())
            self._voices.clear()
        for v in voices:
            if v.pool is not None:
                # breaker resubmission / half-open probes must refuse
                # the closing pool fast and typed, not race the teardown
                v.pool.start_draining()
            self._drain_iteration_loop(v)
        for v in voices:
            self._close_voice(v)
        self.runtime.close()

    @staticmethod
    def _drain_iteration_loop(v: _Voice) -> None:
        """Iteration-mode streams: stop admitting new joins (refused
        typed) while resident streams finish — the loop retires at an
        iteration boundary instead of being hard-closed mid-iteration."""
        start = getattr(v.voice, "start_draining", None)
        if start is not None:
            start()

    def drain(self, timeout_s: Optional[float] = None,
              reason: str = "shutdown") -> bool:
        """Graceful drain: make a rolling restart a non-event.

        Runs the pinned :data:`~sonata_tpu_torch.serving.drain.DRAIN_PHASES`
        order — readiness off FIRST (the balancer stops routing here
        before anything changes), new admissions refused typed
        (UNAVAILABLE ``draining``, via :meth:`_admitted`), in-flight
        streams and queued dispatches finish inside
        ``SONATA_DRAIN_TIMEOUT_S``, then pool → schedulers →
        tracer/scope → metrics plane tear down.  One structured log
        line per phase.  Returns False when a drain/shutdown already
        ran (first caller wins).  The caller stops the gRPC listener
        *after* this returns, so in-flight streams keep their
        transport until they finish.
        """
        rt = self.runtime
        if not rt.begin_drain(reason):
            return False
        d = rt.drain
        with self._lock:
            # the warmup pin extends to this path: a lattice
            # warmup finishing mid-drain must never re-flip readiness
            self._draining.set()
        d.note_phase("readiness-off")
        # nothing else to do for this phase: _admitted consults the
        # drain flag before taking an admission slot, so from this
        # instant every new request fails UNAVAILABLE("draining")
        d.note_phase("reject-admissions",
                     in_flight=rt.admission.in_flight)

        def idle() -> bool:
            if rt.admission.in_flight > 0:
                return False
            with self._lock:
                voices = list(self._voices.values())
            return all(v.scheduler.queue_depth() == 0 for v in voices
                       if v.scheduler is not None)

        t0 = time.monotonic()
        idle_ok = d.wait_idle(idle, timeout_s)
        waited_ms = round((time.monotonic() - t0) * 1e3, 1)
        d.note_phase("wait-in-flight", ok=idle_ok, waited_ms=waited_ms,
                     stragglers=rt.admission.in_flight)
        if not idle_ok:
            log.error("drain: %d request(s) still in flight after the "
                      "%gs budget; tearing down (stragglers fail typed "
                      "when their scheduler shuts down)",
                      rt.admission.in_flight,
                      timeout_s if timeout_s is not None else d.timeout_s)
        with self._lock:
            voices = list(self._voices.values())
            self._voices.clear()
        for v in voices:
            if v.pool is not None:
                # pinned order within the phase: the pool refuses
                # resubmission/probes BEFORE its schedulers close, so a
                # breaker trip racing this teardown fails fast typed
                v.pool.start_draining()
            self._drain_iteration_loop(v)
        for v in voices:
            self._close_voice(v)
        d.note_phase("voices", closed=len(voices))
        # tracer/scope (runtime.close uninstalls the ladder and closes
        # the scope's recorder) and the metrics plane last — the scrape
        # surface outlives everything it observes
        rt.close()
        d.note_phase("runtime")
        d.note_phase("done", stragglers=rt.admission.in_flight)
        return True

    def ListVoices(self, request: pb.Empty, context) -> pb.VoiceList:
        """sonata-tpu extension: catalog of loaded voices (the reference
        has no listing endpoint)."""
        with self._lock:
            voices = list(self._voices.values())
        return pb.VoiceList(voices=[self._voice_info(v) for v in voices])

    def prewarm_all(self) -> None:
        """Compile every loaded voice's common executables (batch buckets,
        neighbor frame buckets, streaming decoders).  Serving continues on
        a per-voice failure — prewarming is a latency optimization, not a
        correctness step."""
        with self._lock:
            voices = list(self._voices.values())
        for v in voices:
            try:
                n = v.voice.prewarm(streaming=True)
                log.info("prewarmed voice %s: %d full-pipeline shapes "
                         "compiled", v.voice_id, n)
            except Exception:
                log.exception("prewarm failed (serving continues)")

    def SynthesizeUtteranceRealtime(self, request: pb.Utterance,
                                    context) -> Iterator[pb.WaveSamples]:
        return self._admitted(request, context,
                              "SynthesizeUtteranceRealtime",
                              self._synthesize_realtime)

    def _synthesize_realtime(self, request: pb.Utterance,
                             context) -> Iterator[pb.WaveSamples]:
        cache = self.runtime.synth_cache
        if cache is None:  # default: byte-for-byte the pre-cache path
            yield from self._tenant_gated(
                request, context, "SynthesizeUtteranceRealtime",
                self._synthesize_realtime_miss)
            return
        yield from self._cached_stream(
            cache, request, context, rpc="SynthesizeUtteranceRealtime",
            kind="realtime",
            body=lambda: self._tenant_gated(
                request, context, "SynthesizeUtteranceRealtime",
                self._synthesize_realtime_miss),
            to_msg=lambda payload, aux: pb.WaveSamples(
                wav_samples=payload),
            payload_of=lambda msg: (msg.wav_samples, None))

    def _synthesize_realtime_miss(self, request: pb.Utterance,
                                  context) -> Iterator[pb.WaveSamples]:
        rt = self.runtime
        v = self._get(request.voice_id, context)
        cfg = self._speech_args_config(request.speech_args)
        deadline = rt.deadline_for(context)
        # per-request chunk negotiation (sonata-tpu extension); absent/0
        # fields keep the reference's hardcoded schedule (main.rs:383)
        chunk_size = request.realtime_chunk_size or 55
        chunk_padding = request.realtime_chunk_padding or 3
        t0 = time.monotonic()
        stream = None
        try:
            # the deadline rides into the streaming path: in iteration
            # mode the resident stream carries it, so expiry fails this
            # stream alone at an iteration boundary (peers keep riding)
            stream = v.synth.synthesize_streamed(
                request.text, cfg, chunk_size=chunk_size,
                chunk_padding=chunk_padding, deadline=deadline)
            with tracing.span("stream-emit") as emit_sp:
                first = True
                n_chunks = 0
                for chunk in stream:
                    if deadline.cancelled:
                        return  # client went away; the producer is
                        # cancelled by the finally below
                    deadline.raise_if_expired()
                    n_chunks += 1
                    if first:
                        first = False
                        ttfb = stream.ttfb_s or (time.monotonic() - t0)
                        rt.ttfb.observe(ttfb)
                        emit_sp.annotate(ttfb_ms=round(ttfb * 1e3, 3))
                    yield pb.WaveSamples(wav_samples=chunk.as_wave_bytes())
                emit_sp.annotate(chunks=n_chunks)
            rt.synth_latency.observe(time.monotonic() - t0)
        except DeadlineExceeded as e:
            rt.expired.inc()
            self._abort_sonata(context, "SynthesizeUtteranceRealtime", e)
        except SonataError as e:
            self._abort_sonata(context, "SynthesizeUtteranceRealtime", e)
        finally:
            # stop the producer thread on every exit (deadline, client
            # disconnect, error) so it does not keep pushing chunks into
            # a queue nobody drains
            if stream is not None:
                stream.cancel()

    # -- health plane ----------------------------------------------------------
    def CheckHealth(self, request: pb.Empty, context) -> pb.HealthStatus:
        """gRPC mirror of the HTTP /healthz + /readyz probes, for
        load balancers that health-check over the serving protocol."""
        h = self.runtime.health.snapshot()
        return pb.HealthStatus(live=h["live"], ready=h["ready"],
                               reason=h["reason"], version=__version__,
                               node_id=h.get("node_id") or "")

    def warmup_and_mark_ready(self) -> None:
        """Warm every loaded voice, then flip readiness.

        Two stages per voice (rolling-restart contract, docs/DEPLOY.md
        "Rolling restarts, drain & the warmup lattice"):

        1. **calibration** — one real utterance through every replica
          (the legacy warmup): compiles the first shapes AND feeds each
          replica's frame estimator a real observation, so stage 2
          enumerates frame buckets with live data, not the cold prior;
        2. **bucket lattice** (``SONATA_WARMUP_LATTICE``, default
          ``full``; ``off`` keeps stage 1 only) — every (batch, text,
          frame) bucket shape compiled ahead of traffic on EVERY
          replica, bounded by ``SONATA_WARMUP_BUDGET_S``.  Budget
          expiry keeps readiness **false** with one loud log line: a
          half-warm replica must not join the serving set.

        Progress rides the ``sonata_warmup_progress`` gauge; completion
        arms the scope's cold-compile containment (any later
        ``compile=cold`` dispatch counts and dumps an incident).
        """
        with self._lock:
            voices = list(self._voices.values())
        progress = self.runtime.warmup_progress
        progress.reset()
        try:
            mode = serving_warmup.resolve_mode()
            budget_s = serving_warmup.resolve_budget_s()
            deadline = time.monotonic() + budget_s
            faults.fire("warmup")
            for v in voices:
                if v.pool is not None:
                    # every replica must compile its executables before
                    # readiness — routed warmup would warm one chip and
                    # leave the others to pay cold compiles under traffic
                    ready = list(v.synth.phonemize_text("Ready."))
                    v.pool.warmup(ready)
                    targets = [(f"{v.voice_id}[r{r.index}]", r.model)
                               for r in v.pool.replicas]
                    # realtime streams ride the loaded voice's own stream
                    # engines, not a replica's: calibrate its frame
                    # estimate (on this thread, which serves nothing) and
                    # warm its engines' threads too
                    v.voice.speak_batch(ready)
                    targets.append((v.voice_id, v.voice))
                else:
                    for _audio in v.synth.synthesize_parallel("Ready."):
                        pass
                    targets = [(v.voice_id, v.voice)]
                if mode != "off":
                    for label, model in targets:
                        serving_warmup.warm_model_lattice(
                            model, mode=mode, deadline=deadline,
                            progress=progress, label=label)
            progress.finish()
            # a shutdown that began while the warmup synthesized (slow
            # cold compile) must win: never flip a draining replica back
            # into the serving set.  Check and set under the same lock
            # shutdown()/drain() use, so the pair is atomic against them.
            with self._lock:
                if self._draining.is_set():
                    log.info("warmup finished during shutdown; staying "
                             "not-ready")
                    return
                self.runtime.health.set_ready(
                    f"{len(voices)} voice(s) loaded and warmed")
            # from here on a cold compile is a lattice-coverage hole:
            # count it, dump an incident, fail the smoke.  Armed only
            # when a lattice actually ran — under mode=off the legacy
            # one-utterance warmup makes no coverage promise, so
            # flagging every later compile would be pure noise — and
            # scoped to the voices THIS warmup covered, so a voice
            # loaded after readiness doesn't alarm on its first compiles
            if mode != "off" and self.runtime.scope is not None:
                self.runtime.scope.mark_warmup_complete(
                    voices=[v.voice_id for v in voices])
            log.info("readiness: %s (warmup lattice mode=%s, %s)",
                     self.runtime.health.reason, mode,
                     progress.snapshot())
        except serving_warmup.WarmupBudgetExceeded as e:
            progress.finish(failed_reason=str(e))
            # LOUD and unready: the orchestrator keeps traffic away and
            # retries/rolls back instead of sending users into compiles
            log.error("warmup budget expired; readiness stays false: %s "
                      "(progress %s)", e, progress.snapshot())
        except Exception:
            progress.finish(failed_reason="warmup failed")
            # stay not-ready: the orchestrator keeps traffic away and
            # retries the rollout rather than sending users into compiles
            log.exception("warmup failed; readiness stays false")


def install_signal_handlers(server, grace_s: float = 2.0) -> bool:
    """Route SIGTERM/SIGINT into the graceful drain.

    On signal: a daemon thread runs :meth:`SonataGrpcService.drain`
    (readiness off → typed refusals → bounded in-flight wait → pinned
    teardown) and only then stops the gRPC listener, so ``/readyz``
    answers 503 while in-flight streams still own their transport.  A
    second signal mid-drain skips straight to ``server.stop`` (the
    drain already ran or is running; first caller wins).  Returns False
    when handlers cannot be installed (not the main thread — e.g. under
    a test runner) — the caller keeps the abrupt path.
    """
    import signal

    service = getattr(server, "sonata_service", None)
    if service is None:
        return False
    if threading.current_thread() is not threading.main_thread():
        return False  # signal.signal is main-thread-only

    def _drain_then_stop(sig_name: str) -> None:
        try:
            # a SIGTERM mid-boot: bound the overlap with the warmup
            # thread before draining (it owns readiness until it exits;
            # a wedged compile must not stall the signal path, hence
            # the timeout rather than an unbounded join)
            warmup = getattr(server, "sonata_warmup_thread", None)
            if warmup is not None:
                warmup.join(timeout=2.0)
            service.drain(reason=sig_name)
        except Exception:
            log.exception("graceful drain failed; stopping hard")
        finally:
            server.stop(grace=grace_s)

    def _handle(signum, frame):
        name = signal.Signals(signum).name
        log.warning("received %s; draining gracefully (budget %gs)",
                    name, service.runtime.drain.timeout_s)
        threading.Thread(target=_drain_then_stop, args=(name,),
                         name="sonata_drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _handle)
    signal.signal(signal.SIGINT, _handle)
    return True


# method name → (request type, response type, is_server_streaming)
_METHODS = {
    "GetSonataVersion": (pb.Empty, pb.Version, False),
    "LoadVoice": (pb.VoicePath, pb.VoiceInfo, False),
    "GetVoiceInfo": (pb.VoiceIdentifier, pb.VoiceInfo, False),
    "GetSynthesisOptions": (pb.VoiceIdentifier, pb.SynthesisOptions, False),
    "SetSynthesisOptions": (pb.VoiceSynthesisOptions, pb.SynthesisOptions,
                            False),
    "SynthesizeUtterance": (pb.Utterance, pb.SynthesisResult, True),
    "SynthesizeUtteranceRealtime": (pb.Utterance, pb.WaveSamples, True),
    "ListVoices": (pb.Empty, pb.VoiceList, False),
    "UnloadVoice": (pb.VoiceIdentifier, pb.Empty, False),
    "CheckHealth": (pb.Empty, pb.HealthStatus, False),
}


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, service: SonataGrpcService):
        self._service = service

    def service(self, handler_call_details):
        path = handler_call_details.method  # "/sonata_grpc.sonata_grpc/X"
        prefix = f"/{_SERVICE_PATH}/"
        if not path.startswith(prefix):
            return None
        name = path[len(prefix):]
        entry = _METHODS.get(name)
        if entry is None:
            return None
        req_cls, resp_cls, streaming = entry
        method = getattr(self._service, name)
        deserialize = req_cls.decode
        serialize = lambda m: m.encode()  # noqa: E731
        if streaming:
            return grpc.unary_stream_rpc_method_handler(
                method, request_deserializer=deserialize,
                response_serializer=serialize)
        return grpc.unary_unary_rpc_method_handler(
            method, request_deserializer=deserialize,
            response_serializer=serialize)


def create_server(port: Optional[int] = None, *, seed: int = 0,
                  max_workers: int = 16, continuous_batching: bool = False,
                  host: str = "127.0.0.1",
                  runtime: Optional[ServingRuntime] = None,
                  max_in_flight: Optional[int] = None,
                  max_queue_depth: Optional[int] = None,
                  request_timeout_s: Optional[float] = None,
                  metrics_port: Optional[int] = None,
                  replicas: int = 0, device=None
                  ) -> tuple[grpc.Server, int]:
    """Build the server (not started) and its serving runtime; returns it
    with the bound port.  ``device``: where voices load (None: the GPU,
    raising without one; ``"cpu"``: the host)."""
    from concurrent.futures import ThreadPoolExecutor

    port = port if port is not None else int(
        os.environ.get("SONATA_GRPC_SERVER_PORT", DEFAULT_PORT))
    if runtime is None:
        runtime = ServingRuntime(max_in_flight=max_in_flight,
                                 max_queue_depth=max_queue_depth,
                                 request_timeout_s=request_timeout_s)
    service = SonataGrpcService(seed=seed,
                                continuous_batching=continuous_batching,
                                runtime=runtime, replicas=replicas,
                                device=device)
    server = grpc.server(ThreadPoolExecutor(max_workers=max_workers,
                                            thread_name_prefix="sonata_grpc"))
    server.add_generic_rpc_handlers((_Handler(service),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise OperationError(f"cannot bind {host}:{port}")
    server.sonata_service = service  # for startup hooks (e.g. prewarm)
    server.sonata_runtime = runtime
    # stable node identity for the fleet tier: SONATA_NODE_ID beats the
    # bind address; surfaced on /readyz, /metrics, CheckHealth, and in
    # gRPC trailing metadata (see serving/mesh.py)
    from ..serving.mesh import resolve_node_id
    runtime.set_node_id(resolve_node_id(f"{host}:{bound}"))
    # metrics/health HTTP plane: explicit port > SONATA_METRICS_PORT >
    # disabled (0 binds an ephemeral port, runtime.http_port has it)
    http_port = runtime.start_http(metrics_port)
    if http_port is not None:
        log.info("metrics/health plane on http://127.0.0.1:%d "
                 "(/metrics /healthz /readyz)", http_port)
    return server, bound


def main(argv=None) -> int:
    # default logging so import-time/flag errors are visible; re-run
    # below once the --log-level/--log-format flags are parsed
    configure_logging(env_level_var="SONATA_GRPC")
    import argparse

    ap = argparse.ArgumentParser(prog="sonata-tpu-torch-grpc")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--voice", action="append", default=[],
                    help="preload a voice config at startup (repeatable)")
    ap.add_argument("--continuous-batching", action="store_true",
                    help="coalesce concurrent requests into shared device "
                         "dispatches")
    ap.add_argument("--replicas", type=int, default=0,
                    help="run a replica pool: one device-pinned copy of "
                         "each voice per chip with least-loaded routing "
                         "and per-replica circuit breaking (implies "
                         "continuous batching per replica).  N>0 = that "
                         "many replicas, -1 = one per local device, 0 = "
                         "off unless $SONATA_REPLICAS is set)")
    ap.add_argument("--device", default=None,
                    help="where voices load: cuda, cuda:N or cpu "
                         "(default: the GPU)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="not available yet: a device mesh comes with the "
                         "port's multi-GPU slice")
    ap.add_argument("--prewarm", action="store_true",
                    help="warm each preloaded voice's common shapes "
                         "(batch buckets, neighbor frame buckets, "
                         "streaming windows) on its serving threads in "
                         "the background at startup")
    ap.add_argument("--request-timeout-s", type=float, default=None,
                    help="server-side default deadline for requests whose "
                         "client set none (default: "
                         "$SONATA_REQUEST_TIMEOUT_S or 120; <=0 disables)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics /healthz /readyz on this HTTP "
                         "port (0 = ephemeral; default: "
                         "$SONATA_METRICS_PORT or disabled)")
    ap.add_argument("--max-in-flight", type=int, default=None,
                    help="admission: max concurrently executing requests "
                         "(default $SONATA_MAX_IN_FLIGHT or 32)")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission: max requests waiting beyond "
                         "--max-in-flight before shedding with "
                         "RESOURCE_EXHAUSTED (default "
                         "$SONATA_MAX_QUEUE_DEPTH or 128)")
    ap.add_argument("--log-level", default=None,
                    choices=("DEBUG", "INFO", "WARNING", "ERROR",
                             "CRITICAL"),
                    help="server log level (default $SONATA_GRPC or INFO)")
    ap.add_argument("--log-format", default=None,
                    choices=("text", "json"),
                    help="log line format; json emits one structured "
                         "object per line with request_id/voice/replica "
                         "fields (default $SONATA_LOG_FORMAT or text)")
    args = ap.parse_args(argv)
    if args.log_level or args.log_format:
        configure_logging(args.log_level, args.log_format,
                          env_level_var="SONATA_GRPC")
    faults.warn_if_armed(log)

    if args.mesh_devices:
        ap.error("--mesh-devices is not available in the PyTorch port "
                 "yet: a device mesh comes with its multi-GPU slice")

    server, port = create_server(args.port, host=args.host,
                                 device=args.device,
                                 continuous_batching=args.continuous_batching,
                                 request_timeout_s=args.request_timeout_s,
                                 metrics_port=args.metrics_port,
                                 max_in_flight=args.max_in_flight,
                                 max_queue_depth=args.max_queue_depth,
                                 replicas=args.replicas)
    server.start()
    log.info("sonata-tpu gRPC server v%s listening on %s:%d",
             __version__, args.host, port)
    # rolling restarts: SIGTERM/SIGINT drain gracefully (readiness off
    # first, in-flight streams finish, pinned teardown order) instead
    # of vanishing mid-stream; see docs/DEPLOY.md "Rolling restarts"
    install_signal_handlers(server)
    try:
        if args.voice:
            # preload through the public RPC path for identical semantics
            channel = grpc.insecure_channel(f"{args.host}:{port}")
            stub = channel.unary_unary(
                f"/{_SERVICE_PATH}/LoadVoice",
                request_serializer=lambda m: m.encode(),
                response_deserializer=pb.VoiceInfo.decode)
            for cfg in args.voice:
                info = stub(pb.VoicePath(config_path=cfg))
                log.info("preloaded voice %s", info.voice_id)

            def startup():
                # prewarm (broad shape coverage) before the warmup that
                # gates readiness — each preloaded voice answers one real
                # utterance before the replica joins the serving set
                if args.prewarm:
                    server.sonata_service.prewarm_all()
                server.sonata_service.warmup_and_mark_ready()

            warmup_thread = threading.Thread(
                target=startup, name="sonata_warmup", daemon=True)
            # the graceful drain joins this (bounded) so a SIGTERM
            # mid-boot does not race the warmup flipping readiness
            server.sonata_warmup_thread = warmup_thread
            warmup_thread.start()
        else:
            if args.prewarm:
                log.warning("--prewarm does nothing without --voice")
            # nothing to warm: an empty server is "ready" in the sense
            # that it will serve LoadVoice immediately
            runtime = getattr(server, "sonata_runtime", None)
            if runtime is not None:  # absent on test stubs
                # no warmup was ever owed: the progress gauge must read
                # 1.0, not sit at 0 forever looking like a wedged boot
                # (the documented alert is "ready but progress < 1")
                runtime.warmup_progress.finish()
                runtime.health.set_ready("no preloaded voices")
        server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        # runs on EVERY exit path after server.start() — Ctrl-C,
        # server.stop() from another thread, a SIGTERM handler, or a
        # preload failure above — so the port stops accepting work and
        # loaded voices' coalescer threads are always joined, not only
        # on the interactive-interrupt path
        server.stop(grace=2.0)
        service = getattr(server, "sonata_service", None)
        if service is not None:  # absent on test stubs
            service.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
