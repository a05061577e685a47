"""Command-line frontend.

Port of ``sonata_tpu/frontends/cli.py`` on the PyTorch voices: the same
flags, modes, stdin JSON loop, metrics plane and drain, plus ``--device``
(default: the GPU; ``cpu`` runs on the host), and without the persistent
compile cache and platform pin of the JAX frontend.

Mirrors the reference's ``sonata`` binary (``crates/frontends/cli/src/
main.rs``): voice config path + text, output file or raw-bytes-to-stdout,
three modes (lazy / batched / realtime), synthesis scales, prosody
percentages, and — when no text is given — a loop reading JSON
``SynthesisRequest`` lines from stdin with auto-enumerated output filenames
``stem-N.ext`` (``main.rs:78-92,118-124,234-258``).

Logging via the ``SONATA_LOG`` env var (``main.rs:113-116``).  The ort
EP selection of the reference (``main.rs:184-197``) has no counterpart:
the backend is always PyTorch; ``--backend`` is accepted for parity and
validated.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

from ..core import SonataError
from ..models import from_config_path
from ..serving import tracing
from ..serving.logs import configure_logging
from ..synth import AudioOutputConfig, SpeechSynthesizer

log = logging.getLogger("sonata.cli")

REALTIME_DEFAULT_CHUNK = 100  # main.rs:158
REALTIME_DEFAULT_PADDING = 3  # main.rs:159


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sonata-tpu-torch",
        description="Neural text-to-speech (Piper voices) on PyTorch")
    p.add_argument("config", help="voice config JSON path")
    p.add_argument("text", nargs="?", help="text to speak; omit to read "
                   "JSON requests from stdin")
    p.add_argument("-f", "--input-file", help="read input text from file")
    p.add_argument("-o", "--output", help="output WAV path ('-' = raw "
                   "sample bytes to stdout)")
    p.add_argument("--mode", choices=("lazy", "parallel", "batched",
                                      "realtime"), default="parallel")
    p.add_argument("--speaker-id", type=int)
    p.add_argument("--length-scale", type=float)
    p.add_argument("--noise-scale", type=float)
    p.add_argument("--noise-w", type=float)
    p.add_argument("--rate", type=int, help="0-100")
    p.add_argument("--volume", type=int, help="0-100")
    p.add_argument("--pitch", type=int, help="0-100")
    p.add_argument("--silence-ms", type=int, dest="silence_ms",
                   help="appended silence per sentence")
    p.add_argument("--chunk-size", type=int, default=REALTIME_DEFAULT_CHUNK)
    p.add_argument("--chunk-padding", type=int,
                   default=REALTIME_DEFAULT_PADDING)
    p.add_argument("--backend", choices=("torch",), default="torch",
                   help="compute backend (PyTorch only)")
    p.add_argument("--device", default=None,
                   help="where the voice runs: cuda, cuda:N or cpu "
                        "(default: the GPU)")
    p.add_argument("--replicas", type=int, default=0,
                   help="fan batched synthesis across a replica pool: one "
                        "device-pinned copy of the voice per chip with "
                        "least-loaded routing and per-replica circuit "
                        "breaking.  N>0 = that many replicas, -1 = one "
                        "per local device, 0 = off unless "
                        "$SONATA_REPLICAS is set (parallel/batched mode "
                        "and the stdin JSON loop; lazy/realtime modes "
                        "keep the single default device)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--info", action="store_true",
                   help="print voice metadata as JSON and exit")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="per-request synthesis deadline in seconds "
                        "(default $SONATA_REQUEST_TIMEOUT_S, unset = "
                        "no deadline; streams stop with an error when "
                        "it expires)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus /metrics and /healthz;/readyz "
                        "on this port while the process runs (0 = "
                        "ephemeral; default $SONATA_METRICS_PORT or "
                        "disabled) — useful with the stdin JSON loop")
    p.add_argument("--log-level", default=None,
                   choices=("DEBUG", "INFO", "WARNING", "ERROR",
                            "CRITICAL"),
                   help="log level (default $SONATA_LOG or INFO)")
    p.add_argument("--log-format", default=None,
                   choices=("text", "json"),
                   help="log line format; json emits one structured "
                        "object per line with request_id/voice fields "
                        "(default $SONATA_LOG_FORMAT or text)")
    return p


def _apply_scales(synth: SpeechSynthesizer, args) -> None:
    sc = synth.get_fallback_synthesis_config()
    if args.speaker_id is not None:
        speakers = synth.get_speakers() or {}
        name = speakers.get(args.speaker_id, str(args.speaker_id))
        sc.speaker = (name, args.speaker_id)
    if args.length_scale is not None:
        sc.length_scale = args.length_scale
    if args.noise_scale is not None:
        sc.noise_scale = args.noise_scale
    if args.noise_w is not None:
        sc.noise_w = args.noise_w
    synth.set_fallback_synthesis_config(sc)


def _output_config(args) -> AudioOutputConfig | None:
    if all(v is None for v in (args.rate, args.volume, args.pitch,
                               args.silence_ms)):
        return None
    return AudioOutputConfig(rate=args.rate, volume=args.volume,
                             pitch=args.pitch,
                             appended_silence_ms=args.silence_ms)


def _stream_for(synth: SpeechSynthesizer, args, text: str,
                deadline=None):
    cfg = _output_config(args)
    if args.mode == "lazy":
        return synth.synthesize_lazy(text, cfg)
    if args.mode == "realtime":
        # the deadline rides into the model's streaming path: an
        # iteration-mode resident stream carries it (expiry fails this
        # stream alone), same contract as the gRPC realtime RPC
        return synth.synthesize_streamed(text, cfg, args.chunk_size,
                                         args.chunk_padding,
                                         deadline=deadline)
    return synth.synthesize_parallel(text, cfg)


def _deadline_for(args):
    """Per-request deadline from --timeout-s (None = unbounded: the CLI
    historically has no timeout, so unlike the server there is no
    implicit 120 s default — only an explicit flag or env opts in)."""
    timeout = args.timeout_s
    if timeout is None:
        raw = os.environ.get("SONATA_REQUEST_TIMEOUT_S")
        if raw:
            try:
                timeout = float(raw)
            except ValueError:
                timeout = None
    if timeout is None or timeout <= 0:
        return None
    from ..serving import Deadline

    return Deadline.after(timeout)


def process_synthesis_request(synth: SpeechSynthesizer, args, text: str,
                              out_path: str | None) -> None:
    """Synthesize one request to a file or stdout (``main.rs:126-182``).

    With ``--timeout-s`` (or ``SONATA_REQUEST_TIMEOUT_S``) the stream is
    checked between items and fails with DeadlineExceeded when the
    request runs over — same contract as the gRPC server.  Each request
    gets its own trace (generated request id), so the stdin JSON loop's
    ``--metrics-port`` plane serves ``/debug/traces`` exactly like the
    gRPC server's."""
    with tracing.default_tracer().trace_request(
            "cli-synthesize", mode=args.mode):
        _process_synthesis_request(synth, args, text, out_path)


def _process_synthesis_request(synth: SpeechSynthesizer, args, text: str,
                               out_path: str | None) -> None:
    t0 = time.perf_counter()
    deadline = _deadline_for(args)

    def guarded(stream):
        try:
            for audio in stream:
                if deadline is not None:
                    deadline.raise_if_expired("synthesis")
                yield audio
        except BaseException:
            # a realtime stream's producer keeps synthesizing into its
            # queue unless told to stop — on expiry (or any abandon),
            # cancel it so a timed-out request stops costing device time
            cancel = getattr(stream, "cancel", None)
            if cancel is not None:
                cancel()
            raise

    # construct the stream before the emit span opens: batched mode does
    # its device work here, and those spans (phonemize, encode-ids,
    # dispatch) belong to the pipeline, not to emission
    stream = _stream_for(synth, args, text, deadline=deadline)
    if out_path == "-":
        raw = sys.stdout.buffer
        with tracing.span("stream-emit"):
            for audio in guarded(stream):
                raw.write(audio.as_wave_bytes())  # raw samples
                raw.flush()                       # (main.rs:167-182)
    elif out_path:
        from ..audio import AudioSamples, write_wave_samples_to_file

        merged = AudioSamples()
        with tracing.span("stream-emit"):
            for audio in guarded(stream):
                merged.merge(audio.samples)
        write_wave_samples_to_file(
            out_path, merged.to_i16(),
            synth.audio_output_info().sample_rate)
        log.info("wrote %s (%.1f ms synthesis)", out_path,
                 (time.perf_counter() - t0) * 1e3)
    else:
        # no sink: drain and report timing (useful for benchmarking)
        with tracing.span("stream-emit"):
            n = sum(len(a.samples) for a in guarded(stream))
        sr = synth.audio_output_info().sample_rate
        elapsed = time.perf_counter() - t0
        print(f"synthesized {n / sr:.2f}s of audio in {elapsed * 1e3:.1f} ms "
              f"(RTF {elapsed / max(n / sr, 1e-9):.4f})")


def _numbered_output(template: str, i: int) -> str:
    """stem-N.ext auto-enumeration (``main.rs:235-247``)."""
    p = Path(template)
    return str(p.with_name(f"{p.stem}-{i}{p.suffix}"))


def _install_signal_handlers(drain_state: dict, runtime, log=log) -> bool:
    """SIGTERM/SIGINT drain the CLI gracefully: the in-flight request
    finishes (and its audio is written), the stdin loop stops taking
    new lines, then the normal teardown runs (pool drained, runtime
    closed) — the CLI mirror of the gRPC server's rolling-restart
    drain.  Idle (blocked on stdin between requests), the signal exits
    immediately through the same teardown.  Returns False when not on
    the main thread (``signal.signal`` is main-thread-only)."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        return False

    def _handle(signum, frame):
        name = signal.Signals(signum).name
        if drain_state.get("drain"):
            # second signal: the operator means NOW — escalate past the
            # in-flight request (a wedged synthesis must not make the
            # process un-killable short of SIGKILL)
            log.warning("received %s again; exiting without waiting "
                        "for the in-flight request", name)
            raise SystemExit(1)
        drain_state["drain"] = True
        if runtime is not None:
            # readiness off + the sonata_draining gauge: scrapers of a
            # long-running stdin loop see the deploy like the server's
            runtime.begin_drain(name)
        log.warning("received %s; draining (in-flight request finishes, "
                    "then exit)", name)
        if not drain_state.get("in_request"):
            raise SystemExit(0)  # idle: unwind into the finally teardown

    signal.signal(signal.SIGTERM, _handle)
    signal.signal(signal.SIGINT, _handle)
    return True


def stdin_json_loop(synth: SpeechSynthesizer, args,
                    drain_state: dict | None = None) -> None:
    """Read one JSON ``SynthesisRequest`` per line (``main.rs:234-258``).

    Request schema: ``{"text": str, "output_file"?: str, "speaker_id"?: int,
    "rate"?: int, "volume"?: int, "pitch"?: int,
    "appended_silence_ms"?: int, "noise_scale"?: float,
    "length_scale"?: float, "noise_w"?: float}``.

    ``drain_state``: the signal handlers' flag dict.  A SIGTERM while a
    request is in flight stops the loop right AFTER that request — the
    check runs at the end of each iteration, never in front of the
    blocking stdin read (a deploy usually means no further lines ever
    arrive, so a top-of-loop check would leave the process wedged in
    the read until SIGKILL; a signal landing while idle-blocked on the
    read exits through the handler's SystemExit instead).
    """
    counter = 0
    # snapshot the CLI-level baseline so one request's scales never leak
    # into the next
    base_config = synth.get_fallback_synthesis_config()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        # the line is consumed: from here until its processing ends the
        # request counts as in flight — a signal landing while the JSON
        # is still being parsed must finish this request, not SystemExit
        # and silently drop work already taken off stdin
        if drain_state is not None:
            drain_state["in_request"] = True
        try:
            try:
                req = json.loads(line)
                text = req["text"]
            except (json.JSONDecodeError, KeyError) as e:
                log.error("bad request line: %s", e)  # main.rs:252-255
                continue
            synth.set_fallback_synthesis_config(base_config.copy())
            ns = argparse.Namespace(**vars(args))
            for field in ("speaker_id", "rate", "volume", "pitch",
                          "noise_scale", "length_scale", "noise_w"):
                if field in req:
                    setattr(ns, field, req[field])
            if "appended_silence_ms" in req:
                ns.silence_ms = req["appended_silence_ms"]
            _apply_scales(synth, ns)
            out = req.get("output_file") or args.output
            if out and out != "-":
                out = _numbered_output(out, counter)
                counter += 1
            try:
                process_synthesis_request(synth, ns, text, out)
            except SonataError as e:
                log.error("synthesis failed: %s", e)
        finally:
            if drain_state is not None:
                drain_state["in_request"] = False
        if drain_state is not None and drain_state.get("drain"):
            log.info("draining: stdin loop stopping after the in-flight "
                     "request")
            break


def main(argv=None) -> int:
    # default logging so flag/import errors are visible; re-run below
    # once --log-level/--log-format are parsed
    configure_logging(env_level_var="SONATA_LOG")
    args = build_parser().parse_args(argv)
    if args.log_level or args.log_format:
        configure_logging(args.log_level, args.log_format,
                          env_level_var="SONATA_LOG")
    from ..serving import faults

    faults.warn_if_armed(log)
    try:
        if args.info:
            # metadata comes straight from the JSON config; don't pay the
            # weight import just to print it
            from ..models import ModelConfig

            mc = ModelConfig.from_path(args.config)
            sc = mc.inference
            print(json.dumps({
                "language": mc.language or mc.espeak_voice,
                "sample_rate": mc.sample_rate,
                "num_channels": 1,
                "speakers": mc.reversed_speaker_map() or None,
                "supports_streaming_output": True,
                "properties": {"quality": mc.quality or "unknown"},
                "synthesis": {"length_scale": sc.length_scale,
                              "noise_scale": sc.noise_scale,
                              "noise_w": sc.noise_w},
            }, ensure_ascii=False))
            return 0
        voice = from_config_path(args.config, seed=args.seed,
                                 device=args.device)
        policy = getattr(voice, "dispatch_policy", None)
        if policy is not None:  # visible serving shape (backend-adaptive)
            log.info(policy.describe())
        pool = None
        replicas = args.replicas
        if not replicas:
            from ..serving.replicas import env_replica_count

            if env_replica_count() > 0:
                replicas = -1  # env-enabled; the pool resolves the count
        if replicas:
            from ..serving import ReplicaPool

            pool = ReplicaPool.for_voice(
                voice, replicas if replicas > 0 else None, name="cli")
            log.info("replica pool over %d device(s): %s",
                     len(pool.replicas),
                     [str(r.device) for r in pool.replicas])
        synth = SpeechSynthesizer(voice, replica_pool=pool)
        # iteration-mode scope attribution names the voice (the CLI
        # registers its one voice as "cli" on the metrics plane below)
        voice.scope_voice = "cli"
        runtime = None
        if args.metrics_port is not None or os.environ.get(
                "SONATA_METRICS_PORT"):
            # same metrics/health plane as the gRPC server — lets a
            # long-running stdin JSON loop be scraped and probed
            from ..serving import ServingRuntime

            runtime = ServingRuntime()
            http_port = runtime.start_http(args.metrics_port)
            if http_port is not None:
                log.info("metrics/health plane on http://127.0.0.1:%d",
                         http_port)
                # only live sources: dispatch_stats reads the voice's
                # real counters (the CLI has no per-request RTF
                # aggregation path, so no rtf_counter here)
                runtime.register_voice(
                    "cli", dispatch_stats=synth.dispatch_stats,
                    scheduler=pool, replica_pool=pool)
                if pool is not None:
                    runtime.health.add_readiness_gate(
                        "replicas:cli",
                        lambda: pool.healthy_count() > 0)
                runtime.health.set_ready("voice loaded")
        _apply_scales(synth, args)
        # graceful SIGTERM/SIGINT: finish the in-flight request, stop
        # taking stdin lines, exit through the teardown below (the CLI
        # side of the rolling-restart drain contract)
        drain_state: dict = {"drain": False, "in_request": False}
        _install_signal_handlers(drain_state, runtime)
        text = args.text
        if args.input_file:
            text = Path(args.input_file).read_text(encoding="utf-8")
        try:
            if text is not None:
                drain_state["in_request"] = True
                try:
                    process_synthesis_request(synth, args, text,
                                              args.output)
                finally:
                    drain_state["in_request"] = False
            else:
                stdin_json_loop(synth, args, drain_state)
        finally:
            if pool is not None:
                pool.shutdown()
            if runtime is not None:
                runtime.close()
    except SonataError as e:
        # through the structured pipeline (not a bare stderr print), so
        # json mode stays one-object-per-line for log shippers — but a
        # fatal error must reach the user even at --log-level CRITICAL
        log.error("error: %s", e)
        if not log.isEnabledFor(logging.ERROR):
            print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
