"""The port's serving runtime: per-voice registration, the HTTP plane
(``/metrics``, ``/readyz`` gated on the warm-up), and the drain.

``ServingRuntime`` is a scripted copy; these tests drive it with the
port's voices and its gRPC service (called in process with a minimal
servicer context), and hold the per-voice series it registers equal to
the JAX runtime's for the same registration.
"""

import threading
import time
import urllib.error
import urllib.request

import pytest

from sonata_tpu.serving import ServingRuntime as JaxRuntime
from sonata_tpu.utils.profiling import RtfCounter as JaxRtf
from sonata_tpu_torch.frontends import grpc_messages as pb
from sonata_tpu_torch.frontends import grpc_server as srv
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.serving import ServingRuntime, parse_prometheus_text
from sonata_tpu_torch.serving.drain import DRAIN_PHASES
from sonata_tpu_torch.synth import BatchScheduler, SpeechSynthesizer
from sonata_tpu_torch.utils.profiling import RtfCounter
from voices import write_tiny_voice


class _Abort(Exception):
    def __init__(self, code, msg):
        super().__init__(f"{code}: {msg}")
        self.code, self.msg = code, msg


class _Ctx:
    """The servicer-context surface the service reads."""

    def __init__(self):
        self.trailers = ()

    def invocation_metadata(self):
        return ()

    def time_remaining(self):
        return None

    def is_active(self):
        return True

    def add_callback(self, cb):
        return True

    def set_trailing_metadata(self, md):
        self.trailers = md

    def abort(self, code, msg):
        raise _Abort(code, msg)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.getcode(), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return str(write_tiny_voice(tmp_path_factory.mktemp("serving"), seed=2))


def _series(registry):
    return {(name, tuple(sorted(labels.items())))
            for name, rows in parse_prometheus_text(registry.render()).items()
            for labels, _value in rows}


def test_register_voice_series_match_jax(cfg):
    voice = PiperVoice.from_config_path(cfg, device="cpu")
    synth = SpeechSynthesizer(voice)
    sched = BatchScheduler(voice)
    rt, jrt = ServingRuntime(), JaxRuntime()
    try:
        base, jbase = _series(rt.registry), _series(jrt.registry)
        rt.register_voice("v1", rtf_counter=RtfCounter(),
                          dispatch_stats=synth.dispatch_stats,
                          scheduler=sched)
        jrt.register_voice("v1", rtf_counter=JaxRtf(),
                           dispatch_stats=synth.dispatch_stats,
                           scheduler=sched)
        added = _series(rt.registry) - base
        assert added == _series(jrt.registry) - jbase
        names = {n for n, _ in added}
        assert {"sonata_voice_loaded", "sonata_voice_rtf",
                "sonata_scheduler_queue_depth",
                "sonata_runtime_cold_compiles_total"} <= names
        assert rt.health.voices_view() == ["v1"]
        rt.unregister_voice("v1")
        assert _series(rt.registry) - base == set()
        assert rt.health.voices_view() == []
    finally:
        sched.shutdown()
        voice.close()
        rt.close()
        jrt.close()


@pytest.fixture
def service(cfg, monkeypatch):
    monkeypatch.setenv("SONATA_WARMUP_LATTICE", "minimal")
    runtime = ServingRuntime(max_in_flight=4, max_queue_depth=0,
                             request_timeout_s=60.0)
    svc = srv.SonataGrpcService(continuous_batching=True, runtime=runtime,
                                device="cpu")
    info = svc.LoadVoice(pb.VoicePath(config_path=cfg), _Ctx())
    port = runtime.start_http(0)
    yield svc, info.voice_id, f"http://127.0.0.1:{port}"
    svc.shutdown()


def test_readyz_flips_at_warmup_progress_one(service):
    svc, vid, base = service
    rt = svc.runtime
    code, body = _get(base + "/readyz")
    assert code == 503
    fractions = []
    done = threading.Event()

    def watch():
        while not done.is_set():
            fractions.append(rt.warmup_progress.fraction())
            code, _ = _get(base + "/readyz")
            if code == 200:
                # readiness never runs ahead of the lattice
                assert rt.warmup_progress.fraction() == 1.0
            time.sleep(0.01)

    w = threading.Thread(target=watch)
    w.start()
    try:
        svc.warmup_and_mark_ready()
    finally:
        done.set()
        w.join(10)
    assert rt.warmup_progress.snapshot()["total"] > 0
    assert rt.warmup_progress.fraction() == 1.0
    code, body = _get(base + "/readyz")
    assert code == 200
    # the lattice ran on the voice's scheduler thread: a request of a
    # warmed shape is no runtime cold compile
    items = list(svc.SynthesizeUtterance(
        pb.Utterance(voice_id=vid, text="Ready now."), _Ctx()))
    assert items and len(items[0].wav_samples) > 0
    code, body = _get(base + "/metrics")
    assert code == 200
    parsed = parse_prometheus_text(body)
    assert parsed["sonata_warmup_progress"][0][1] == 1.0
    cold = dict((labels["voice"], value) for labels, value in
                parsed["sonata_runtime_cold_compiles_total"])
    assert cold == {vid: 0.0}
    v = svc._voices[vid]
    assert v.voice.warmed_shapes
    on_worker = {(e, shape) for e, shape, name in v.voice.first_uses
                 if name == "sonata_batcher"}
    warmed_batch = {w for w in v.voice.warmed_shapes if w[0] == "batch"}
    assert warmed_batch and warmed_batch <= on_worker


def _warmed_service(cfg, monkeypatch, continuous_batching):
    monkeypatch.setenv("SONATA_WARMUP_LATTICE", "minimal")
    runtime = ServingRuntime(max_in_flight=4, max_queue_depth=0,
                             request_timeout_s=60.0)
    svc = srv.SonataGrpcService(continuous_batching=continuous_batching,
                                runtime=runtime, device="cpu")
    vid = svc.LoadVoice(pb.VoicePath(config_path=cfg), _Ctx()).voice_id
    svc.warmup_and_mark_ready()
    assert runtime.health.ready
    return svc, vid


def _on_fresh_thread(svc, vid, text, mode, speech_args=None):
    """One ``SynthesizeUtterance`` on a thread of its own, as a gRPC
    handler thread would take it."""
    box = {}

    def call():
        box["items"] = list(svc.SynthesizeUtterance(pb.Utterance(
            voice_id=vid, text=text, synthesis_mode=mode,
            speech_args=speech_args), _Ctx()))

    t = threading.Thread(target=call)
    t.start()
    t.join(120)
    return box["items"]


@pytest.mark.parametrize("continuous_batching,worker", [
    (False, "sonata_batch_thread"), (True, "sonata_batcher")],
    ids=["batch-thread", "scheduler"])
def test_speech_args_batches_ride_the_warmed_worker(cfg, monkeypatch,
                                                    continuous_batching,
                                                    worker):
    """After the warm-up, ``SynthesizeUtterance`` with speech args (lazy
    and batched) from fresh handler threads runs its batches on the worker
    the lattice warmed — the voice's batch thread without
    ``--continuous-batching``, the scheduler's with it — and meets no
    shape cold there."""
    svc, vid = _warmed_service(cfg, monkeypatch, continuous_batching)
    try:
        voice = svc._voices[vid].voice
        warmed = {s for e, s in voice.warmed_shapes if e == "batch"}
        assert warmed and warmed <= {s for e, s, name in voice.first_uses
                                     if e == "batch" and name == worker}
        mark = len(voice.first_uses)
        args = pb.SpeechArgs(rate=30, volume=80, pitch=60,
                             appended_silence_ms=100)
        plain = _on_fresh_thread(svc, vid, "Ready now.",
                                 pb.SynthesisMode.LAZY)
        for mode in (pb.SynthesisMode.LAZY, pb.SynthesisMode.BATCHED):
            items = _on_fresh_thread(svc, vid, "Ready now.", mode, args)
            assert len(items) == 1 and len(items[0].wav_samples) > 0
            # the speech args reached the audio (slower, plus silence)
            assert len(items[0].wav_samples) > len(plain[0].wav_samples)
        new = voice.first_uses[mark:]
        assert not [u for u in new if u[0] == "batch"], new
        assert svc.runtime.scope.runtime_cold_compiles(vid) == 0
    finally:
        svc.shutdown()


def test_batch_thread_counts_unwarmed_shapes_cold(cfg, monkeypatch):
    """Without ``--continuous-batching`` a batch the lattice did not warm
    (two sentences in one group; ``minimal`` warms batch 1) is annotated
    cold on the batch thread and counted as a runtime cold compile, so
    readiness never hides a first use it did not cover."""
    svc, vid = _warmed_service(cfg, monkeypatch, False)
    try:
        items = _on_fresh_thread(svc, vid, "Ready now. And one more.",
                                 pb.SynthesisMode.BATCHED)
        assert len(items) == 2
        voice = svc._voices[vid].voice
        cold = [u for u in voice.first_uses if u[0] == "batch"
                and u[1][0] == 2]
        assert cold and {u[2] for u in cold} == {"sonata_batch_thread"}
        assert svc.runtime.scope.runtime_cold_compiles(vid) >= 1
    finally:
        svc.shutdown()


def test_drain_runs_phases_in_order_and_closes_voices(service):
    svc, vid, base = service
    rt = svc.runtime
    svc.warmup_and_mark_ready()
    items = list(svc.SynthesizeUtteranceRealtime(
        pb.Utterance(voice_id=vid, text="Before the drain."), _Ctx()))
    assert items
    voice = svc._voices[vid].voice
    assert svc.drain(reason="test") is True
    assert [p for p, _ms in rt.drain.phases] == list(DRAIN_PHASES)
    assert not rt.health.ready and svc._voices == {}
    assert voice._voice_closed
    with pytest.raises(_Abort) as e:
        list(svc.SynthesizeUtterance(
            pb.Utterance(voice_id=vid, text="Too late."), _Ctx()))
    assert e.value.code.name == "UNAVAILABLE" and "draining" in e.value.msg
    assert svc.drain(reason="again") is False


def test_profiling_counters_and_trace(tmp_path):
    """``RtfCounter`` keeps the JAX module's arithmetic; ``capture_profile``
    writes a Chrome trace of a ``torch.profiler`` capture."""
    import json

    import numpy as np

    from sonata_tpu.utils.profiling import RtfCounter as JaxCounter
    from sonata_tpu_torch.audio import Audio, AudioSamples
    from sonata_tpu_torch.core import AudioInfo
    from sonata_tpu_torch.utils import profiling

    ours, theirs = RtfCounter(), JaxCounter()
    for n, ms in ((16000, 120.0), (8000, 30.5)):
        audio = Audio(AudioSamples(np.zeros(n, np.float32)),
                      AudioInfo(sample_rate=16000), inference_ms=ms)
        ours.record(audio)
        theirs.record(audio)
    a, b = ours.snapshot(), theirs.snapshot()
    assert (a.utterances, a.audio_ms, a.inference_ms, a.rtf,
            a.audio_seconds_per_second) == (
        b.utterances, b.audio_ms, b.inference_ms, b.rtf,
        b.audio_seconds_per_second)
    log_dir = profiling.capture_profile(0.1, str(tmp_path / "prof"))
    doc = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    assert log_dir == str(tmp_path / "prof") and "traceEvents" in doc
    sink = []
    with profiling.timed("block", sink):
        pass
    assert sink[0][0] == "block" and sink[0][1] >= 0.0
