"""The port's replica pool: scenarios of ``tests/test_replicas.py`` on port
models, a two-replica CPU pool of real voices against one voice and
against the JAX package's two-replica pool, the dispatch failpoint
tripping one replica's breaker, and drain.

The state-machine scenarios run on a deterministic fake voice (a sine
per sentence), as the JAX tests do.  The real-voice pool loads a tiny
voice from disk twice over (``device="cpu"`` gives replicas on the CPU);
its noise scales are 0, so every replica synthesizes what one voice does.
Tolerance: each sentence's int16 samples within ±1 LSB of the port's own
voice, ±2 LSB of the JAX pool's, same lengths.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time

import numpy as np
import pytest

from sonata_tpu_torch.audio import Audio, AudioSamples
from sonata_tpu_torch.core import AudioInfo, BaseModel, OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.models.config import SynthesisConfig
from sonata_tpu_torch.serving import Draining, Overloaded, faults
from sonata_tpu_torch.serving.health import HealthState
from sonata_tpu_torch.serving.replicas import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    ReplicaPool,
    resolve_replica_count,
    resolve_replica_devices,
)
from sonata_tpu_torch.synth import SpeechSynthesizer
from voices import write_tiny_voice

SCHED = {"max_batch": 1, "max_wait_ms": 0.0}


class FakeVoice(BaseModel):
    """A deterministic stand-in voice: a sine whose pitch hashes the
    sentence, 160 samples a character."""

    def __init__(self):
        self._info = AudioInfo(sample_rate=16000)
        self._config = SynthesisConfig()
        self.fail = False
        self.gate = None

    def audio_output_info(self):
        return self._info

    def get_language(self):
        return "en-us"

    def get_speakers(self):
        return None

    def get_default_synthesis_config(self):
        return SynthesisConfig()

    def get_fallback_synthesis_config(self):
        return self._config.copy()

    def set_fallback_synthesis_config(self, config):
        self._config = config.copy()

    def phonemize_text(self, text):
        return [text]

    def speak_one_sentence(self, phonemes):
        return self.speak_batch([phonemes])[0]

    def speak_batch(self, sentences, speakers=None, scales=None):
        if self.gate is not None:
            assert self.gate.wait(timeout=30), "test forgot to release gate"
        if self.fail:
            raise RuntimeError("injected dispatch failure")
        out = []
        for s in sentences:
            n = max(len(s) * 160, 160)
            freq = 110.0 + hashlib.blake2b(s.encode(),
                                           digest_size=2).digest()[0] % 64
            t = np.arange(n, dtype=np.float32) / 16000
            out.append(Audio(AudioSamples(
                (0.5 * np.sin(2 * math.pi * freq * t)).astype(np.float32)),
                self._info, inference_ms=1.0))
        return out


def make_pool(models, **kwargs):
    kwargs.setdefault("scheduler_kwargs", SCHED)
    return ReplicaPool(models, **kwargs)


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def scenario_breaker_opens_and_fails_over():
    models = [FakeVoice(), FakeVoice()]
    pool = make_pool(models, breaker_threshold=3, probe_interval_s=60)
    try:
        models[0].fail = True
        audios = pool.speak_many([f"s{i}" for i in range(12)], timeout=30)
        assert len(audios) == 12
        assert pool.replicas[0].state == OPEN
        assert pool.replicas[1].state == CLOSED
        assert pool.stats["breaker_opens"] == 1
        assert pool.stats["resubmitted"] >= 3 and pool.stats["failed"] == 0
        routed = pool.replicas[0].submitted
        pool.speak_many(["t1", "t2"], timeout=30)
        assert pool.replicas[0].submitted == routed
    finally:
        pool.shutdown()


def scenario_half_open_closes_on_success():
    models = [FakeVoice(), FakeVoice()]
    pool = make_pool(models, breaker_threshold=2, probe_interval_s=0.15)
    try:
        models[0].fail = True
        pool.speak_many([f"s{i}" for i in range(8)], timeout=30)
        assert pool.replicas[0].state == OPEN
        models[0].fail = False
        assert _wait_for(lambda: pool.replicas[0].state == HALF_OPEN)
        assert pool.healthy_count() == 2
        pool.speak("trial", timeout=30)
        assert pool.replicas[0].state == CLOSED
        assert pool.stats["recovered"] == 1
    finally:
        pool.shutdown()


def scenario_half_open_reopens_on_failed_trial():
    models = [FakeVoice(), FakeVoice()]
    pool = make_pool(models, breaker_threshold=2, probe_interval_s=0.15)
    try:
        models[0].fail = True
        pool.speak_many([f"s{i}" for i in range(8)], timeout=30)
        opens = pool.stats["breaker_opens"]
        assert _wait_for(lambda: pool.replicas[0].state == HALF_OPEN)
        assert len(pool.speak("trial", timeout=30).samples) > 0
        assert pool.replicas[0].state == OPEN
        assert pool.stats["breaker_opens"] == opens + 1
    finally:
        pool.shutdown()


def scenario_resubmission_is_exactly_once():
    models = [FakeVoice(), FakeVoice()]
    pool = make_pool(models, breaker_threshold=99, probe_interval_s=60)
    try:
        for m in models:
            m.fail = True
        with pytest.raises(RuntimeError, match="injected"):
            pool.submit("doomed").result(timeout=30)
        assert pool.stats["resubmitted"] == 1 and pool.stats["failed"] == 1
    finally:
        pool.shutdown()


def scenario_no_healthy_replicas_sheds_and_flips_readiness():
    health = HealthState()
    models = [FakeVoice(), FakeVoice()]
    pool = make_pool(models, breaker_threshold=1, probe_interval_s=0.5)
    health.add_readiness_gate("replicas:test",
                              lambda: pool.healthy_count() > 0)
    health.set_ready("warmed")
    try:
        for m in models:
            m.fail = True
        with pytest.raises(RuntimeError):
            pool.speak("x", timeout=30)
        assert pool.healthy_count() == 0 and not health.ready
        with pytest.raises(Overloaded):
            pool.submit("y").result(timeout=30)
        for m in models:
            m.fail = False
        assert _wait_for(lambda: health.ready)
    finally:
        pool.shutdown()


def scenario_shutdown_drains_queued_work():
    model = FakeVoice()
    model.gate = threading.Event()
    pool = make_pool([model])
    blocked = pool.submit("in flight")
    queued = pool.submit("queued behind")
    pool.shutdown()
    model.gate.set()
    with pytest.raises(Exception):
        queued.result(timeout=30)
    with pytest.raises(OperationError):
        pool.submit("after shutdown")
    try:
        blocked.result(timeout=30)
    except Exception:
        pass


def scenario_draining_pool_refuses_typed():
    pool = make_pool([FakeVoice(), FakeVoice()])
    try:
        assert len(pool.speak("before", timeout=30).samples) > 0
        pool.start_draining()
        assert pool.draining
        with pytest.raises(Draining, match="draining"):
            pool.submit("after")
    finally:
        pool.shutdown()


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_scenario(name):
    SCENARIOS[name]()


def test_resolve_replicas_count_cards_or_cpu(monkeypatch):
    import torch

    monkeypatch.delenv("SONATA_REPLICAS", raising=False)
    assert resolve_replica_count(None, n_devices=8) == 8
    assert resolve_replica_count(99, n_devices=8) == 8
    monkeypatch.setenv("SONATA_REPLICAS", "2")
    assert resolve_replica_count(None, n_devices=8) == 2
    assert resolve_replica_devices(None, device="cpu") == \
        [torch.device("cpu")] * 2
    assert resolve_replica_devices(3, device="cpu") == \
        [torch.device("cpu")] * 3
    monkeypatch.delenv("SONATA_REPLICAS")
    assert resolve_replica_devices(-1, device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(OperationError, match="CUDA"):
            resolve_replica_devices(None)


@pytest.fixture(scope="module")
def quiet_cfg(tmp_path_factory):
    cfg = write_tiny_voice(tmp_path_factory.mktemp("replicas"), seed=8)
    d = json.loads(cfg.read_text())
    d["inference"] = {"noise_scale": 0.0, "length_scale": 1.0,
                      "noise_w": 0.0}
    cfg.write_text(json.dumps(d))
    return cfg


TEXT = ("Two replicas share this text. Each sentence rides a replica. "
        "The pool gathers them in order.")


def test_two_replica_cpu_pool_matches_one_voice(quiet_cfg):
    voice = PiperVoice.from_config_path(quiet_cfg, device="cpu")
    pool = ReplicaPool.for_voice(voice, 2, name="t",
                                 scheduler_kwargs=SCHED)
    try:
        assert [str(r.device) for r in pool.replicas] == ["cpu", "cpu"]
        assert pool.replicas[1].model._seed == voice._seed + 1
        # one sentence a dispatch on both sides (the pool's schedulers
        # dispatch one item at a time here), so each row is padded alike
        want = [voice.speak_one_sentence(p).samples.to_i16()
                for p in voice.phonemize_text(TEXT)]
        got = [a.samples.to_i16() for a in SpeechSynthesizer(
            voice, replica_pool=pool).synthesize_parallel(TEXT)]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.size > 0
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        assert all(r.dispatches > 0 for r in pool.replicas)
    finally:
        pool.shutdown()
        for r in pool.replicas:
            r.model.close()
        voice.close()


def test_two_replica_cpu_pool_matches_jax_pool(quiet_cfg, monkeypatch):
    """The port's 2-replica CPU pool against the JAX package's 2-replica
    pool (two forced host devices) on the same voice file, each through
    its ``SpeechSynthesizer(replica_pool=)``: the same sentences, the same
    lengths, samples within ±2 int16 LSB (the JAX-against-port bar of the
    batch path).  The JAX voice's frame estimate is pinned to the smallest
    bucket, so its overflow retry lands on the port's exact bucket."""
    from sonata_tpu.models.piper import PiperVoice as JaxVoice
    from sonata_tpu.serving.replicas import ReplicaPool as JaxPool
    from sonata_tpu.synth import SpeechSynthesizer as JaxSynth
    from sonata_tpu.utils.buckets import FRAME_BUCKETS

    monkeypatch.setattr(JaxVoice, "_estimate_frame_bucket",
                        lambda self, weighted_ids: FRAME_BUCKETS[0])
    jvoice = JaxVoice.from_config_path(quiet_cfg)
    voice = PiperVoice.from_config_path(quiet_cfg, device="cpu")
    jpool = JaxPool.for_voice(jvoice, 2, name="j", scheduler_kwargs=SCHED)
    pool = ReplicaPool.for_voice(voice, 2, name="t", scheduler_kwargs=SCHED)
    try:
        assert len({str(r.device) for r in jpool.replicas}) == 2
        want = [a.samples.to_i16() for a in JaxSynth(
            jvoice, replica_pool=jpool).synthesize_parallel(TEXT)]
        got = [a.samples.to_i16() for a in SpeechSynthesizer(
            voice, replica_pool=pool).synthesize_parallel(TEXT)]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.size > 0
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 2
        for p in (pool, jpool):
            assert all(r.dispatches > 0 for r in p.replicas)
    finally:
        for p, v in ((pool, voice), (jpool, jvoice)):
            p.shutdown()
            for r in p.replicas:
                r.model.close()
            v.close()


def test_failpoint_opens_one_breaker_and_resubmits(quiet_cfg):
    voice = PiperVoice.from_config_path(quiet_cfg, device="cpu")
    pool = ReplicaPool.for_voice(voice, 2, name="t", breaker_threshold=1,
                                 probe_interval_s=60,
                                 scheduler_kwargs=SCHED)
    reg = faults.registry()
    try:
        sentence = list(voice.phonemize_text("Failover works."))[0]
        want = voice.speak_batch([sentence])[0].samples.to_i16()
        reg.arm("dispatch.device_call", "error", max_hits=1)
        got = pool.speak(sentence, timeout=60).samples.to_i16()
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() \
            <= 1
        assert pool.stats["resubmitted"] == 1
        assert pool.stats["breaker_opens"] == 1
        assert sorted(r.state for r in pool.replicas) == [CLOSED, OPEN]
        assert pool.healthy_count() == 1
        assert faults.fires_total("dispatch.device_call") >= 1
    finally:
        reg.disarm_all()
        pool.shutdown()
        for r in pool.replicas:
            r.model.close()
        voice.close()
