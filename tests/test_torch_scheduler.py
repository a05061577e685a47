"""``BatchScheduler`` over the port's voice.

The scheduler is the JAX package's, copied; its model is the port's
``PiperVoice``.  With zero noise scales a sentence's audio does not depend
on the rows it shares a dispatch with, so the scheduler's WAVs are held
against the same sentences through one ``speak_batch`` call: same lengths,
and within one int16 step of the row's scale (±1 LSB: float32 sums over
other batch shapes move a sample across a rounding boundary of the
batch path's int16 quantize).  Then
the scheduler's serving contracts: shedding when its queue is full, a
deadline dropped before the dispatch, and the CPU pass-through.
"""

import threading
import time

import numpy as np
import pytest

from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.serving import Deadline, DeadlineExceeded, Overloaded
from sonata_tpu_torch.synth import BatchScheduler

from voices import write_tiny_voice

SENTENCES = ["ðɪs ɪz wˈʌn", "ə sˈɛkənd sˈɛntəns hˈɪə",
             "ðə θˈɜːd ɪz ə bˈɪt lˈɒŋɡə ðæn ðə fˈɜːst", "fˈɔː",
             "ænd ə fˈɪfθ wʌn", "sˈɪks ɪz ðə lˈɑːst"]


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    v = PiperVoice.from_config_path(
        write_tiny_voice(tmp_path_factory.mktemp("sched"), seed=11),
        device="cpu")
    sc = v.get_fallback_synthesis_config()
    sc.noise_w = sc.noise_scale = 0.0
    v.set_fallback_synthesis_config(sc)
    yield v
    v.close()


def test_scheduler_wavs_match_one_speak_batch(voice):
    want = voice.speak_batch(SENTENCES)
    sched = BatchScheduler(voice, max_batch=4, max_wait_ms=50.0)
    got = [None] * len(SENTENCES)
    barrier = threading.Barrier(len(SENTENCES), timeout=10)

    def run(i):
        barrier.wait()
        got[i] = sched.speak(SENTENCES[i], timeout=60)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(SENTENCES))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stats = sched.stats_view()
    finally:
        sched.shutdown()
    assert stats["requests"] == len(SENTENCES)
    assert stats["dispatches"] < len(SENTENCES)  # sentences coalesced
    assert stats["coalescing_ratio"] > 1.0
    for g, w in zip(got, want):
        assert len(g.samples) == len(w.samples) > 0
        step = max(float(np.abs(w.samples.data).max()), 0.01) / 32767.0
        assert np.abs(g.samples.data - w.samples.data).max() <= step + 1e-7


def test_scheduler_sheds_when_its_queue_is_full(voice):
    gate = threading.Event()
    real = voice.speak_batch

    def held(*args, **kwargs):
        gate.wait(10)
        return real(*args, **kwargs)

    sched = BatchScheduler(voice, max_batch=1, max_wait_ms=0.0, max_queue=2)
    sched._model = type("Held", (), {"speak_batch": staticmethod(held),
                                     "get_speakers": voice.get_speakers})()
    try:
        first = sched.submit(SENTENCES[0])
        time.sleep(0.1)  # the worker holds the first in its dispatch
        queued = [sched.submit(SENTENCES[1]), sched.submit(SENTENCES[2])]
        with pytest.raises(Overloaded):
            sched.submit(SENTENCES[3])
        assert sched.stats["shed"] == 1
        gate.set()
        for fut in [first, *queued]:
            assert len(fut.result(timeout=30).samples) > 0
    finally:
        gate.set()
        sched.shutdown()


def test_scheduler_drops_dead_requests_before_the_dispatch(voice):
    sched = BatchScheduler(voice, max_batch=4, max_wait_ms=0.0)
    try:
        with pytest.raises(DeadlineExceeded):
            sched.submit(SENTENCES[0], deadline=Deadline.after(-1.0))
        with pytest.raises(OperationError, match="single-speaker"):
            sched.submit(SENTENCES[0], speaker=2)
        assert sched.stats["expired"] == 1
        assert len(sched.speak(SENTENCES[0], timeout=30).samples) > 0
    finally:
        sched.shutdown()
    with pytest.raises(OperationError, match="shut down"):
        sched.submit(SENTENCES[0])


def test_cpu_policy_passes_each_request_through(voice):
    sched = BatchScheduler(voice)  # knobs from the voice's CPU policy
    try:
        assert sched._max_batch == 1 and sched._max_wait == 0.0
        for s in SENTENCES[:2]:
            sched.speak(s, timeout=30)
        view = sched.stats_view()
        assert view["dispatches"] == view["requests"] == 2
        assert view["coalescing_ratio"] == 1.0
    finally:
        sched.shutdown()
