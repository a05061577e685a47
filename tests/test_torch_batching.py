"""The port's batching engines and stream coalescers.

First the engine-only scenarios of ``tests/test_batching.py`` against the
port's copy of the batching core (``sonata_tpu_torch.synth.batching``):
gather, keyed groups, deadline drop before pack, crash containment, close
and drain, join/submit/retire — fake dispatches, no device.

Then the three coalescers on a CPU voice against the JAX voice, in dispatch
and iteration mode: both voices load the same tiny voice with zero noise
scales and one explicit coalescing policy whose stage window is long enough
that the streams, started together, form one stage group.  The JAX voice's
frame estimate is pinned to the smallest bucket, so its overflow retry
lands on the exact bucket the port computes; then every stream's chunks
must have the JAX voice's boundaries and lie within one int16 step of the
chunk's scale (±1 LSB) of its samples.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from sonata_tpu.models import PiperVoice as JaxVoice
from sonata_tpu.utils.dispatch_policy import DispatchPolicy as JaxPolicy
from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.serving import Deadline, DeadlineExceeded
from sonata_tpu_torch.synth.batching import (
    BatchingCore,
    IterationLoop,
    SchedulerCrashed,
    WorkItem,
)
from sonata_tpu_torch.utils.buckets import FRAME_BUCKETS, TEXT_BUCKETS, \
    bucket_for
from sonata_tpu_torch.utils.dispatch_policy import DispatchPolicy

from voices import write_tiny_voice


# ---------------------------------------------------------------------------
# BatchingCore (fake dispatch)
# ---------------------------------------------------------------------------

def test_core_gathers_keyed_groups_and_requeues_leftovers():
    groups = []
    done = threading.Event()

    def dispatch(items):
        groups.append([i.key for i in items])
        for i in items:
            i.future.set_result(i.payload)
        if sum(len(g) for g in groups) == 6:
            done.set()

    core = BatchingCore(dispatch=dispatch, max_batch=8, max_wait_s=0.2,
                        name="test_core", keyed=True)
    try:
        items = [WorkItem(n, key="a" if n % 2 == 0 else "b")
                 for n in range(6)]
        for item in items:
            core.put(item)
        assert done.wait(10)
        for item in items:
            assert item.future.result(timeout=5) == item.payload
        assert all(len(set(g)) == 1 for g in groups)  # never mixed
        assert max(len(g) for g in groups) > 1  # and gathered
    finally:
        core.shutdown()


def test_core_drops_dead_items_before_packing():
    packed = []

    def dispatch(items):
        packed.append([i.payload for i in items])
        for i in items:
            i.future.set_result(i.payload)

    core = BatchingCore(dispatch=dispatch, max_batch=8, max_wait_s=0.1,
                        name="test_core", drop_dead=True)
    try:
        expired = Deadline.after(0.001)
        time.sleep(0.01)
        cancelled = Deadline.after(30)
        cancelled.cancel()
        items = [WorkItem("dead", deadline=expired),
                 WorkItem("gone", deadline=cancelled),
                 WorkItem("live", deadline=Deadline.after(30))]
        for item in items:
            core.put(item)
        assert items[2].future.result(timeout=10) == "live"
        with pytest.raises(DeadlineExceeded):
            items[0].future.result(timeout=10)
        assert items[1].future.cancelled()
        assert packed == [["live"]]
        assert core.stats["expired"] == 1 and core.stats["cancelled"] == 1
    finally:
        core.shutdown()


def test_core_crash_fails_gathered_and_queued_typed():
    crashed = []
    core = BatchingCore(dispatch=lambda items: None, max_batch=4,
                        max_wait_s=0.05, name="test_core", drop_dead=True,
                        on_crash=lambda err, items: crashed.append(len(items)))

    class _BadDeadline:
        cancelled = False

        def alive(self):
            raise RuntimeError("deadline check exploded")

    item = WorkItem("x", deadline=_BadDeadline())
    core.put(item)
    with pytest.raises(SchedulerCrashed):
        item.future.result(timeout=10)
    assert crashed and crashed[0] >= 1
    core.shutdown()


def test_core_dispatch_error_fails_only_that_group():
    def dispatch(items):
        if items[0].key == "bad":
            raise RuntimeError("device on fire")
        for i in items:
            i.future.set_result("ok")

    core = BatchingCore(dispatch=dispatch, max_batch=8, max_wait_s=0.05,
                        name="test_core", keyed=True)
    try:
        bad = WorkItem(0, key="bad")
        core.put(bad)
        with pytest.raises(RuntimeError, match="on fire"):
            bad.future.result(timeout=10)
        good = WorkItem(1, key="good")
        core.put(good)
        assert good.future.result(timeout=10) == "ok"
    finally:
        core.shutdown()


def test_core_close_fails_pending_futures():
    gate = threading.Event()

    def dispatch(items):
        gate.wait(10)
        raise RuntimeError("never mind")

    core = BatchingCore(dispatch=dispatch, max_batch=1, max_wait_s=0.0,
                        name="test_core", closed_reason="engine closed")
    first = WorkItem("occupies the worker")
    core.put(first)
    time.sleep(0.05)
    queued = WorkItem("stuck in queue")
    core.put(queued)
    gate.set()
    core.shutdown()
    for item in (first, queued):
        with pytest.raises(Exception):
            item.future.result(timeout=5)
    late = WorkItem("after close")
    core.put(late)
    with pytest.raises(OperationError, match="engine closed"):
        late.future.result(timeout=5)


# ---------------------------------------------------------------------------
# IterationLoop (fake dispatch)
# ---------------------------------------------------------------------------

def _echo_loop(batches, max_batch=8, **kwargs):
    def dispatch(key, payloads, b):
        batches.append((key, len(payloads), b))
        return list(payloads), {"frame_bucket": key}

    return IterationLoop(dispatch, max_batch=max_batch, name="test_iter",
                         **kwargs)


def _wait_for(cond, timeout=5.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


def test_iteration_join_submit_retire():
    batches = []
    loop = _echo_loop(batches)
    try:
        h = loop.join()
        futs = [loop.submit(h, 16, f"row{i}") for i in range(3)]
        assert [f.result(timeout=10) for f in futs] == \
            ["row0", "row1", "row2"]
        loop.retire(h)
        assert _wait_for(lambda: loop.resident_streams == 0)
        assert loop.stats["joined"] == 1 and loop.stats["retired"] == 1
    finally:
        loop.close()


def test_iteration_rows_share_an_iteration_at_the_graduated_bucket():
    batches = []
    in_flight, release = threading.Event(), threading.Event()

    def dispatch(key, payloads, b):
        in_flight.set()
        release.wait(10)
        batches.append((len(payloads), b))
        return list(payloads), {}

    loop = IterationLoop(dispatch, max_batch=8, name="test_iter")
    try:
        warm = loop.join()
        f0 = loop.submit(warm, 16, "warm")
        assert in_flight.wait(10)  # iteration 1 pinned in flight
        handles = [loop.join() for _ in range(3)]  # joins mid-flight
        futs = [loop.submit(h, 16, i) for i, h in enumerate(handles)]
        release.set()
        for f in [f0, *futs]:
            f.result(timeout=10)
        assert (3, 4) in batches, batches  # 3 rows pad to 4, not 8
    finally:
        loop.close()


def test_iteration_deadline_expiry_fails_only_that_stream():
    loop = _echo_loop([])
    try:
        good = loop.join()
        doomed = loop.join(deadline=Deadline.after(0.01))
        time.sleep(0.05)
        f_doomed = loop.submit(doomed, 16, "dead")
        f_good = loop.submit(good, 16, "alive")
        assert f_good.result(timeout=10) == "alive"
        with pytest.raises(DeadlineExceeded):
            f_doomed.result(timeout=10)
        assert loop.stats["expired"] == 1
    finally:
        loop.close()


def test_iteration_drain_retires_the_loop_at_a_boundary():
    loop = _echo_loop([])
    h = loop.join()
    fut = loop.submit(h, 16, "last row")
    loop.start_draining()
    assert fut.result(timeout=10) == "last row"
    loop.retire(h)
    loop._thread.join(timeout=10)
    assert not loop._thread.is_alive()
    with pytest.raises(OperationError, match="draining"):
        loop.join()
    assert isinstance(loop.submit(h, 16, "late").exception(timeout=5),
                      OperationError)
    loop.close()


def test_iteration_close_fails_pending_typed():
    gate = threading.Event()

    def dispatch(key, payloads, b):
        gate.wait(10)
        return list(payloads), {}

    loop = IterationLoop(dispatch, max_batch=8, name="test_iter")
    h = loop.join()
    first = loop.submit(h, 16, "in flight")
    time.sleep(0.05)
    pending = loop.submit(h, 32, "pending other width")
    gate.set()
    loop.close()
    for fut in (first, pending):
        try:
            fut.result(timeout=5)
        except Exception as e:
            assert isinstance(e, OperationError) or fut.cancelled()
    with pytest.raises(OperationError, match="closed"):
        loop.submit(h, 16, "after close").result(timeout=5)


def test_iteration_two_phase_finish_and_dispatch_error():
    def dispatch(key, payloads, b):
        if key == "boom":
            raise RuntimeError("iteration dispatch failed")
        return list(payloads), {}

    loop = IterationLoop(dispatch, max_batch=8, name="test_iter",
                         finish=lambda ticket: [p.upper() for p in ticket],
                         pipeline=True)
    try:
        h = loop.join()
        with pytest.raises(RuntimeError, match="iteration dispatch"):
            loop.submit(h, "boom", "x").result(timeout=10)
        assert loop.submit(h, "fine", "y").result(timeout=10) == "Y"
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# the coalescers on a CPU voice, against the JAX voice
# ---------------------------------------------------------------------------

#: four sentences of one text bucket, so their starts share a stage group
PHRASES = ["ðɪs ɪz ðə fˈɜːst stɹˈiːm ɒv sˈɪŋɡəl spˈiːtʃ",
           "ə sˈɛkənd stɹˈiːm dʒˈɔɪnz ðə sˈeɪm ɡɹˈuːp hˈɪə",
           "ðə θˈɜːd wʌn ɪz ə bˈɪt lˈɒŋɡə ðæn ðə ˈʌðəz",
           "ænd ðə fˈɔːθ stɹˈiːm fˈɪnɪʃɪz ðə wˈeɪv nˈaʊ"]
N = len(PHRASES)
STAGE_WAIT_MS = 20000.0  # the group closes when all N starts arrived


def _zero_noise(voice) -> None:
    sc = voice.get_fallback_synthesis_config()
    sc.noise_w = 0.0
    sc.noise_scale = 0.0
    voice.set_fallback_synthesis_config(sc)


def _run_streams(voice, chunk_size=8, chunk_padding=2) -> list:
    out = [None] * N
    barrier = threading.Barrier(N, timeout=30)

    def run(i):
        barrier.wait()
        out[i] = list(voice.stream_synthesis(PHRASES[i], chunk_size,
                                             chunk_padding))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def voice_path(tmp_path_factory):
    return write_tiny_voice(tmp_path_factory.mktemp("coalesce"), seed=7)


@pytest.mark.parametrize("mode", ["dispatch", "iteration"])
def test_coalesced_streams_match_the_jax_voice(voice_path, monkeypatch,
                                               mode):
    monkeypatch.setenv("SONATA_BATCH_MODE", mode)
    monkeypatch.setenv("SONATA_DISPATCH_POLICY", "on")
    knobs = dict(coalesce=True, source="test", stream_decode_max_batch=4,
                 stream_decode_max_wait_ms=5.0, stream_stage_max_batch=N,
                 stream_stage_max_wait_ms=STAGE_WAIT_MS)
    jax_voice = JaxVoice.from_config_path(
        voice_path, dispatch_policy=JaxPolicy(backend="cpu", **knobs))
    port_voice = PiperVoice.from_config_path(
        voice_path, device="cpu",
        dispatch_policy=DispatchPolicy(backend="cpu", **knobs))
    for v in (jax_voice, port_voice):
        _zero_noise(v)
    ids = [port_voice._encode_phonemes(p) for p in PHRASES]
    assert len({bucket_for(len(i), TEXT_BUCKETS) for i in ids}) == 1
    # the JAX voice's overflow retry then lands on the exact bucket
    jax_voice._estimate_frame_bucket = lambda weighted: FRAME_BUCKETS[0]
    try:
        want = _run_streams(jax_voice)
        jax_stats = jax_voice.dispatch_stats()
    finally:
        jax_voice.close()
    try:
        got = _run_streams(port_voice)
        stats = port_voice.dispatch_stats()
    finally:
        port_voice.close()

    assert stats["batch_mode"] == mode
    stage = stats["stream_stage"]
    assert stage["dispatches"] == 1 and stage["requests"] == N
    assert stage["coalescing_ratio"] == jax_stats["stream_stage"][
        "coalescing_ratio"] == N
    decode = stats["iteration" if mode == "iteration" else "stream_decode"]
    assert decode["requests"] == sum(len(c) for c in got)
    assert decode["dispatches"] < decode["requests"]  # windows shared
    for g_, w_ in zip(got, want):
        assert [len(c.samples) for c in g_] == [len(c.samples) for c in w_]
        assert len(g_) > 2
        for gc, wc in zip(g_, w_):
            step = max(float(np.abs(wc.samples.data).max()), 0.01) / 32767.0
            assert np.abs(gc.samples.data - wc.samples.data).max() \
                <= step + 1e-7


def test_closed_voice_refuses_streams_and_engines_fail_typed(voice_path,
                                                             monkeypatch):
    monkeypatch.setenv("SONATA_BATCH_MODE", "iteration")
    monkeypatch.setenv("SONATA_DISPATCH_POLICY", "on")
    voice = PiperVoice.from_config_path(voice_path, device="cpu")
    assert voice.dispatch_policy.coalesce
    chunks = list(voice.stream_synthesis(PHRASES[0], 8, 2))
    assert chunks
    decoder = voice._stream_decoder
    voice.start_draining()
    with pytest.raises(OperationError, match="draining"):
        decoder.join()
    voice.close()
    voice.close()  # idempotent
    with pytest.raises(OperationError, match="closed"):
        list(voice.stream_synthesis(PHRASES[0], 8, 2))
    assert voice.speak_batch([PHRASES[0]])[0].samples.data.size > 0


def test_engine_failure_reaches_the_stream(voice_path, monkeypatch):
    """No fallback: a failing window decode raises through the stream."""
    monkeypatch.setenv("SONATA_BATCH_MODE", "dispatch")
    voice = PiperVoice.from_config_path(voice_path, device="cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    voice._decode_windows = broken
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            list(voice.stream_synthesis(PHRASES[0], 8, 2))
    finally:
        voice.close()
