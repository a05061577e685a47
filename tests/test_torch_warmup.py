"""The port's warm-up lattice against the JAX package's.

- ``lattice_shapes`` in ``full``, ``minimal`` and ``off``, in dispatch and
  iteration mode, equals the JAX voice's for the same dispatch policy,
  fallback config and frames-per-id (identical lists);
- the copied ``warm_model_lattice`` keeps its budget and progress
  behaviour on a port voice;
- after the lattice, the first dispatch of a warmed shape on the serving
  thread is annotated ``compile="cached"``, and one of a shape it did not
  warm ``"cold"`` (the annotations the scope counts).
"""

import time

import pytest

from sonata_tpu.models import PiperVoice as JaxVoice
from sonata_tpu.utils.dispatch_policy import DispatchPolicy as JaxPolicy
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.serving import scope as scope_mod
from sonata_tpu_torch.serving import warmup
from sonata_tpu_torch.synth import BatchScheduler, SpeechSynthesizer
from sonata_tpu_torch.utils.dispatch_policy import DispatchPolicy
from sonata_tpu_torch.utils.buckets import TEXT_BUCKETS, bucket_for
from voices import write_tiny_voice

KNOBS = [
    dict(coalesce=False, source="test", stream_decode_max_batch=1,
         stream_stage_max_batch=1, scheduler_max_batch=1,
         scheduler_max_wait_ms=0.0),
    dict(coalesce=True, source="test"),
    dict(coalesce=True, source="test", stream_decode_max_batch=4,
         scheduler_max_batch=12),
]


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return write_tiny_voice(tmp_path_factory.mktemp("warmup"), seed=6)


@pytest.mark.parametrize("knobs", KNOBS, ids=["per-request", "coalescing",
                                              "narrow"])
@pytest.mark.parametrize("batch_mode", ["dispatch", "iteration"])
@pytest.mark.parametrize("fpi,length_scale", [(2.5, 1.0), (3.913, 1.3),
                                              (11.0, 0.7)])
def test_lattice_shapes_equal_jax(cfg, monkeypatch, knobs, batch_mode, fpi,
                                  length_scale):
    monkeypatch.setenv("SONATA_BATCH_MODE", batch_mode)
    jax_voice = JaxVoice.from_config_path(
        cfg, dispatch_policy=JaxPolicy(backend="cpu", **knobs))
    port_voice = PiperVoice.from_config_path(
        cfg, device="cpu", dispatch_policy=DispatchPolicy(backend="cpu",
                                                          **knobs))
    try:
        for v in (jax_voice, port_voice):
            v._frames_per_id = fpi
            v._fpi_observed = True
            sc = v.get_fallback_synthesis_config()
            sc.length_scale = length_scale
            v.set_fallback_synthesis_config(sc)
        for mode in ("full", "minimal", "off"):
            want = jax_voice.lattice_shapes(mode)
            got = port_voice.lattice_shapes(mode)
            assert got == want, mode
            assert (len(got) > 0) == (mode != "off")
    finally:
        jax_voice.close()
        port_voice.close()


def test_frames_per_id_observed_as_the_reference(cfg):
    """The calibration rule: the first observation replaces the prior with
    a 15% margin, later ones a decaying upper bound; the estimate is the
    reference's."""
    jax_voice = JaxVoice.from_config_path(cfg)
    port_voice = PiperVoice.from_config_path(cfg, device="cpu")
    try:
        for weighted, frames in ((40.0, 97), (12.5, 41), (60.0, 100)):
            for v in (jax_voice, port_voice):
                v._observe_frames(weighted, frames)
            assert port_voice._frames_per_id == jax_voice._frames_per_id
            for w in (1, 17.5, 300):
                assert port_voice._estimate_frame_bucket(w) \
                    == jax_voice._estimate_frame_bucket(w)
        # a real utterance feeds the estimate
        fresh = PiperVoice.from_config_path(cfg, device="cpu")
        assert fresh._fpi_observed is False
        fresh.speak_batch(list(fresh.phonemize_text("Calibrate me.")))
        assert fresh._fpi_observed is True
        fresh.close()
    finally:
        jax_voice.close()
        port_voice.close()


@pytest.fixture
def dispatches(monkeypatch):
    """Every dispatch the scheduler or the iteration loop reports to the
    scope plane, as its attrs."""
    seen = []
    real = scope_mod.note_dispatch

    def note(duration_s, attrs):
        seen.append(dict(attrs))
        real(duration_s, attrs)

    monkeypatch.setattr(scope_mod, "note_dispatch", note)
    return seen


def _coalescing_voice(cfg):
    return PiperVoice.from_config_path(
        cfg, device="cpu",
        dispatch_policy=DispatchPolicy(backend="cpu", coalesce=True,
                                       source="test",
                                       stream_stage_max_wait_ms=1.0,
                                       scheduler_max_wait_ms=1.0))


def test_budget_and_progress(cfg):
    voice = _coalescing_voice(cfg)
    try:
        progress = warmup.WarmupProgress()
        progress.reset()
        with pytest.raises(warmup.WarmupBudgetExceeded):
            warmup.warm_model_lattice(voice, mode="minimal",
                                      deadline=time.monotonic() - 1.0,
                                      progress=progress, label="v")
        snap = progress.snapshot()
        assert snap["total"] == len(voice.lattice_shapes("minimal")) > 0
        assert snap["done"] == 0 and progress.fraction() == 0.0
        assert warmup.warm_model_lattice(voice, mode="off",
                                         deadline=time.monotonic()) == 0
        progress.reset()
        n = warmup.warm_model_lattice(voice, mode="minimal",
                                      deadline=time.monotonic() + 600,
                                      progress=progress, workers=2)
        assert n == progress.snapshot()["done"] == progress.snapshot()["total"]
        progress.finish()
        assert progress.fraction() == 1.0
    finally:
        voice.close()


def test_warmed_shapes_dispatch_cached_unwarmed_cold(cfg, monkeypatch,
                                                     dispatches):
    monkeypatch.setenv("SONATA_BATCH_MODE", "iteration")
    voice = _coalescing_voice(cfg)
    sched = BatchScheduler(voice, max_batch=4, max_wait_ms=1.0)
    voice.attach_batch_worker(lambda: sched)
    try:
        warm_ph = list(voice.phonemize_text("A sentence for the lattice."))[0]
        cold_ph = list(voice.phonemize_text(
            "A much longer sentence, whose ids land in another text bucket "
            "than the first one did, so its shape was never warmed at "
            "all."))[0]
        t_warm = bucket_for(len(voice._encode_phonemes(warm_ph)),
                            TEXT_BUCKETS)
        t_cold = bucket_for(len(voice._encode_phonemes(cold_ph)),
                            TEXT_BUCKETS)
        assert t_warm != t_cold
        # calibration on this (non-serving) thread finds the frame bucket
        voice.speak_batch([warm_ph])
        _engine, shape, thread = voice.first_uses[-1]
        assert shape[:2] == (1, t_warm) and thread == "MainThread"
        voice.warm_shape(shape)
        assert ("batch", shape) in voice.warmed_shapes
        for width in (64, 128, 256):
            voice.warm_shape(("wdec", width, 1, False))
        dispatches.clear()
        sched.speak(warm_ph)
        assert [d["compile"] for d in dispatches] == ["cached"]
        assert (dispatches[0]["batch_bucket"], dispatches[0]["text_bucket"],
                dispatches[0]["frame_bucket"]) == shape
        sched.speak(cold_ph)
        assert dispatches[-1]["compile"] == "cold"
        assert dispatches[-1]["text_bucket"] == t_cold
        # a lone stream after its widths were warmed: every iteration is
        # batch 1 at a warmed width, on the loop's thread
        dispatches.clear()
        list(SpeechSynthesizer(voice).synthesize_streamed(
            "Short one.", chunk_size=20, chunk_padding=3))
        rows = [d for d in dispatches if d.get("mode") == "iteration"]
        assert rows and all(d["compile"] == "cached" for d in rows)
        assert not any(u[0] == "window" and u[2] != "sonata_iter_decode"
                       for u in voice.first_uses)
    finally:
        sched.shutdown()
        voice.close()


def test_unwarmed_iteration_is_cold(cfg, monkeypatch, dispatches):
    monkeypatch.setenv("SONATA_BATCH_MODE", "iteration")
    voice = _coalescing_voice(cfg)
    try:
        list(SpeechSynthesizer(voice).synthesize_streamed(
            "Short one.", chunk_size=20, chunk_padding=3))
        rows = [d for d in dispatches if d.get("mode") == "iteration"]
        assert rows[0]["compile"] == "cold"
    finally:
        voice.close()


def test_prewarm_warms_the_serving_threads(cfg, monkeypatch):
    """``prewarm`` (the server's ``--prewarm``): a representative batch
    through the attached worker, its neighbour frame buckets, one drained
    stream per text bucket and the other batch sizes of every stream
    shape, each on the thread that serves it."""
    monkeypatch.setenv("SONATA_BATCH_MODE", "iteration")
    voice = _coalescing_voice(cfg)
    sched = BatchScheduler(voice, max_batch=4, max_wait_ms=1.0)
    voice.attach_batch_worker(lambda: sched)
    try:
        n = voice.prewarm(texts=["Short one.", "A slightly longer warm "
                                 "sentence for the prewarm."],
                          streaming=True, chunk_size=12, chunk_padding=2)
        assert n > 0
        threads = {(e, name) for e, _s, name in voice.first_uses}
        assert ("batch", "sonata_batcher") in threads
        assert ("stage", "sonata_stream_stages") in threads
        assert ("window", "sonata_iter_decode") in threads
        batch = {s for e, s in voice.warmed_shapes if e == "batch"}
        assert batch  # neighbour frame buckets, through the worker
        rungs = {s[1] for e, s in voice.warmed_shapes if e == "window"}
        assert rungs == {1, 2, 4, 8}
    finally:
        sched.shutdown()
        voice.close()
