"""The port's pysonata API against the JAX package's, on one tiny voice
from disk whose noise scales are 0 (the port's ``PiperModel`` loads it
with ``device="cpu"``).

Tolerance: sentence WAVs and streamed chunks the same lengths (the same
chunk boundaries) within ±2 int16 LSB (each chunk's int16 is scaled to its
own peak, over samples that were quantized on the device); properties,
scales and free phonemization identical.
"""

import json

import numpy as np
import pytest

from sonata_tpu import pysonata as jps
from sonata_tpu_torch import pysonata as ps
from sonata_tpu_torch.audio import read_wave_file

from voices import write_tiny_voice

TEXT = "The Python bindings speak. A second sentence follows."


@pytest.fixture(autouse=True)
def exact_jax_frame_bucket(monkeypatch):
    """The port takes each group's exact frame bucket; the JAX voice
    estimates one and retries on overflow.  Its estimate pinned to the
    smallest bucket, every retry lands on the exact bucket, so a stream's
    last window sits where the port's does."""
    from sonata_tpu.models.piper import PiperVoice as JaxVoice
    from sonata_tpu.utils.buckets import FRAME_BUCKETS

    monkeypatch.setattr(JaxVoice, "_estimate_frame_bucket",
                        lambda self, weighted_ids: FRAME_BUCKETS[0])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_tiny_voice(tmp_path_factory.mktemp("pysonata"), seed=9,
                            num_speakers=2,
                            speaker_id_map={"alice": 0, "bob": 1})
    d = json.loads(path.read_text())
    d["inference"] = {"noise_scale": 0.0, "length_scale": 1.0,
                      "noise_w": 0.0}
    path.write_text(json.dumps(d))
    want, got = jps.PiperModel(path), ps.PiperModel(path, device="cpu")
    yield want, got
    got._voice.close()
    want._voice.close()


def _pcm(wave):
    return np.frombuffer(wave.get_wave_bytes(), "<i2").astype(np.int32)


def test_model_surface_matches(models):
    want, got = models
    for attr in ("speakers", "language", "sample_rate",
                 "supports_streaming_output"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert vars(got.get_scales()) == vars(want.get_scales())
    for m in models:
        m.set_speaker("bob")
    assert got.get_speaker() == want.get_speaker() == "bob"
    with pytest.raises(ps.SonataError):
        got.set_speaker("nobody")


@pytest.mark.parametrize("method", ["synthesize", "synthesize_parallel"])
def test_sentences_match(models, method):
    want, got = models
    a = list(getattr(jps.Sonata.with_piper(want), method)(TEXT))
    b = list(getattr(ps.Sonata.with_piper(got), method)(TEXT))
    assert len(a) == len(b) == 2
    for x, y in zip(b, a):
        assert x.sample_rate == y.sample_rate
        assert _pcm(x).shape == _pcm(y).shape
        assert np.abs(_pcm(x) - _pcm(y)).max() <= 2


def test_streamed_chunks_match(models):
    want, got = models
    text = ("A much longer sentence streams through the bindings, so that "
            "its chunk plan cuts it into several windows of audio.")
    a = list(jps.Sonata.with_piper(want).synthesize_streamed(
        text, chunk_size=10))
    b = list(ps.Sonata.with_piper(got).synthesize_streamed(
        text, chunk_size=10))
    assert len(a) == len(b) > 2
    for x, y in zip(b, a):
        assert _pcm(x).shape == _pcm(y).shape
        assert np.abs(_pcm(x) - _pcm(y)).max() <= 2


def test_save_to_file_matches(models, tmp_path):
    want, got = models
    jps.Sonata.with_piper(want).synthesize_to_file(tmp_path / "j.wav", TEXT)
    ps.Sonata.with_piper(got).synthesize_to_file(tmp_path / "p.wav", TEXT)
    a = read_wave_file(tmp_path / "j.wav")[0].astype(np.int32)
    b = read_wave_file(tmp_path / "p.wav")[0].astype(np.int32)
    assert a.shape == b.shape and np.abs(a - b).max() <= 2


def test_free_functions_match():
    for lang in ("en-us", "de", "es"):
        assert ps.phonemize_text("Hello world. Again.", lang) \
            == jps.phonemize_text("Hello world. Again.", lang)
    assert ps.supported_languages() == jps.supported_languages()
