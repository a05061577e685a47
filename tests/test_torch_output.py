"""Prosody output of the PyTorch port against the JAX package.

``process_prosody`` and ``AudioOutputConfig.apply`` get the same seeded
numpy signal as ``sonata_tpu.synth.output``, over a grid of rate, pitch,
volume and appended silence, in both arms: the C++ WSOLA library (the port
builds its own copy of ``sonata_dsp.cpp`` with ``g++``) and the numpy arm
(the library taken away in both packages).  The same source and the same
float32 inputs give the same samples: tolerance 1e-6 absolute (the C++
arm is compiled twice, by the same compiler and flags; the numpy arm is the
same code).  A voice with an output config is held against the JAX
synthesizer at ±2 int16 LSB, as ``test_torch_piper.py`` holds the batch
path.
"""

import numpy as np
import pytest

from sonata_tpu.synth import SpeechSynthesizer as JaxSynthesizer
from sonata_tpu.synth import output as jax_output
from sonata_tpu.models import PiperVoice as JaxVoice
from sonata_tpu_torch.audio import AudioSamples, read_wave_file
from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.native import build as native_build
from sonata_tpu_torch.synth import SpeechSynthesizer, output
from sonata_tpu_torch.synth.output import AudioOutputConfig

from test_torch_piper import TEXT, reference_sampler
from voices import write_tiny_voice

RATE = 22050
ATOL = 1e-6
#: (speed, pitch, volume) on either side of 1, and each alone
GRID = [(1.0, 1.0, 0.5), (2.0, 1.0, 1.0), (0.6, 1.0, 1.0),
        (1.0, 1.3, 1.0), (1.0, 0.7, 0.8), (1.7, 1.2, 0.3),
        (0.8, 0.6, 1.0)]


def _signal(seed: int = 0, n: int = 5000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    return (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(params=["cpp", "numpy"])
def arm(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(output, "load_dsp_library", lambda: None)
        monkeypatch.setattr(jax_output, "load_dsp_library", lambda: None)
    else:
        assert output.load_dsp_library() is not None, "g++ build failed"
        assert jax_output.load_dsp_library() is not None
    return request.param


@pytest.mark.parametrize("speed,pitch,volume", GRID)
def test_process_prosody_matches_reference(arm, speed, pitch, volume):
    x = _signal()
    before = dict(output.process_prosody.arms)
    got = output.process_prosody(x, RATE, speed=speed, pitch=pitch,
                                 volume=volume)
    want = jax_output.process_prosody(x, RATE, speed=speed, pitch=pitch,
                                      volume=volume)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the arm that served the call is the one counted
    moved = {k: output.process_prosody.arms[k] - before[k] for k in before}
    assert moved == {"cpp": int(arm == "cpp"), "numpy": int(arm == "numpy")}


@pytest.mark.parametrize("cfg", [
    dict(rate=30, volume=80, pitch=60, appended_silence_ms=200),
    dict(rate=10, pitch=20),
    dict(volume=40, appended_silence_ms=50),
    dict(appended_silence_ms=120),
    dict(),
])
def test_output_config_apply_matches_reference(arm, cfg):
    x = _signal(seed=1, n=3000)
    got = AudioOutputConfig(**cfg).apply(AudioSamples(x), RATE)
    want = jax_output.AudioOutputConfig(**cfg).apply(
        jax_output.AudioSamples(x), RATE)
    assert len(got) == len(want.data)
    np.testing.assert_allclose(got.data, want.data, atol=ATOL, rtol=0)
    assert output.percent_to_param(37, *output.RATE_RANGE) == \
        jax_output.percent_to_param(37, *jax_output.RATE_RANGE)


def test_stream_normalization_is_checked():
    with pytest.raises(ValueError, match="stream_normalization"):
        AudioOutputConfig(stream_normalization="loud")
    assert AudioOutputConfig(stream_normalization="global")


def test_dsp_library_builds_outside_the_package(tmp_path, monkeypatch):
    """The builder writes under its build root, keyed by the source's hash,
    never next to the source, and reuses an unchanged build."""
    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path)
    src = tmp_path / "dsp.cpp"
    src.write_text(native_build.SRC.read_text(encoding="utf-8"))
    first = native_build.build(src)
    assert first.parent.parent == tmp_path and first.exists()
    assert native_build.build(src) == first
    src.write_text(src.read_text() + "\n// edited\n")
    assert native_build.build(src) != first
    assert not list(native_build.SRC.parent.glob("*.so"))


@pytest.mark.parametrize("normalization", [None, "global"])
def test_synthesizer_output_config_matches_reference(tmp_path, normalization):
    (tmp_path / "voice").mkdir()
    cfg_path = write_tiny_voice(tmp_path / "voice", seed=3)
    config = dict(rate=30, volume=80, pitch=60, appended_silence_ms=200,
                  stream_normalization=normalization)
    jax_voice = JaxVoice.from_config_path(cfg_path)
    try:
        JaxSynthesizer(jax_voice).synthesize_to_file(
            tmp_path / "jax.wav", TEXT, jax_output.AudioOutputConfig(**config))
    finally:
        jax_voice.close()
    port_voice = PiperVoice.from_config_path(cfg_path, device="cpu",
                                             sampler=reference_sampler(0))
    synth = SpeechSynthesizer(port_voice)
    synth.synthesize_to_file(tmp_path / "port.wav", TEXT,
                             AudioOutputConfig(**config))
    synth.close()
    want, _, _ = read_wave_file(tmp_path / "jax.wav")
    got, _, _ = read_wave_file(tmp_path / "port.wav")
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_output_config_type_is_checked(tmp_path):
    voice = PiperVoice.from_config_path(
        write_tiny_voice(tmp_path, seed=3), device="cpu")
    synth = SpeechSynthesizer(voice)
    with pytest.raises(OperationError, match="AudioOutputConfig"):
        synth.synthesize_streamed("Hi.", 45)
    global_chunks = list(synth.synthesize_streamed(
        "Hello there.", AudioOutputConfig(
            volume=50, stream_normalization="global"),
        chunk_size=8, chunk_padding=1))
    assert global_chunks and not any(c.samples.peak_normalize
                                     for c in global_chunks)
    synth.close()
