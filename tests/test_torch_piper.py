"""PyTorch port vs JAX reference: whole voices, batch and streaming.

Both packages load the same tiny voice from disk (``write_tiny_voice``:
config JSON + ``.npz`` weights).  The port's noise sampler is replaced by
one that hands it the reference's own draws — ``vits.per_row_normal``
under the key the JAX voice uses for the same dispatch (its
``_next_rng``, split into the duration and prior keys) — so the two
voices synthesize from identical noise.

Tolerances: the batch WAV within ±2 int16 LSB with identical lengths (the
float32 decode differs by ~1e-6 before a per-utterance peak scaling and a
truncating int16 conversion); streamed chunks with identical boundaries
and samples within one int16 step of the chunk's scale (±1 LSB).
"""

import jax
import numpy as np
import pytest
import torch

from sonata_tpu.models import PiperVoice as JaxVoice
from sonata_tpu.models import vits as jvits
from sonata_tpu.synth import SpeechSynthesizer as JaxSynthesizer
from sonata_tpu_torch.audio import read_wave_file
from sonata_tpu_torch.core import OperationError
from sonata_tpu_torch.models import PiperVoice
from sonata_tpu_torch.models.piper import DUR_NOISE
from sonata_tpu_torch.synth import SpeechSynthesizer
from voices import write_tiny_voice

TEXT = ("The quick brown fox jumps over the lazy dog. Hello there! "
        "Streaming synthesis turns text into audio, one chunk at a time.")
STREAM_SENTENCE = ("This is a longer sentence, so that the streaming "
                   "path has to cut it into several chunks of audio.")


def reference_sampler(seed: int):
    """The JAX voice's noise for dispatch ``counter``: the key of its
    ``_next_rng``, split as its stages split it."""
    def sample(counter, stream, shape):
        mixed = (seed * 0x9E3779B1 + counter) & 0xFFFFFFFF
        keys = jax.random.split(jax.random.PRNGKey(np.uint32(mixed)))
        key = keys[0] if stream == DUR_NOISE else keys[1]
        return torch.from_numpy(np.array(jvits.per_row_normal(key, shape)))

    return sample


@pytest.fixture(scope="module")
def voice_paths(tmp_path_factory):
    single = tmp_path_factory.mktemp("single")
    multi = tmp_path_factory.mktemp("multi")
    return {
        "single": write_tiny_voice(single, seed=3),
        "multi": write_tiny_voice(multi, seed=4, num_speakers=4,
                                  speaker_id_map={f"spk{i}": i
                                                  for i in range(4)}),
    }


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_synthesize_to_file_matches_reference(voice_paths, tmp_path, kind):
    cfg = voice_paths[kind]
    jax_voice = JaxVoice.from_config_path(cfg)
    port_voice = PiperVoice.from_config_path(
        cfg, device="cpu", sampler=reference_sampler(0))
    if kind == "multi":
        for v in (jax_voice, port_voice):
            sc = v.get_fallback_synthesis_config()
            sc.speaker = ("spk2", 2)
            v.set_fallback_synthesis_config(sc)
    try:
        JaxSynthesizer(jax_voice).synthesize_to_file(tmp_path / "jax.wav",
                                                     TEXT)
    finally:
        jax_voice.close()
    SpeechSynthesizer(port_voice).synthesize_to_file(tmp_path / "port.wav",
                                                     TEXT)
    want, want_rate, _ = read_wave_file(tmp_path / "jax.wav")
    got, got_rate, _ = read_wave_file(tmp_path / "port.wav")
    assert got_rate == want_rate
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 2


def test_speak_batch_per_row_speakers_and_scales(voice_paths):
    """Per-row speaker ids and per-row scales reach the rows they belong
    to, exactly as in the reference."""
    cfg = voice_paths["multi"]
    jax_voice = JaxVoice.from_config_path(cfg)
    port_voice = PiperVoice.from_config_path(
        cfg, device="cpu", sampler=reference_sampler(0))
    phonemes = list(port_voice.phonemize_text(TEXT))
    speakers = [3, None, 1]
    scales = [None, port_voice.get_fallback_synthesis_config(), None]
    scales[1].length_scale = 1.4
    try:
        want = jax_voice.speak_batch(phonemes, speakers=speakers,
                                     scales=scales)
    finally:
        jax_voice.close()
    got = port_voice.speak_batch(phonemes, speakers=speakers, scales=scales)
    for g_, w_ in zip(got, want):
        assert len(g_.samples) == len(w_.samples) > 0
        np.testing.assert_allclose(g_.samples.data, w_.samples.data,
                                   atol=2e-4, rtol=0)


def test_speaker_refusals(voice_paths):
    single = PiperVoice.from_config_path(voice_paths["single"], device="cpu")
    multi = PiperVoice.from_config_path(voice_paths["multi"], device="cpu")
    with pytest.raises(OperationError, match="single-speaker"):
        single.speak_batch(["həlˈoʊ."], speakers=[1])
    with pytest.raises(OperationError, match="out of range"):
        multi.speak_batch(["həlˈoʊ."], speakers=[4])
    with pytest.raises(OperationError, match="entries"):
        multi.speak_batch(["həlˈoʊ."], speakers=[0, 1])


class _FixedStages:
    """Stands in for the JAX voice's stream stage coalescer: every stream
    starts from the given latent."""

    def __init__(self, start):
        self._start = start

    def start(self, ids, sc):
        return self._start

    def close(self):
        pass


@pytest.mark.parametrize("epilogue", ["off", "fused"])
def test_stream_synthesis_matches_reference_from_same_z(
        voice_paths, monkeypatch, epilogue):
    if epilogue == "off":
        monkeypatch.setenv("SONATA_FUSED_EPILOGUE", "off")
    else:
        monkeypatch.delenv("SONATA_FUSED_EPILOGUE", raising=False)
    cfg = voice_paths["single"]
    port_voice = PiperVoice.from_config_path(cfg, device="cpu")
    assert (port_voice.fused_epilogue == "off") == (epilogue == "off")
    phonemes = port_voice.phonemize_text(STREAM_SENTENCE)[0]
    z, total, f, sid = port_voice._stream_start(
        port_voice._encode_phonemes(phonemes),
        port_voice.get_fallback_synthesis_config())
    assert total > 2 * 12 + 2 * 2  # several chunks at chunk_size 12
    start = (z, total, f, sid)
    port_voice._stream_start = lambda ids, sc: start

    jax_voice = JaxVoice.from_config_path(cfg)
    jax_voice._stage_coalescer = _FixedStages(
        (jax.numpy.asarray(z.numpy()), total, f, sid))
    try:
        want = list(jax_voice.stream_synthesis(phonemes, 12, 2))
    finally:
        jax_voice.close()
    got = list(port_voice.stream_synthesis(phonemes, 12, 2))
    assert [len(c.samples) for c in got] == [len(c.samples) for c in want]
    assert len(got) > 2
    for g_, w_ in zip(got, want):
        step = max(float(np.abs(w_.samples.data).max()), 0.01) / 32767.0
        assert np.abs(g_.samples.data - w_.samples.data).max() <= step + 1e-7


def test_entry_points_run_on_the_gpu_unless_asked_for_the_cpu(voice_paths):
    cfg = voice_paths["single"]
    if torch.cuda.is_available():
        assert PiperVoice.from_config_path(cfg).device.type == "cuda"
        return
    with pytest.raises(OperationError, match="CUDA"):
        PiperVoice.from_config_path(cfg)
    with pytest.raises(OperationError, match="CUDA"):
        SpeechSynthesizer.from_config_path(cfg)
    with pytest.raises(OperationError, match="CUDA"):
        PiperVoice.random(seed=0)
    with pytest.raises(OperationError, match="CUDA"):
        PiperVoice.random(seed=0, device="cuda")
    voice = SpeechSynthesizer.from_config_path(cfg, device="cpu").model
    assert voice.device.type == "cpu"


def test_gpu_voice_refuses_the_host_epilogue(voice_paths, monkeypatch):
    """``SONATA_FUSED_EPILOGUE=off`` would taper on the host; a voice on
    the card refuses it before it takes any weights onto the device."""
    from sonata_tpu_torch.models import piper

    monkeypatch.setenv("SONATA_FUSED_EPILOGUE", "off")
    monkeypatch.setattr(piper, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    with pytest.raises(OperationError, match="SONATA_FUSED_EPILOGUE=off"):
        PiperVoice.from_config_path(voice_paths["single"])


def test_random_voice_is_seeded_and_streams_on_cpu():
    a = PiperVoice.random(seed=5, device="cpu", model=dict(
        inter_channels=16, hidden_channels=16, filter_channels=32,
        n_layers=1, upsample_rates=(4, 4), upsample_initial_channel=32,
        upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1,),), dp_filter_channels=16,
        flow_n_layers=1, flow_wn_layers=2))
    b = PiperVoice.random(seed=5, device="cpu", model=dict(
        a.config.hyper.__dict__))
    for (name, pa), (_, pb) in zip(a.model.named_parameters(),
                                   b.model.named_parameters()):
        assert torch.equal(pa, pb), name
    synth = SpeechSynthesizer(a)
    chunks = list(synth.synthesize_streamed("Hello there, streaming world.",
                                            chunk_size=8, chunk_padding=1))
    audio = np.concatenate([c.samples.data for c in chunks])
    assert audio.size % a.hp.hop_length == 0 and np.isfinite(audio).all()
    with pytest.raises(OperationError, match="output configs"):
        synth.synthesize_lazy("Hi.", object())
    lazy = list(synth.synthesize_lazy("One. Two."))
    assert len(lazy) == 2 and all(len(x.samples) > 0 for x in lazy)
