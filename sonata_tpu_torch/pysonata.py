"""pysonata-compatible Python API.

Port of ``sonata_tpu/pysonata.py`` on the PyTorch voices: the same surface,
and :class:`PiperModel` takes ``device=`` (default: the GPU; ``"cpu"``
runs on the host) where the JAX module took a device mesh.

Mirrors the reference's Python bindings surface
(``crates/frontends/python/src/lib.rs``): ``Sonata`` (constructed via
``Sonata.with_piper``), ``PiperModel`` (config-path ctor, speaker get/set,
``get_scales``/``set_scales``), ``PiperScales``, ``AudioOutputConfig``,
``WaveSamples`` (wave bytes + save_to_file + sample_rate/duration/
inference/RTF getters), the three stream wrappers, and a free
``phonemize_text`` with a lazy module-global tashkeel engine
(``lib.rs:17-18,408-440``).

The reference releases the GIL around every ``next()``
(``lib.rs:152,183,208``); here heavy work happens inside torch operators,
which release the GIL themselves.

Example::

    from sonata_tpu_torch import pysonata

    model = pysonata.PiperModel("/voices/en_US-lessac-high.onnx.json")
    tts = pysonata.Sonata.with_piper(model)
    wave = tts.synthesize("Hello world!")
    wave.save_to_file("hello.wav")
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Union

from .audio import Audio, AudioSamples
from .core import SonataError
from .models import PiperVoice
from .synth import AudioOutputConfig, SpeechSynthesizer

__all__ = [
    "Sonata", "PiperModel", "PiperScales", "AudioOutputConfig",
    "WaveSamples", "LazySpeechStream", "ParallelSpeechStream",
    "RealtimeSpeechStream", "phonemize_text", "supported_languages",
    "SonataError",
]

# python frontend defaults (lib.rs:379-380)
DEFAULT_CHUNK_SIZE = 45
DEFAULT_CHUNK_PADDING = 3


class PiperScales:
    """Synthesis scales triple (``lib.rs:220``)."""

    def __init__(self, length_scale: float, noise_scale: float,
                 noise_w: float):
        self.length_scale = float(length_scale)
        self.noise_scale = float(noise_scale)
        self.noise_w = float(noise_w)

    def __repr__(self):
        return (f"PiperScales(length_scale={self.length_scale}, "
                f"noise_scale={self.noise_scale}, noise_w={self.noise_w})")


class WaveSamples:
    """Synthesized audio chunk (``lib.rs:98-134``)."""

    def __init__(self, audio: Audio):
        self._audio = audio

    def get_wave_bytes(self) -> bytes:
        return self._audio.as_wave_bytes()

    def save_to_file(self, path: Union[str, Path]) -> None:
        self._audio.save_to_file(path)

    @property
    def sample_rate(self) -> int:
        return self._audio.info.sample_rate

    @property
    def duration_ms(self) -> float:
        return self._audio.duration_ms()

    @property
    def inference_ms(self) -> float:
        return self._audio.inference_ms

    @property
    def real_time_factor(self) -> float:
        return self._audio.real_time_factor()


class _StreamWrapper:
    def __init__(self, stream):
        self._stream = stream

    def __iter__(self):
        return self

    def __next__(self) -> WaveSamples:
        return WaveSamples(next(self._stream))


class LazySpeechStream(_StreamWrapper):
    """One sentence per iteration (``lib.rs:136-160``)."""


class ParallelSpeechStream(_StreamWrapper):
    """Batched synthesis, precomputed (``lib.rs:162-190``)."""


class RealtimeSpeechStream(_StreamWrapper):
    """Chunked streaming (``lib.rs:192-217``)."""


class PiperModel:
    """A loaded Piper voice (``lib.rs:241-326``)."""

    def __init__(self, config_path: Union[str, Path], *,
                 seed: int = 0, device=None):
        self._voice = PiperVoice.from_config_path(config_path, seed=seed,
                                                  device=device)

    # -- speakers -------------------------------------------------------------
    @property
    def speakers(self) -> Optional[dict[int, str]]:
        return self._voice.get_speakers()

    def get_speaker(self) -> Optional[str]:
        sc = self._voice.get_fallback_synthesis_config()
        return sc.speaker[0] if sc.speaker else None

    def set_speaker(self, name: str) -> None:
        sid = self._voice.speaker_name_to_id(name)
        if sid is None:
            raise SonataError(f"unknown speaker: {name}")
        sc = self._voice.get_fallback_synthesis_config()
        sc.speaker = (name, sid)
        self._voice.set_fallback_synthesis_config(sc)

    # -- scales (lib.rs:267-325) ----------------------------------------------
    def get_scales(self) -> PiperScales:
        sc = self._voice.get_fallback_synthesis_config()
        return PiperScales(sc.length_scale, sc.noise_scale, sc.noise_w)

    def set_scales(self, scales: PiperScales) -> None:
        sc = self._voice.get_fallback_synthesis_config()
        sc.length_scale = scales.length_scale
        sc.noise_scale = scales.noise_scale
        sc.noise_w = scales.noise_w
        self._voice.set_fallback_synthesis_config(sc)

    @property
    def language(self) -> Optional[str]:
        return self._voice.get_language()

    @property
    def sample_rate(self) -> int:
        return self._voice.audio_output_info().sample_rate

    @property
    def supports_streaming_output(self) -> bool:
        return self._voice.supports_streaming_output()


class Sonata:
    """The synthesizer handle (``lib.rs:333-406``)."""

    def __init__(self, synth: SpeechSynthesizer):
        self._synth = synth

    @classmethod
    def with_piper(cls, model: PiperModel) -> "Sonata":
        return cls(SpeechSynthesizer(model._voice))

    def synthesize_lazy(self, text: str,
                        audio_output_config: Optional[AudioOutputConfig]
                        = None) -> LazySpeechStream:
        return LazySpeechStream(
            self._synth.synthesize_lazy(text, audio_output_config))

    # synthesize aliases synthesize_lazy (lib.rs:339-345)
    synthesize = synthesize_lazy

    def synthesize_parallel(self, text: str,
                            audio_output_config: Optional[AudioOutputConfig]
                            = None) -> ParallelSpeechStream:
        return ParallelSpeechStream(
            self._synth.synthesize_parallel(text, audio_output_config))

    def synthesize_streamed(self, text: str,
                            audio_output_config: Optional[AudioOutputConfig]
                            = None,
                            chunk_size: int = DEFAULT_CHUNK_SIZE,
                            chunk_padding: int = DEFAULT_CHUNK_PADDING
                            ) -> RealtimeSpeechStream:
        return RealtimeSpeechStream(
            self._synth.synthesize_streamed(text, audio_output_config,
                                            chunk_size, chunk_padding))

    def synthesize_to_file(self, path: Union[str, Path], text: str,
                           audio_output_config: Optional[AudioOutputConfig]
                           = None) -> None:
        self._synth.synthesize_to_file(path, text, audio_output_config)


def supported_languages() -> tuple[str, ...]:
    """Language codes the hermetic G2P backend can phonemize (the
    eSpeak backend, when libespeak-ng is installed, covers ~100 more);
    see ``docs/LANGUAGES.md`` for each pack's conventions."""
    from .text.rule_g2p import supported_languages as _sl

    return _sl()


def phonemize_text(text: str, language: str = "en-us",
                   separator: Optional[str] = None,
                   remove_lang_switch_flags: bool = False,
                   remove_stress: bool = False,
                   use_tashkeel: bool = False) -> list[str]:
    """Free phonemization helper (``lib.rs:408-440``)."""
    if use_tashkeel:
        from .text.tashkeel import get_default_engine

        text = get_default_engine().diacritize(text)
    from .text import text_to_phonemes

    return list(text_to_phonemes(
        text, voice=language, separator=separator,
        remove_lang_switch_flags=remove_lang_switch_flags,
        remove_stress=remove_stress))
