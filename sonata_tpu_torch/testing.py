"""Testing utilities: a fake, deterministic, dependency-light model.

The reference has *no* mocks or fake backends anywhere — its model trait is
the natural seam but was never exploited (SURVEY §4: "the ``SonataModel``
trait *is* the natural seam for a fake").  :class:`FakeModel` fills that
gap: a pure-numpy :class:`~sonata_tpu_torch.core.Model` implementation producing
deterministic sine-wave "speech" whose duration scales with phoneme count,
so orchestration layers (synthesizer streams, scheduler, frontends) can be
tested in milliseconds with exact golden metrics — no jax, no compiles.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Iterator, Optional

import numpy as np

from .audio import Audio, AudioSamples
from .core import AudioInfo, BaseModel, OperationError, Phonemes
from .models.config import SynthesisConfig
from .text import text_to_phonemes


class FakeModel(BaseModel):
    """Deterministic synthetic voice.

    - each phoneme contributes ``samples_per_phoneme`` samples
      (× ``length_scale``);
    - the waveform is a sine whose frequency is derived from a hash of the
    phoneme string, so different sentences are distinguishable but every
      run is bit-identical;
    - ``inference_ms`` is a fixed constant, making RTF math testable.
    """

    def __init__(self, sample_rate: int = 16000,
                 samples_per_phoneme: int = 160,
                 language: str = "en-us",
                 speakers: Optional[dict[int, str]] = None):
        self._info = AudioInfo(sample_rate=sample_rate)
        self._spp = samples_per_phoneme
        self._language = language
        self._speakers = speakers
        self._config = SynthesisConfig()
        self.calls: list[tuple[str, Any]] = []  # observation log for tests

    # -- Model protocol ------------------------------------------------------
    def audio_output_info(self) -> AudioInfo:
        return self._info

    def get_language(self) -> Optional[str]:
        return self._language

    def get_speakers(self) -> Optional[dict[int, str]]:
        return self._speakers

    def get_default_synthesis_config(self) -> SynthesisConfig:
        return SynthesisConfig()

    def get_fallback_synthesis_config(self) -> SynthesisConfig:
        return self._config.copy()

    def set_fallback_synthesis_config(self, config: Any) -> None:
        if not isinstance(config, SynthesisConfig):
            raise OperationError("invalid synthesis config")
        self._config = config.copy()

    def phonemize_text(self, text: str) -> Phonemes:
        return text_to_phonemes(text, voice=self._language)

    def _synthesize(self, phonemes: str,
                    length_scale: Optional[float] = None) -> Audio:
        ls = (length_scale if length_scale is not None
              else self._config.length_scale)
        n = max(int(len(phonemes) * self._spp * ls), self._spp)
        digest = hashlib.blake2b(phonemes.encode(), digest_size=2).digest()
        freq = 110.0 + (digest[0] % 64) * 10.0
        t = np.arange(n, dtype=np.float32) / self._info.sample_rate
        wave = 0.5 * np.sin(2 * math.pi * freq * t).astype(np.float32)
        return Audio(AudioSamples(wave), self._info, inference_ms=1.0)

    def speak_one_sentence(self, phonemes: str) -> Audio:
        self.calls.append(("speak_one_sentence", phonemes))
        return self._synthesize(phonemes)

    def speak_batch(self, phoneme_batches: list,
                    speakers=None, scales=None) -> list[Audio]:
        # honor the protocol contract: reject what this model cannot
        # represent, and misaligned lists (core.Model.speak_batch docstring)
        for name, lst in (("speakers", speakers), ("scales", scales)):
            if lst is not None and len(lst) != len(phoneme_batches):
                raise OperationError(
                    f"{name} list has {len(lst)} entries for "
                    f"{len(phoneme_batches)} sentences")
        for sid in speakers or []:
            if sid is None:
                continue
            if self._speakers is None:
                if sid != 0:
                    raise OperationError(
                        f"speaker id {sid} on a single-speaker fake")
            elif sid not in self._speakers:
                raise OperationError(f"unknown speaker id {sid}")
        self.calls.append(("speak_batch", list(phoneme_batches), speakers,
                           scales))
        # dispatch attribution parity with PiperVoice: the fake pads
        # nothing and never compiles, and says so on the channel (no-op
        # outside a scheduler dispatch), so span-tree tests and the CI
        # smoke can assert the attribution contract without jax
        from .serving import tracing

        tracing.annotate_dispatch_group(
            batch_bucket=len(phoneme_batches),
            text_bucket=max((len(p) for p in phoneme_batches), default=0),
            rows=len(phoneme_batches), padding_rows=0, padding_ratio=0.0,
            compile="none")
        out = []
        for i, p in enumerate(phoneme_batches):
            sc = scales[i] if scales and i < len(scales) and scales[i] else None
            out.append(self._synthesize(p, length_scale=(
                sc.length_scale if sc else None)))
        return out

    # -- bucket-lattice warmup contract (serving/warmup.py) ------------------
    #: per-shape synthetic "compile" cost; tests raise it to exercise
    #: the SONATA_WARMUP_BUDGET_S expiry path deterministically
    warm_delay_s: float = 0.0
    #: the lattice a fake replica advertises — small and fixed so tests
    #: can assert exact coverage (full ⊃ minimal, like the real voice)
    _LATTICE_FULL = ((1, 16, 64), (1, 16, 128), (1, 32, 128),
                     (2, 16, 64), (2, 32, 128))
    _LATTICE_MINIMAL = ((1, 16, 64), (1, 32, 128))

    def lattice_shapes(self, mode: str = "full") -> list:
        if mode == "off":
            return []
        return list(self._LATTICE_MINIMAL if mode == "minimal"
                    else self._LATTICE_FULL)

    def warm_shape(self, shape) -> None:
        self.calls.append(("warm_shape", tuple(shape)))
        if self.warm_delay_s:
            import time

            time.sleep(self.warm_delay_s)

    @property
    def warmed_shapes(self) -> list:
        return [c[1] for c in self.calls if c[0] == "warm_shape"]

    def supports_streaming_output(self) -> bool:
        return True

    def stream_synthesis(self, phonemes: str, chunk_size: int,
                         chunk_padding: int,
                         deadline=None) -> Iterator[Audio]:
        self.calls.append(("stream_synthesis", phonemes, chunk_size,
                           chunk_padding))
        audio = self._synthesize(phonemes)
        data = audio.samples.data
        step = max(chunk_size * 16, 1)
        for start in range(0, len(data), step):
            yield Audio(AudioSamples(data[start:start + step]), self._info,
                        inference_ms=0.5)
