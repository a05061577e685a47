"""Speech synthesis orchestration: lazy / batched / realtime streams.

Port of ``sonata_tpu/synth/synthesizer.py`` (analogue of the reference's
``crates/sonata/synth/src/lib.rs``), without output configs, tracing,
failpoints or a replica pool:

- :class:`SpeechSynthesizer` wraps a :class:`~sonata_tpu_torch.core.Model`
  and delegates the model protocol.
- **Lazy** — phonemize once, synthesize one sentence per ``next()``.
- **Batched** — all sentences through ``Model.speak_batch``.
- **Realtime** — a producer thread streams chunks through a queue, with the
  reference's chunk-size growth between sentences (``:351-356``).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Union

from ..audio import Audio, AudioSamples, write_wave_samples_to_file
from ..core import Model, OperationError, Phonemes

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def synthesis_thread_pool() -> ThreadPoolExecutor:
    """Global pool, 4 × available parallelism (``synth/lib.rs:17-26``)."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = ThreadPoolExecutor(
                    max_workers=4 * (os.cpu_count() or 1),
                    thread_name_prefix="sonata_synth")
    return _POOL


def _check_output_config(output_config) -> None:
    if output_config is not None:
        raise OperationError(
            "output configs are not supported by the PyTorch port yet; "
            "pass output_config=None")


class SpeechSynthesizer:
    """Wraps a model and adds the stream modes.

    Build one around a loaded voice, or with :meth:`from_config_path`, which
    loads the voice on the GPU unless ``device="cpu"`` is given."""

    def __init__(self, model: Model):
        self.model = model

    @classmethod
    def from_config_path(cls, config_path: Union[str, Path], *, device=None,
                         **kwargs) -> "SpeechSynthesizer":
        from ..models import PiperVoice

        return cls(PiperVoice.from_config_path(config_path, device=device,
                                               **kwargs))

    # -- delegation ----------------------------------------------------------
    def audio_output_info(self):
        return self.model.audio_output_info()

    def phonemize_text(self, text: str) -> Phonemes:
        return self.model.phonemize_text(text)

    def get_language(self):
        return self.model.get_language()

    def get_speakers(self):
        return self.model.get_speakers()

    def properties(self):
        return self.model.properties()

    def supports_streaming_output(self) -> bool:
        return self.model.supports_streaming_output()

    def get_fallback_synthesis_config(self):
        return self.model.get_fallback_synthesis_config()

    def set_fallback_synthesis_config(self, cfg) -> None:
        self.model.set_fallback_synthesis_config(cfg)

    # -- modes ---------------------------------------------------------------
    def synthesize_lazy(self, text: str,
                        output_config=None) -> "SpeechStreamLazy":
        _check_output_config(output_config)
        return SpeechStreamLazy(self, self.phonemize_text(text))

    def synthesize_parallel(self, text: str,
                            output_config=None) -> "SpeechStreamBatched":
        _check_output_config(output_config)
        return SpeechStreamBatched(self, self.phonemize_text(text))

    def synthesize_streamed(self, text: str, output_config=None,
                            chunk_size: int = 45,
                            chunk_padding: int = 3) -> "RealtimeSpeechStream":
        _check_output_config(output_config)
        if not self.model.supports_streaming_output():
            raise OperationError("model does not support streamed synthesis")
        return RealtimeSpeechStream(self, self.phonemize_text(text),
                                    chunk_size, chunk_padding)

    def synthesize_to_file(self, path: Union[str, Path], text: str,
                           output_config=None) -> None:
        """Drain the batched stream and write one WAV
        (``synth/lib.rs:170-198``)."""
        samples = AudioSamples()
        for audio in self.synthesize_parallel(text, output_config):
            samples.merge(audio.samples)
        if len(samples) == 0:
            raise OperationError("no audio synthesized")
        write_wave_samples_to_file(path, samples.to_i16(),
                                   self.audio_output_info().sample_rate)


class SpeechStreamLazy:
    """One sentence per ``next()`` (``synth/lib.rs:282-307``)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes):
        self._synth = synth
        self._sentences = list(phonemes)
        self._idx = 0

    def __iter__(self) -> Iterator[Audio]:
        return self

    def __next__(self) -> Audio:
        if self._idx >= len(self._sentences):
            raise StopIteration
        sentence = self._sentences[self._idx]
        self._idx += 1
        return self._synth.model.speak_one_sentence(sentence)


class SpeechStreamBatched:
    """All sentences in padded device batches, computed at construction
    (``synth/lib.rs:310-325``)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes):
        sentences = list(phonemes)
        self._results = synth.model.speak_batch(sentences) if sentences else []
        self._idx = 0

    def __iter__(self) -> Iterator[Audio]:
        return self

    def __next__(self) -> Audio:
        if self._idx >= len(self._results):
            raise StopIteration
        audio = self._results[self._idx]
        self._idx += 1
        return audio


_SENTINEL = object()


class RealtimeSpeechStream:
    """Pipelined chunked streaming (``synth/lib.rs:335-430``).

    A producer task on the shared pool walks the sentences, calls the
    model's ``stream_synthesis`` and pushes each chunk through a queue; the
    consumer is this iterator.  Chunk size grows by the number of chunks
    already produced when a new sentence starts (``:351-356``)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 chunk_size: int, chunk_padding: int):
        self._queue: "queue.Queue" = queue.Queue()
        self._cancelled = threading.Event()

        def produce():
            try:
                chunks_done = 1
                for sentence in phonemes:
                    size = min(chunk_size * chunks_done, 1024)
                    for chunk in synth.model.stream_synthesis(
                            sentence, size, chunk_padding):
                        if self._cancelled.is_set():
                            return
                        self._queue.put(chunk)
                        chunks_done += 1
            except Exception as e:  # forwarded, then the stream ends
                self._queue.put(e)
            finally:
                self._queue.put(_SENTINEL)

        synthesis_thread_pool().submit(produce)

    def cancel(self) -> None:
        self._cancelled.set()

    def __iter__(self) -> Iterator[Audio]:
        return self

    def __next__(self) -> Audio:
        item = self._queue.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, Exception):
            if isinstance(item, OperationError):
                raise item
            raise OperationError(str(item)) from item
        return item
