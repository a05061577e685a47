"""Speech synthesis orchestration: lazy / batched / realtime streams.

Port of ``sonata_tpu/synth/synthesizer.py`` (analogue of the reference's
``crates/sonata/synth/src/lib.rs``), without the text stage's tracing span
and failpoint, the streams' first-byte timestamps or a replica pool (the
serving frontends that read them are not ported yet):

- :class:`SpeechSynthesizer` wraps a :class:`~sonata_tpu_torch.core.Model`,
  delegates the model protocol and post-processes every result with an
  optional :class:`~sonata_tpu_torch.synth.output.AudioOutputConfig`
  (rate, volume, pitch, appended silence, stream normalization).
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
from .output import AudioOutputConfig

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

    def close(self) -> None:
        """Release the wrapped model's resources (its engines' threads)."""
        close = getattr(self.model, "close", None)
        if close is not None:
            close()

    def dispatch_stats(self):
        """The model's dispatch policy decision and its streaming engines'
        counters, or None for a model without a dispatch policy."""
        stats = getattr(self.model, "dispatch_stats", None)
        return stats() if stats is not None else None

    # -- processing helper ---------------------------------------------------
    @staticmethod
    def _post_process(audio: Audio,
                      output_config: Optional[AudioOutputConfig]) -> Audio:
        if output_config is None:
            return audio
        processed = output_config.apply(audio.samples,
                                        audio.info.sample_rate)
        if output_config.stream_normalization == "global":
            # one fixed gain for every chunk of the stream, seam-free (the
            # default keeps the reference's per-chunk peak normalization,
            # samples.rs:51-75)
            processed.peak_normalize = False
        return Audio(processed, audio.info, inference_ms=audio.inference_ms)

    @staticmethod
    def _check_output_config(output_config) -> None:
        """Fail fast on a wrong positional: the config is used mid-stream,
        where a type error would surface from a worker thread."""
        if output_config is not None and not isinstance(
                output_config, AudioOutputConfig):
            raise OperationError(
                "output_config must be an AudioOutputConfig or None, got "
                f"{type(output_config).__name__} (chunk_size is a keyword "
                "argument: synthesize_streamed(text, chunk_size=..., "
                "chunk_padding=...))")

    # -- modes ---------------------------------------------------------------
    def synthesize_lazy(
        self, text: str,
        output_config: Optional[AudioOutputConfig] = None,
    ) -> "SpeechStreamLazy":
        self._check_output_config(output_config)
        return SpeechStreamLazy(self, self.phonemize_text(text), output_config)

    def synthesize_parallel(
        self, text: str,
        output_config: Optional[AudioOutputConfig] = None,
    ) -> "SpeechStreamBatched":
        self._check_output_config(output_config)
        return SpeechStreamBatched(self, self.phonemize_text(text),
                                   output_config)

    def synthesize_streamed(
        self, text: str,
        output_config: Optional[AudioOutputConfig] = None,
        chunk_size: int = 45, chunk_padding: int = 3,
        deadline=None,
    ) -> "RealtimeSpeechStream":
        """``deadline``: optional per-request
        :class:`~sonata_tpu_torch.serving.deadlines.Deadline`, carried to
        the model's streaming path (the iteration loop fails this stream
        alone once it expires)."""
        self._check_output_config(output_config)
        if not self.model.supports_streaming_output():
            raise OperationError("model does not support streamed synthesis")
        return RealtimeSpeechStream(self, self.phonemize_text(text),
                                    output_config, chunk_size, chunk_padding,
                                    deadline=deadline)

    def synthesize_to_file(
        self, path: Union[str, Path], text: str,
        output_config: Optional[AudioOutputConfig] = None,
    ) -> None:
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

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 output_config: Optional[AudioOutputConfig]):
        self._synth = synth
        self._sentences = list(phonemes)
        self._output_config = output_config
        self._idx = 0

    def __iter__(self) -> Iterator[Audio]:
        return self

    def __next__(self) -> Audio:
        if self._idx >= len(self._sentences):
            raise StopIteration
        sentence = self._sentences[self._idx]
        self._idx += 1
        return self._synth._post_process(
            self._synth.model.speak_one_sentence(sentence),
            self._output_config)


class SpeechStreamBatched:
    """All sentences in padded device batches, computed at construction
    (``synth/lib.rs:310-325``)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 output_config: Optional[AudioOutputConfig]):
        sentences = list(phonemes)
        audios = synth.model.speak_batch(sentences) if sentences else []
        self._results = [synth._post_process(a, output_config)
                         for a in audios]
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
    model's ``stream_synthesis``, post-processes each chunk and pushes it
    through a queue; the consumer is this iterator.  Chunk size grows by
    the number of chunks already produced when a new sentence starts
    (``:351-356``)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 output_config: Optional[AudioOutputConfig],
                 chunk_size: int, chunk_padding: int, deadline=None):
        self._queue: "queue.Queue" = queue.Queue()
        self._cancelled = threading.Event()

        def produce():
            try:
                chunks_done = 1
                for sentence in phonemes:
                    size = min(chunk_size * chunks_done, 1024)
                    args = (sentence, size, chunk_padding)
                    stream = (synth.model.stream_synthesis(*args)
                              if deadline is None else
                              synth.model.stream_synthesis(*args, deadline))
                    for chunk in stream:
                        if self._cancelled.is_set():
                            return
                        self._queue.put(synth._post_process(chunk,
                                                            output_config))
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
