"""Speech synthesis orchestration: lazy / batched / realtime streams.

Port of ``sonata_tpu/synth/synthesizer.py`` (analogue of the reference's
``crates/sonata/synth/src/lib.rs``), the same but for
:meth:`SpeechSynthesizer.from_config_path`, which loads the voice on the
GPU unless ``device="cpu"`` is given:

- :class:`SpeechSynthesizer` wraps a :class:`~sonata_tpu_torch.core.Model`,
  delegates the model protocol and post-processes every result with an
  optional :class:`~sonata_tpu_torch.synth.output.AudioOutputConfig`
  (rate, volume, pitch, appended silence, stream normalization).
- **Lazy** — phonemize once, synthesize one sentence per ``next()``.
- **Batched** — all sentences through ``Model.speak_batch`` (one padded
  device batch, whose rows split over the data axis of a voice's mesh,
  :mod:`sonata_tpu_torch.parallel`), or fanned across a replica pool's
  per-device schedulers.
- **Realtime** — a producer thread streams chunks through a queue, with the
  reference's chunk-size growth between sentences (``:351-356``).
- Every stream marks its first item (``ttfb_s``), which the serving
  frontends export as time to first byte.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional, Union

from ..audio import Audio, AudioSamples, write_wave_samples_to_file
from ..core import Model, OperationError, Phonemes
from ..serving import faults, tracing
from .output import AudioOutputConfig

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def synthesis_thread_pool() -> ThreadPoolExecutor:
    """Global pool, 4 × available parallelism (``synth/lib.rs:17-26``)."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                workers = 4 * (os.cpu_count() or 1)
                _POOL = ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="sonata_synth")
    return _POOL


class SpeechSynthesizer:
    """Wraps a model; adds output-config processing and stream modes.

    ``replica_pool``: optional
    :class:`~sonata_tpu_torch.serving.replicas.ReplicaPool` — when present,
    batched synthesis fans its sentences out across the pool's
    per-device replicas (least-loaded routing, circuit-broken chips
    skipped) instead of one ``speak_batch`` on the default device.
    Lazy/realtime streams keep using the wrapped model directly: their
    latency profile wants one device's stream coalescers, not a
    round-trip through the pool router.
    """

    def __init__(self, model: Model, replica_pool=None):
        self.model = model
        self.replica_pool = replica_pool

    @classmethod
    def from_config_path(cls, config_path: Union[str, Path], *, device=None,
                         **kwargs) -> "SpeechSynthesizer":
        """Load a voice (on the GPU unless ``device="cpu"``, or on a
        ``mesh=``) and wrap it."""
        from ..models import PiperVoice

        return cls(PiperVoice.from_config_path(config_path, device=device,
                                               **kwargs))

    # -- delegation (reference :205-247) ------------------------------------
    def audio_output_info(self):
        return self.model.audio_output_info()

    def phonemize_text(self, text: str) -> Phonemes:
        # the one G2P entry point every stream mode and frontend funnels
        # through — a span here covers the whole pipeline's CPU-side text
        # stage (no-op without an active request trace), and the same
        # choke point carries the text-stage failpoint
        with tracing.span("phonemize") as sp:
            faults.fire("phonemize")
            phonemes = self.model.phonemize_text(text)
            sp.annotate(sentences=len(getattr(phonemes, "sentences",
                                              phonemes)))
        return phonemes

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
        """Release the wrapped model's resources (worker threads); the
        synthesizer delegates like every other model method.  An attached
        replica pool drains first, so its queued work fails out before
        the models underneath disappear."""
        if self.replica_pool is not None:
            self.replica_pool.shutdown()
        close = getattr(self.model, "close", None)
        if close is not None:
            close()

    def dispatch_stats(self):
        """Backend-adaptive dispatch observability (policy decision +
        per-stage request/dispatch counters), or None for models without
        a dispatch policy.  Delegated so frontends and benches talk to
        the synthesizer, not the concrete model."""
        stats = getattr(self.model, "dispatch_stats", None)
        return stats() if stats is not None else None

    # -- processing helper ---------------------------------------------------
    def _post_process(self, audio: Audio,
                      output_config: Optional[AudioOutputConfig]) -> Audio:
        if output_config is None:
            return audio
        with tracing.span("postprocess"):
            processed = output_config.apply(audio.samples,
                                            audio.info.sample_rate)
            if output_config.stream_normalization == "global":
                # one fixed gain for every chunk of the stream — seam-free
                # (the default replicates the reference's per-chunk peak
                # normalization, samples.rs:51-75)
                processed.peak_normalize = False
            return Audio(processed, audio.info,
                         inference_ms=audio.inference_ms)

    @staticmethod
    def _check_output_config(output_config) -> None:
        """Fail fast on a wrong positional: the config is used mid-stream,
        where a type error would otherwise surface as a confusing
        AttributeError from a worker thread."""
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

    # the reference name is kept as an alias: "parallel" here means one
    # padded device batch, not a thread pool
    synthesize_batched = synthesize_parallel

    def synthesize_streamed(
        self, text: str,
        output_config: Optional[AudioOutputConfig] = None,
        chunk_size: int = 45, chunk_padding: int = 3,
        deadline=None,
    ) -> "RealtimeSpeechStream":
        """``deadline``: optional per-request
        :class:`~sonata_tpu_torch.serving.deadlines.Deadline`, carried down to
        the model's streaming path — in iteration mode
        (``SONATA_BATCH_MODE``) the resident stream rides it, so expiry
        fails this stream alone at an iteration boundary."""
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
        sample_rate = self.audio_output_info().sample_rate
        for audio in self.synthesize_parallel(text, output_config):
            samples.merge(audio.samples)
        if len(samples) == 0:
            raise OperationError("no audio synthesized")
        write_wave_samples_to_file(path, samples.to_i16(), sample_rate)


class _StageTimestamps:
    """Serving-plane stage timestamps shared by every stream mode.

    ``created_ts`` is stamped at stream construction (request accepted),
    ``first_item_ts`` when the first audio leaves the stream — their
    difference is the time-to-first-byte the metrics plane exports as the
    ``sonata_ttfb_seconds`` histogram.  Monotonic clock; ``ttfb_s`` is
    None until the first item is produced.
    """

    def __init__(self):
        self.created_ts = time.monotonic()
        self.first_item_ts: Optional[float] = None

    def _mark_item(self) -> None:
        if self.first_item_ts is None:
            self.first_item_ts = time.monotonic()

    @property
    def ttfb_s(self) -> Optional[float]:
        if self.first_item_ts is None:
            return None
        return self.first_item_ts - self.created_ts


class SpeechStreamLazy(_StageTimestamps):
    """One sentence per ``next()`` (``synth/lib.rs:282-307``)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 output_config: Optional[AudioOutputConfig]):
        super().__init__()
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
        audio = self._synth.model.speak_one_sentence(sentence)
        audio = self._synth._post_process(audio, self._output_config)
        self._mark_item()
        return audio


class SpeechStreamBatched(_StageTimestamps):
    """All sentences in one padded device batch, precomputed at construction
    (behavioral parity with the reference's parallel stream, ``:310-325``,
    but a single device program instead of a rayon fan-out)."""

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 output_config: Optional[AudioOutputConfig]):
        super().__init__()
        sentences = list(phonemes)
        if not sentences:
            audios = []
        elif synth.replica_pool is not None:
            # fan the sentences across the replica pool: each sentence
            # rides a per-device scheduler (coalescing with concurrent
            # requests there), results gather in input order.  The
            # ORIGINAL voice's fallback config travels as explicit
            # per-request speaker/scales — the replicas are device-pinned
            # copies whose own configs never see this voice's
            # SetSynthesisOptions/CLI-scale mutations.
            sc = synth.get_fallback_synthesis_config()
            sid = sc.speaker[1] if getattr(sc, "speaker", None) else None
            audios = synth.replica_pool.speak_many(sentences, speaker=sid,
                                                   scales=sc)
        else:
            audios = synth.model.speak_batch(sentences)
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
        self._mark_item()
        return audio


_SENTINEL = object()


class RealtimeSpeechStream(_StageTimestamps):
    """Pipelined chunked streaming (``synth/lib.rs:335-430``).

    A producer task on the shared pool walks sentences, calls the model's
    ``stream_synthesis``, post-processes each chunk, and pushes it through a
    queue; the consumer is this iterator.  Chunk size grows by the number of
    chunks already produced when a new sentence starts (``:351-356``) —
    small first chunk for TTFB, big later chunks for throughput.
    """

    def __init__(self, synth: SpeechSynthesizer, phonemes: Phonemes,
                 output_config: Optional[AudioOutputConfig],
                 chunk_size: int, chunk_padding: int, deadline=None):
        super().__init__()
        self._queue: "queue.Queue" = queue.Queue()
        self._synth = synth
        self._cancelled = threading.Event()
        # the producer runs on a pool thread where the request's trace
        # context is gone; capture it here (the request thread) and
        # re-activate it there, so the model's encode/decode spans land
        # in the right trace
        tctx = tracing.current()

        def produce():
            trace, parent = tctx if tctx is not None else (None, None)
            try:
                with tracing.use_trace(trace, parent):
                    chunks_done = 1
                    for sentence in phonemes:
                        size = min(chunk_size * chunks_done, 1024)
                        if deadline is None:
                            # the pre-deadline call shape: models still
                            # implementing the legacy 3-parameter
                            # protocol signature keep working untouched
                            stream = synth.model.stream_synthesis(
                                sentence, size, chunk_padding)
                        else:
                            try:
                                stream = synth.model.stream_synthesis(
                                    sentence, size, chunk_padding,
                                    deadline)
                            except TypeError:
                                # legacy model with a deadline set:
                                # drop it (no resident-stream state for
                                # it to govern); the frontends' own
                                # between-chunk checks still bound the
                                # request
                                stream = synth.model.stream_synthesis(
                                    sentence, size, chunk_padding)
                        for chunk in stream:
                            if self._cancelled.is_set():
                                return
                            chunk = synth._post_process(chunk,
                                                        output_config)
                            self._queue.put(chunk)
                            chunks_done += 1
            except Exception as e:  # forwarded, then stream ends (:374-378)
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
        self._mark_item()
        return item
