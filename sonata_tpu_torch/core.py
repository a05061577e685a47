"""Core abstractions: the model plug-in contract, error types, and phoneme
containers.

The PyTorch port's own copy of the analogue of the reference's
``sonata-core`` crate (``crates/sonata/core/src/lib.rs:20-131``): a
model-agnostic contract that the
synthesizer layer talks to, so new model families can plug in without touching
orchestration or frontends.  Where the reference uses a Rust trait with
``Box<dyn Any>`` type-erased synthesis configs (``core/src/lib.rs:88-90``),
we use a Python protocol with ``object``-typed configs — the same degree of
model-agnosticism, idiomatically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Protocol, runtime_checkable


# ---------------------------------------------------------------------------
# Errors — mirrors SonataError (reference core/src/lib.rs:20-24)
# ---------------------------------------------------------------------------

class SonataError(Exception):
    """Base error for the framework."""


class FailedToLoadResource(SonataError):
    """A model file, config, or data directory could not be loaded."""


class PhonemizationError(SonataError):
    """Text could not be converted to phonemes."""


class OperationError(SonataError):
    """A synthesis or post-processing operation failed."""


# ---------------------------------------------------------------------------
# Phonemes — one IPA string per sentence (reference core/src/lib.rs:53-79)
# ---------------------------------------------------------------------------

class Phonemes:
    """A list of sentences, each a single string of IPA phonemes.

    The reference models this as a newtype over ``Vec<String>``
    (``core/src/lib.rs:53``).  Sentence boundaries come from the phonemizer's
    clause splitting, so no single device program ever sees more than one
    sentence of text.
    """

    __slots__ = ("sentences",)

    def __init__(self, sentences: Optional[list[str]] = None):
        self.sentences: list[str] = list(sentences or [])

    def append(self, sentence: str) -> None:
        self.sentences.append(sentence)

    def extend(self, other: "Phonemes") -> None:
        self.sentences.extend(other.sentences)

    def to_string(self, sep: str = " ") -> str:
        return sep.join(self.sentences)

    def __iter__(self) -> Iterator[str]:
        return iter(self.sentences)

    def __len__(self) -> int:
        return len(self.sentences)

    def __getitem__(self, i):
        return self.sentences[i]

    def __repr__(self) -> str:
        return f"Phonemes({self.sentences!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Phonemes) and self.sentences == other.sentences


# ---------------------------------------------------------------------------
# Audio metadata (reference re-exports AudioInfo from audio-ops;
# core/src/lib.rs:7-12)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AudioInfo:
    sample_rate: int
    num_channels: int = 1
    sample_width: int = 2  # bytes per sample (16-bit PCM)


# ---------------------------------------------------------------------------
# Model protocol — the SonataModel trait
# (reference core/src/lib.rs:82-131)
# ---------------------------------------------------------------------------

@runtime_checkable
class Model(Protocol):
    """The model plug-in contract.

    Mirrors the reference ``SonataModel`` trait surface
    (``core/src/lib.rs:83-130``): audio info, phonemization, batch + single
    sentence synthesis, type-erased synthesis-config get/set, speaker-map
    helpers, a streaming-capability flag and a default-error streaming
    method.  Concrete implementations live in ``sonata_tpu_torch.models``.
    """

    def audio_output_info(self) -> AudioInfo:  # core/src/lib.rs:83
        ...

    def phonemize_text(self, text: str) -> Phonemes:  # core/src/lib.rs:84
        ...

    def speak_batch(self, phoneme_batches: list[str],
                    speakers: Optional[list[Optional[int]]] = None,
                    scales: Optional[list[Any]] = None) -> list["Audio"]:
        # core/src/lib.rs:85 — but unlike the reference's speak_batch
        # (piper/src/lib.rs:425-437, a sequential loop), implementations
        # should run a true padded batch on device.  ``speakers`` carries
        # optional per-sentence speaker ids and ``scales`` optional
        # per-sentence synthesis configs (None entries = the model's
        # configured values); implementations must reject non-None entries
        # they cannot honor.
        ...

    def speak_one_sentence(self, phonemes: str) -> "Audio":  # core/src/lib.rs:86
        ...

    # -- type-erased synthesis config (core/src/lib.rs:88-90) --
    def get_fallback_synthesis_config(self) -> Any:
        ...

    def set_fallback_synthesis_config(self, config: Any) -> None:
        ...

    # -- optional capability surface; defaults below --
    def get_default_synthesis_config(self) -> Any:
        ...

    def get_language(self) -> Optional[str]:
        ...

    def get_speakers(self) -> Optional[dict[int, str]]:
        ...

    def properties(self) -> dict[str, str]:
        ...

    def supports_streaming_output(self) -> bool:
        ...

    def stream_synthesis(
        self, phonemes: str, chunk_size: int, chunk_padding: int,
    ) -> Iterator["Audio"]:
        ...


class BaseModel:
    """Default implementations for the optional parts of :class:`Model`.

    Mirrors the trait's provided methods: speaker-map helpers
    (``core/src/lib.rs:95-113``), ``properties`` (``:114``), streaming flag +
    default-error ``stream_synthesis`` (``:118-130``).
    """

    def get_language(self) -> Optional[str]:
        return None

    def get_speakers(self) -> Optional[dict[int, str]]:
        return None

    def speaker_id_to_name(self, sid: int) -> Optional[str]:
        speakers = self.get_speakers()
        return speakers.get(sid) if speakers else None

    def speaker_name_to_id(self, name: str) -> Optional[int]:
        speakers = self.get_speakers()
        if not speakers:
            return None
        for sid, sname in speakers.items():
            if sname == name:
                return sid
        return None

    def properties(self) -> dict[str, str]:
        return {}

    def supports_streaming_output(self) -> bool:
        return False

    def stream_synthesis(
        self, phonemes: str, chunk_size: int, chunk_padding: int,
    ) -> Iterator["Audio"]:
        raise OperationError(
            "this model does not support streaming synthesis"
        )  # parity: core/src/lib.rs:124-129 default-error impl

    def close(self) -> None:
        """Release model-owned resources (threads, device buffers).

        Counterpart of the reference's voice unload
        (``capi/src/lib.rs:228``); default is a no-op for models without
        background machinery.  Idempotent."""
