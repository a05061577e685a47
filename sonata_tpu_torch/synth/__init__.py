"""Speech synthesis orchestration: lazy, batched and realtime streams."""

from .synthesizer import (
    RealtimeSpeechStream,
    SpeechStreamBatched,
    SpeechStreamLazy,
    SpeechSynthesizer,
)

__all__ = [
    "RealtimeSpeechStream",
    "SpeechStreamBatched",
    "SpeechStreamLazy",
    "SpeechSynthesizer",
]
