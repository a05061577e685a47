"""Speech synthesis orchestration: lazy, batched and realtime streams, the
batching engines behind concurrent serving, and prosody output."""

from .batching import (
    BatchingCore,
    IterationLoop,
    effective_batch_mode,
    resolve_batch_mode,
)
from .output import AudioOutputConfig, percent_to_param, process_prosody
from .scheduler import BatchScheduler, DispatchStuck, SchedulerCrashed
from .synthesizer import (
    RealtimeSpeechStream,
    SpeechStreamBatched,
    SpeechStreamLazy,
    SpeechSynthesizer,
    synthesis_thread_pool,
)

__all__ = [
    "AudioOutputConfig",
    "percent_to_param",
    "process_prosody",
    "BatchingCore",
    "IterationLoop",
    "effective_batch_mode",
    "resolve_batch_mode",
    "BatchScheduler",
    "DispatchStuck",
    "SchedulerCrashed",
    "RealtimeSpeechStream",
    "SpeechStreamBatched",
    "SpeechStreamLazy",
    "SpeechSynthesizer",
    "synthesis_thread_pool",
]
