"""Host-side audio buffer types and DSP (analogue of the reference's
``crates/audio/ops``)."""

from .samples import Audio, AudioSamples
from .wave_io import (
    WaveWriterError,
    read_wave_file,
    write_wave_samples_to_buffer,
    write_wave_samples_to_file,
)
from .window import get_hann_window

__all__ = [
    "Audio",
    "AudioSamples",
    "WaveWriterError",
    "read_wave_file",
    "write_wave_samples_to_buffer",
    "write_wave_samples_to_file",
    "get_hann_window",
]
