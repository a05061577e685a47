"""RIFF/WAV serialization for 16-bit PCM.

Analogue of the reference's ``crates/audio/ops/src/wave_writer.rs``: build the
whole file in memory, then write it in one call (``wave_writer.rs:51-87``)
— one syscall, no partial files on error.  A reader is included for tests
and tooling (the reference has none; its tests never re-read audio).
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np


class WaveWriterError(Exception):
    """WAV serialization failure (parity: ``ops/src/lib.rs:6``)."""


def write_wave_samples_to_buffer(
    samples_i16: np.ndarray, sample_rate: int, num_channels: int = 1
) -> bytes:
    """Serialize int16 PCM into a complete WAV byte buffer
    (``wave_writer.rs:18``)."""
    if samples_i16.dtype != np.int16:
        raise WaveWriterError(f"expected int16 samples, got {samples_i16.dtype}")
    if sample_rate <= 0 or num_channels <= 0:
        raise WaveWriterError("sample_rate and num_channels must be positive")
    data = samples_i16.astype("<i2").tobytes()
    bits_per_sample = 16
    byte_rate = sample_rate * num_channels * bits_per_sample // 8
    block_align = num_channels * bits_per_sample // 8
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(data)))
    buf.write(b"WAVE")
    buf.write(b"fmt ")
    buf.write(
        struct.pack(
            "<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate, block_align,
            bits_per_sample,
        )
    )
    buf.write(b"data")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)
    return buf.getvalue()


def write_wave_samples_to_file(
    path: Union[str, Path],
    samples_i16: np.ndarray,
    sample_rate: int,
    num_channels: int = 1,
) -> None:
    """Serialize to an in-memory buffer, then one file write
    (``wave_writer.rs:51-87``)."""
    payload = write_wave_samples_to_buffer(samples_i16, sample_rate, num_channels)
    Path(path).write_bytes(payload)


def read_wave_file(path: Union[str, Path]) -> Tuple[np.ndarray, int, int]:
    """Parse a 16-bit PCM WAV file → (int16 samples, sample_rate, channels)."""
    raw = Path(path).read_bytes()
    if len(raw) < 44 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise WaveWriterError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (chunk_len,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + chunk_len]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            data = body
        pos += 8 + chunk_len + (chunk_len & 1)
    if fmt is None or data is None:
        raise WaveWriterError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format != 1 or bits != 16:
        raise WaveWriterError(
            f"{path}: only 16-bit PCM supported (format={audio_format}, bits={bits})"
        )
    samples = np.frombuffer(data, dtype="<i2").astype(np.int16)
    return samples, sample_rate, channels
