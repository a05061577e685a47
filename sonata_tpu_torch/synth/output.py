"""Prosody post-processing: AudioOutputConfig (rate / volume / pitch /
appended silence) applied to synthesized audio.

Port of ``sonata_tpu/synth/output.py`` (parity with the reference synth
layer, ``crates/sonata/synth/src/lib.rs``):

- percentages 0-100 map linearly onto parameter ranges via
  ``percent_to_param(v) = v/100*(max-min)+min`` (``utils.rs:6-8``) with
  RATE (0.5, 5.5), VOLUME (0.0, 1.0), PITCH (0.5, 1.5) (``lib.rs:13-15``);
- unset fields mean "skip that processing";
- appended silence is generated as zero samples and run through the same
  processor, *before* rate processing (``lib.rs:37-53,106-117``).

This is host DSP, not device work: the processor is the C++ ``sonata_dsp``
library (WSOLA, :mod:`..native`), and the numpy arm implementing the same
algorithm runs when the library cannot be built.  ``process_prosody.arms``
counts the calls each arm served.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..audio import AudioSamples
from ..native import load_dsp_library

RATE_RANGE = (0.5, 5.5)    # lib.rs:13
VOLUME_RANGE = (0.0, 1.0)  # lib.rs:14
PITCH_RANGE = (0.5, 1.5)   # lib.rs:15


def percent_to_param(value: float, lo: float, hi: float) -> float:
    """``synth/src/utils.rs:6-8``."""
    return value / 100.0 * (hi - lo) + lo


@dataclass
class AudioOutputConfig:
    """Percentages 0-100; None = leave unchanged (``synth/lib.rs:29-34``)."""

    rate: Optional[int] = None
    volume: Optional[int] = None
    pitch: Optional[int] = None
    appended_silence_ms: Optional[int] = None
    # "per-chunk" (default; reference parity: each streamed chunk
    # peak-normalizes independently, samples.rs:51-75 — can audibly seam
    # between chunks) or "global": one fixed unit-range gain for the whole
    # stream, seam-free.
    stream_normalization: Optional[str] = None

    def __post_init__(self):
        if self.stream_normalization not in (None, "per-chunk", "global"):
            raise ValueError(
                f"stream_normalization={self.stream_normalization!r}: "
                "expected None, 'per-chunk', or 'global'")

    def apply(self, samples: AudioSamples, sample_rate: int) -> AudioSamples:
        """Silence first, then rate/volume/pitch (``synth/lib.rs:37-53``)."""
        data = samples.data
        if self.appended_silence_ms:
            n = int(sample_rate * self.appended_silence_ms / 1000.0)
            data = np.concatenate([data, np.zeros(n, dtype=np.float32)])
        speed = (percent_to_param(self.rate, *RATE_RANGE)
                 if self.rate is not None else 1.0)
        volume = (percent_to_param(self.volume, *VOLUME_RANGE)
                  if self.volume is not None else 1.0)
        pitch = (percent_to_param(self.pitch, *PITCH_RANGE)
                 if self.pitch is not None else 1.0)
        out = process_prosody(data, sample_rate, speed=speed, pitch=pitch,
                              volume=volume)
        return AudioSamples(out)


# ---------------------------------------------------------------------------
# processor dispatch: C++ first, numpy when the library is absent
# ---------------------------------------------------------------------------

def process_prosody(data: np.ndarray, sample_rate: int, *, speed: float = 1.0,
                    pitch: float = 1.0, volume: float = 1.0) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.float32)
    if len(data) == 0 or (abs(speed - 1) < 1e-6 and abs(pitch - 1) < 1e-6
                          and abs(volume - 1) < 1e-6):
        return data * np.float32(volume) if abs(volume - 1) >= 1e-6 else data
    lib = load_dsp_library()
    if lib is not None:
        import ctypes

        cap = lib.sonata_dsp_output_len(len(data), speed, pitch)
        if cap > 0:
            out = np.empty(cap, dtype=np.float32)
            n = lib.sonata_dsp_process(
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(data), sample_rate, speed, pitch, volume,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
            if n >= 0:
                process_prosody.arms["cpp"] += 1
                return out[:n].copy()
    process_prosody.arms["numpy"] += 1
    return _process_numpy(data, sample_rate, speed, pitch, volume)


#: calls served by each arm since import (a plain pass-through counts none)
process_prosody.arms = {"cpp": 0, "numpy": 0}


def _process_numpy(data, sample_rate, speed, pitch, volume):
    out = data
    if abs(pitch - 1) >= 1e-6:
        out = _resample_linear(out, 1.0 / pitch)
    ratio = pitch / speed
    if abs(ratio - 1) >= 1e-6:
        out = _wsola(out, sample_rate, ratio)
    if abs(volume - 1) >= 1e-6:
        out = out * np.float32(volume)
    return out.astype(np.float32)


def _resample_linear(x: np.ndarray, q: float) -> np.ndarray:
    n = len(x)
    out_n = max(int(round(n * q)), 1)
    pos = np.linspace(0, n - 1, out_n)
    return np.interp(pos, np.arange(n), x).astype(np.float32)


def _wsola(x: np.ndarray, sample_rate: int, r: float) -> np.ndarray:
    """Waveform-similarity overlap-add time stretch (numpy arm; same
    algorithm as the C++ implementation)."""
    n = len(x)
    if n == 0 or abs(r - 1.0) < 1e-6:
        return x
    win = max(64, sample_rate // 40)
    win = min(win, n)
    win -= win % 2
    if win < 2:
        return x
    hop_out = win // 2
    hop_in = hop_out / r
    search = win // 4
    out_n = int(round(n * r)) + win
    out = np.zeros(out_n, dtype=np.float64)
    norm = np.zeros(out_n, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / (win - 1))

    in_pos = 0.0
    out_pos = 0
    prev_start = -1
    while out_pos + win <= out_n:
        target = int(round(in_pos))
        start = min(max(target, 0), n - win)
        natural = prev_start + hop_out if prev_start >= 0 else -1
        if 0 <= natural and natural + win <= n:
            lo = max(target - search, 0)
            hi = min(target + search, n - win)
            if hi > lo:
                ref = x[natural:natural + win]
                # windowed cross-correlation over candidate starts
                seg = np.lib.stride_tricks.sliding_window_view(
                    x[lo:hi + win], win)[:hi - lo + 1]
                corr = seg @ ref
                start = lo + int(np.argmax(corr))
        out[out_pos:out_pos + win] += x[start:start + win] * window
        norm[out_pos:out_pos + win] += window
        prev_start = start
        out_pos += hop_out
        in_pos += hop_in
        if round(in_pos) >= n:
            break
        if round(in_pos) > n - win:
            in_pos = float(n - win)
    nz = norm > 1e-4
    out[nz] /= norm[nz]
    return out[: int(round(n * r))].astype(np.float32)
