"""Python side of the C ABI (consumed by native/src/sonata_capi.cpp).

Port of ``sonata_tpu/frontends/capi_bridge.py`` on the PyTorch voices.
The C surface has no device argument, so voices load on the GPU unless
the embedding process sets ``SONATA_DEVICE`` (``cpu``, ``cuda:N``) before
the first load.

The C++ layer (``libsonata_tpu.so``) embeds or joins a CPython interpreter
and calls these module-level functions through the CPython API.  Keeping
this half in Python means the C++ half stays a thin marshalling shim — the
reference's equivalent logic lives in ``crates/frontends/capi/src/lib.rs``.

All functions use only plain types (int, float, str, bytes, tuples) at the
boundary.  Voice handles are process-unique positive integers.
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Iterator, Optional

from ..core import SonataError
from ..models import from_config_path
from ..synth import AudioOutputConfig, SpeechSynthesizer

_voices: dict[int, SpeechSynthesizer] = {}
_lock = threading.Lock()
_ids = itertools.count(1)

# reference capi realtime defaults (capi/src/lib.rs:408)
REALTIME_CHUNK = 72
REALTIME_PADDING = 3

MODE_LAZY = 0
MODE_BATCHED = 1
MODE_REALTIME = 2


DEVICE_ENV = "SONATA_DEVICE"


def load_voice(config_path: str) -> int:
    synth = SpeechSynthesizer(from_config_path(
        config_path, device=os.environ.get(DEVICE_ENV) or None))
    with _lock:
        handle = next(_ids)
        _voices[handle] = synth
    return handle


def _get(handle: int) -> SpeechSynthesizer:
    with _lock:
        synth = _voices.get(handle)
    if synth is None:
        raise KeyError(f"invalid voice handle {handle}")
    return synth


def unload_voice(handle: int) -> None:
    with _lock:
        synth = _voices.pop(handle, None)
    if synth is None:
        raise KeyError(f"invalid voice handle {handle}")
    synth.close()  # stop the voice's coalescer threads, fail queued work


def audio_info(handle: int) -> tuple[int, int, int]:
    info = _get(handle).audio_output_info()
    return info.sample_rate, info.num_channels, info.sample_width


def get_synth_config(handle: int) -> tuple[float, float, float, int]:
    sc = _get(handle).get_fallback_synthesis_config()
    sid = sc.speaker[1] if sc.speaker else -1
    return sc.length_scale, sc.noise_scale, sc.noise_w, sid


def set_synth_config(handle: int, length_scale: float, noise_scale: float,
                     noise_w: float, speaker_id: int) -> None:
    synth = _get(handle)
    sc = synth.get_fallback_synthesis_config()
    sc.length_scale = length_scale
    sc.noise_scale = noise_scale
    sc.noise_w = noise_w
    if speaker_id >= 0:
        speakers = synth.get_speakers() or {}
        sc.speaker = (speakers.get(speaker_id, str(speaker_id)), speaker_id)
    else:
        sc.speaker = None
    synth.set_fallback_synthesis_config(sc)


def _output_config(rate: int, volume: int, pitch: int,
                   silence_ms: int) -> Optional[AudioOutputConfig]:
    # 255 = unset sentinel at the C boundary (u8 has no None)
    rate_v = None if rate == 255 else rate
    volume_v = None if volume == 255 else volume
    pitch_v = None if pitch == 255 else pitch
    silence_v = silence_ms or None
    if all(v is None for v in (rate_v, volume_v, pitch_v, silence_v)):
        return None
    return AudioOutputConfig(rate=rate_v, volume=volume_v, pitch=pitch_v,
                             appended_silence_ms=silence_v)


def _stream_for(synth: SpeechSynthesizer, text: str, mode: int, cfg):
    if mode == MODE_REALTIME:
        return synth.synthesize_streamed(text, cfg, REALTIME_CHUNK,
                                         REALTIME_PADDING)
    if mode == MODE_BATCHED:
        return synth.synthesize_parallel(text, cfg)
    return synth.synthesize_lazy(text, cfg)


def speak(handle: int, text: str, mode: int, rate: int, volume: int,
          pitch: int, silence_ms: int) -> Iterator[bytes]:
    """Yield raw int16 sample bytes per audio piece (sentence or chunk)."""
    synth = _get(handle)
    cfg = _output_config(rate, volume, pitch, silence_ms)
    for audio in _stream_for(synth, text, mode, cfg):
        yield audio.as_wave_bytes()


def speak_to_file(handle: int, text: str, wav_path: str, mode: int,
                  rate: int, volume: int, pitch: int,
                  silence_ms: int) -> None:
    from ..audio import AudioSamples, write_wave_samples_to_file
    from ..core import OperationError

    synth = _get(handle)
    cfg = _output_config(rate, volume, pitch, silence_ms)
    merged = AudioSamples()
    for audio in _stream_for(synth, text, mode, cfg):
        merged.merge(audio.samples)
    if len(merged) == 0:
        raise OperationError("no audio synthesized")
    write_wave_samples_to_file(wav_path, merged.to_i16(),
                               synth.audio_output_info().sample_rate)


def version() -> str:
    from .. import __version__

    return __version__
