"""PiperVoice on PyTorch: the concrete TTS model behind the ``Model``
protocol.

Port of ``sonata_tpu/models/piper.py``, batch path and per-request
streaming.  The stages are the reference's (``vits.encode_text`` →
``vits.acoustics`` → ``vits.decode_with``), run eagerly on one device:

- **Batch** (:meth:`PiperVoice.speak_batch`): sentences are planned into
  dispatch groups exactly as the reference plans them
  (:meth:`_plan_dispatch_groups`), each group padded to batch and text
  buckets, encoded, run through acoustics at its frame bucket, decoded and
  quantized to peak-scaled int16 on the device, then dequantized on the
  host.
- **Streaming** (:meth:`PiperVoice.stream_synthesis`): one row of encode
  and acoustics, then one window decode per chunk of the reference's chunk
  plan, each ending in the fused taper + quantize epilogue (the CUDA
  kernel on the GPU) — or, on a CPU voice with
  ``SONATA_FUSED_EPILOGUE=off``, in the host slice + crossfade.  A GPU voice
  refuses ``off``: its windows never leave the card untapered.  The stream
  coalescers and the iteration loop of the reference are later work; here
  each request runs on its own.

The frame budget is exact.  The JAX package estimates the frame bucket
before its single jitted program runs and retries on overflow, because the
whole batch is one device program whose shapes must be fixed up front.
PyTorch runs eagerly, so the port reads the frame count ``sum(w_ceil)``
after ``encode_text`` (one ``[B]`` device-to-host copy) and runs acoustics
and decode at that count's bucket: no estimator, no retry.

The device is explicit: ``device=None`` means the GPU, and a host without
one raises :class:`OperationError` unless the caller passes
``device="cpu"``.  Noise comes from :attr:`PiperVoice.sampler`, by default
the per-row generator sampler :func:`vits.per_row_normal`.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch

from ..audio import Audio, AudioSamples
from ..core import (
    AudioInfo,
    BaseModel,
    FailedToLoadResource,
    OperationError,
    Phonemes,
)
from ..text import text_to_phonemes
from ..utils.buckets import (
    BATCH_BUCKETS,
    FRAME_BUCKETS,
    TEXT_BUCKETS,
    bucket_for,
    pad_to,
)
from . import decode_opts, vits
from .chunker import CROSSFADE_SAMPLES, plan_chunks
from .config import ModelConfig, SynthesisConfig, default_phoneme_id_map
from .serialization import load_params
from .weights import VitsModel, params_from_numpy, random_tree

#: noise streams of one dispatch: the duration predictor's, the prior's
DUR_NOISE, PRIOR_NOISE = 0, 1

Sampler = Callable[[int, int, tuple], torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; raises when CUDA is absent.

    There is no silent CPU fallback: running on the CPU is asked for with
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise OperationError(
                "no CUDA device is available; pass device='cpu' to run "
                "the PyTorch port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise OperationError(f"device {device!r} requested but CUDA is "
                                 "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise OperationError(f"unsupported device {device!r}")
    return dev


def _full_float32() -> None:
    # float32 on the card means float32: cuDNN's default runs f32
    # convolutions in TF32 (about three decimal digits), which would break
    # parity with the reference.  Matmuls default to full f32 already;
    # both are pinned here.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class PiperVoice(BaseModel):
    """A loaded Piper voice: config + parameters on one device."""

    # dispatch-group sizing, as the reference plans it
    MAX_DISPATCH_BATCH = 64
    MIN_DISPATCH_BATCH = 8

    def __init__(self, config: ModelConfig, params, *, device=None,
                 seed: int = 0, sampler: Optional[Sampler] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _full_float32()
        self.config = config
        self.hp = config.hyper
        self.fused_epilogue = decode_opts.resolve_fused_epilogue()
        if self.fused_epilogue == "off" and self.device.type == "cuda":
            raise OperationError(
                f"{decode_opts.FUSED_EPILOGUE_ENV}=off tapers the stream on "
                "the host; a voice on the GPU always runs the epilogue "
                "kernel")
        if not isinstance(params, VitsModel):
            params = params_from_numpy(params, self.hp)
        self.model = params.to(self.device).eval()
        self.multi_speaker = config.num_speakers > 1
        self._synth_lock = threading.RLock()
        self._synth_config = config.inference.copy()
        self._seed = seed
        self._rng_lock = threading.Lock()
        self._rng_counter = 0
        #: ``sampler(counter, stream, shape)`` → standard-normal CPU tensor;
        #: ``counter`` numbers the dispatches from 1, ``stream`` is
        #: :data:`DUR_NOISE` or :data:`PRIOR_NOISE`
        self.sampler: Sampler = sampler or (
            lambda counter, stream, shape: vits.per_row_normal(
                self._seed, counter, stream, shape))
        self.drop_stats = {"symbols_total": 0, "symbols_dropped": 0,
                           "dropped": {}}
        self._warned_drops: set = set()

    # ------------------------------------------------------------------
    # factories
    # ------------------------------------------------------------------

    @classmethod
    def from_config_path(cls, config_path: Union[str, Path], *, device=None,
                         **kwargs) -> "PiperVoice":
        """Load a voice from a Piper ``*.json`` config and its sidecar
        ``<stem>.npz`` weights (the JAX package's native format).  ONNX and
        torch-checkpoint import are not ported yet."""
        device = resolve_device(device)
        config = ModelConfig.from_path(config_path)
        stem = Path(config_path)
        stem = stem.with_suffix("") if stem.suffix == ".json" else stem
        npz = stem.with_suffix(".npz")
        if not npz.exists():
            raise FailedToLoadResource(
                f"no weights found next to {config_path} (looked for "
                f"{npz}; the port does not import ONNX or torch "
                "checkpoints yet)")
        return cls(config, load_params(npz), device=device, **kwargs)

    @classmethod
    def random(cls, config: Optional[ModelConfig] = None, *, seed: int = 0,
               device=None, **config_overrides) -> "PiperVoice":
        """A randomly-initialized voice (tests, benchmarks, dry runs): the
        reference's ``init_vits`` shapes, drawn from a ``torch.Generator``
        seeded with ``seed``."""
        device = resolve_device(device)
        if config is None:
            d = {
                "audio": {"sample_rate": 22050, "quality": "medium"},
                "num_speakers": 1,
                "espeak": {"voice": "en-us"},
                "phoneme_id_map": default_phoneme_id_map(),
            }
            d.update(config_overrides)
            d["num_symbols"] = len(d["phoneme_id_map"])
            config = ModelConfig.from_dict(d)
        tree = random_tree(config.hyper, n_vocab=config.num_symbols,
                           n_speakers=config.num_speakers,
                           generator=torch.Generator().manual_seed(seed))
        return cls(config, tree, device=device, seed=seed)

    # ------------------------------------------------------------------
    # Model protocol
    # ------------------------------------------------------------------

    def audio_output_info(self) -> AudioInfo:
        return AudioInfo(sample_rate=self.config.sample_rate)

    def get_language(self) -> Optional[str]:
        return self.config.language or self.config.espeak_voice

    def get_speakers(self) -> Optional[dict[int, str]]:
        if not self.multi_speaker:
            return None
        return self.config.reversed_speaker_map()

    def properties(self) -> dict[str, str]:
        return {"quality": self.config.quality or "unknown",
                "device": str(self.device)}

    def supports_streaming_output(self) -> bool:
        return True

    def get_default_synthesis_config(self) -> SynthesisConfig:
        return self.config.inference.copy()

    def get_fallback_synthesis_config(self) -> SynthesisConfig:
        with self._synth_lock:
            return self._synth_config.copy()

    def set_fallback_synthesis_config(self, config: Any) -> None:
        if not isinstance(config, SynthesisConfig):
            raise OperationError(
                "invalid synthesis config type "
                f"{type(config).__name__}")
        with self._synth_lock:
            self._synth_config = config.copy()

    def phonemize_text(self, text: str) -> Phonemes:
        return text_to_phonemes(text, voice=self.config.espeak_voice,
                                remove_lang_switch_flags=True)

    def _encode_phonemes(self, phonemes: str) -> list[int]:
        """Encode one sentence (unknown symbols dropped, as the reference
        does), counting the drops and warning once per symbol."""
        ids, dropped = self.config.phonemes_to_ids_diag(phonemes)
        stats = self.drop_stats
        stats["symbols_total"] += len(phonemes)
        if dropped:
            stats["symbols_dropped"] += len(dropped)
            for ch in dropped:
                stats["dropped"][ch] = stats["dropped"].get(ch, 0) + 1
                if ch not in self._warned_drops and not ch.isspace():
                    self._warned_drops.add(ch)
                    logging.getLogger("sonata").warning(
                        "phoneme %r (U+%04X) is not in this voice's "
                        "phoneme_id_map and was dropped at encoding",
                        ch, ord(ch))
        return ids

    def speak_one_sentence(self, phonemes: str) -> Audio:
        return self.speak_batch([phonemes])[0]

    # ------------------------------------------------------------------
    # batch synthesis
    # ------------------------------------------------------------------

    def speak_batch(self, phoneme_batches: list[str],
                    speakers: Optional[list[Optional[int]]] = None,
                    scales: "Optional[list[Optional[SynthesisConfig]]]"
                    = None) -> list[Audio]:
        """Batched synthesis on the device, in dispatch groups planned as
        the reference plans them; results in input order.

        ``speakers``: optional per-sentence speaker ids (None entries fall
        back to the config speaker); ``scales``: optional per-sentence
        synthesis configs (None entries fall back likewise)."""
        if not phoneme_batches:
            return []
        sc = self.get_fallback_synthesis_config()
        ids_list = [self._encode_phonemes(p) for p in phoneme_batches]
        n = len(ids_list)
        if speakers is not None and len(speakers) != n:
            raise OperationError(
                f"speakers list has {len(speakers)} entries for {n} sentences")
        if scales is not None and len(scales) != n:
            raise OperationError(
                f"scales list has {len(scales)} entries for {n} sentences")

        wavs: list[Optional[np.ndarray]] = [None] * n
        row_ms = [0.0] * n
        for group in self._plan_dispatch_groups(ids_list, sc, scales):
            t0 = time.perf_counter()
            w = self._infer_batch(
                [ids_list[i] for i in group], sc,
                speakers=([speakers[i] for i in group]
                          if speakers is not None else None),
                scales=([scales[i] for i in group]
                        if scales is not None else None))
            ms = (time.perf_counter() - t0) * 1000.0 / len(group)
            for row, i in enumerate(group):
                wavs[i] = w[row]
                row_ms[i] = ms
        info = self.audio_output_info()
        return [Audio(AudioSamples(wavs[i]), info, inference_ms=row_ms[i])
                for i in range(n)]

    def _plan_dispatch_groups(self, ids_list: list[list[int]],
                              sc: SynthesisConfig,
                              scales=None) -> list[list[int]]:
        """Partition sentence indices into device-dispatch groups (the
        reference's plan, unchanged).

        Rows sort by estimated frame count, then split into contiguous
        groups whose sizes are exact batch buckets.  Group sizes cap at
        half the batch (min 8); sorted order keeps each group's frame
        bucket tight."""
        n = len(ids_list)

        def est_frames(i) -> float:
            ls = (scales[i].length_scale
                  if scales is not None and i < len(scales)
                  and scales[i] is not None else sc.length_scale)
            return len(ids_list[i]) * max(float(ls), 0.05)

        def split_by_text_bucket(group: list[int]) -> list[list[int]]:
            """Split where a row's text bucket jumps past 2x the current
            subgroup head's, so a text-length-wild mix does not pad every
            short row to the outlier's size."""
            out: list[list[int]] = []
            for i in group:
                tb = bucket_for(len(ids_list[i]), TEXT_BUCKETS)
                if not out or tb > 2 * bucket_for(
                        len(ids_list[out[-1][0]]), TEXT_BUCKETS):
                    out.append([i])
                else:
                    out[-1].append(i)
            return out

        order = sorted(range(n), key=est_frames)
        if n < 2 * self.MIN_DISPATCH_BATCH:
            return split_by_text_bucket(order)
        half = max((n + 1) // 2, self.MIN_DISPATCH_BATCH)
        cap = next(s for s in reversed(BATCH_BUCKETS) if s <= half)
        cap = min(cap, self.MAX_DISPATCH_BATCH)
        sizes: list[int] = []
        rest = n
        while rest:
            take = min(cap, rest)
            sizes.append(next((s for s in reversed(BATCH_BUCKETS)
                               if s <= take), BATCH_BUCKETS[0]))
            rest -= sizes[-1]
        sizes.sort()
        while len(sizes) > 1 and sizes[0] < self.MIN_DISPATCH_BATCH:
            merged = sizes[0] + sizes[1]
            if (merged > self.MAX_DISPATCH_BATCH
                    or bucket_for(merged, BATCH_BUCKETS) - merged
                    > self.MIN_DISPATCH_BATCH):
                break
            small = sizes.pop(0)
            sizes[0] += small
        groups, pos = [], 0
        for s in sizes:
            groups.extend(split_by_text_bucket(order[pos:pos + s]))
            pos += s
        return groups

    # ------------------------------------------------------------------
    # staged inference
    # ------------------------------------------------------------------

    def _next_counter(self) -> int:
        with self._rng_lock:
            self._rng_counter += 1
            return self._rng_counter

    def _noise(self, counter: int, stream: int, shape: tuple):
        noise = self.sampler(counter, stream, tuple(shape))
        return noise.to(device=self.device, dtype=torch.float32)

    def _scale_arrays(self, sc: SynthesisConfig, batch: int,
                      scales: "Optional[list[Optional[SynthesisConfig]]]"
                      = None):
        """Per-row (noise_w, length_scale, noise_scale) [B] tensors;
        ``scales`` entries override the shared config row-wise."""
        def row(i, attr):
            if scales is not None and i < len(scales) and scales[i] is not None:
                return float(getattr(scales[i], attr))
            return float(getattr(sc, attr))

        return tuple(
            torch.tensor([row(i, attr) for i in range(batch)],
                         dtype=torch.float32, device=self.device)
            for attr in ("noise_w", "length_scale", "noise_scale"))

    def _sid_array(self, sc: SynthesisConfig, batch: int,
                   speakers: Optional[list[Optional[int]]] = None):
        if not self.multi_speaker:
            # single-speaker voice: only speaker 0 (or None) is honorable
            for sid in speakers or []:
                if sid not in (None, 0):
                    raise OperationError(
                        f"speaker id {sid} requested on a single-speaker "
                        "voice")
            return None
        default = sc.speaker[1] if sc.speaker else 0
        rows = [default if s is None else s
                for s in (speakers or [])] or [default]
        rows = rows + [default] * (batch - len(rows))
        for sid in rows:
            if not 0 <= sid < self.config.num_speakers:
                raise OperationError(
                    f"speaker id {sid} out of range "
                    f"(voice has {self.config.num_speakers} speakers)")
        return torch.tensor(rows[:batch], dtype=torch.long,
                            device=self.device)

    def _pad_batch(self, ids_list: list[list[int]]):
        """Pad a sentence batch to (batch, text) buckets; dummy rows are
        length 1 and dropped by callers."""
        n_real = len(ids_list)
        b = bucket_for(n_real, BATCH_BUCKETS)
        t = bucket_for(max(len(i) for i in ids_list), TEXT_BUCKETS)
        padded = ids_list + [[0]] * (b - n_real)
        ids = torch.tensor([pad_to(i, t) for i in padded], dtype=torch.long,
                           device=self.device)
        lens = torch.tensor([len(i) for i in ids_list] + [1] * (b - n_real),
                            dtype=torch.int32, device=self.device)
        return ids, lens, b, t

    @torch.inference_mode()
    def _encode_and_acoustics(self, ids_list, sc, speakers=None,
                              scales=None):
        """Stages 1 and 2 for one padded group: returns (z [B, f, C],
        y_lengths [B], per-row frame counts (host), f, g, sid)."""
        n_real = len(ids_list)
        ids, lens, b, t = self._pad_batch(ids_list)
        sid = self._sid_array(sc, b, speakers)
        nw, ls, ns = self._scale_arrays(sc, b, scales)
        counter = self._next_counter()
        m_p, logs_p, w_ceil, x_mask, g = vits.encode_text(
            self.model, self.hp, ids, lens,
            self._noise(counter, DUR_NOISE, (b, t, 2)),
            noise_w=nw, length_scale=ls, sid=sid)
        # exact frame budget: one [B] device→host copy, then the bucket
        frames = w_ceil.sum(dim=1).cpu().numpy().astype(np.int64)
        f = bucket_for(max(int(frames[:n_real].max()), 1), FRAME_BUCKETS)
        z, _y_mask, y_lengths = vits.acoustics(
            self.model, self.hp, m_p, logs_p, w_ceil, x_mask,
            self._noise(counter, PRIOR_NOISE,
                        (b, f, self.hp.inter_channels)),
            noise_scale=ns, max_frames=f, g=g)
        return z, y_lengths, frames, f, g, sid

    def _decode_quantize(self, z, y_lengths, g):
        """HiFi-GAN decode + on-device peak-scaled int16 quantization: the
        peak is taken over each row's valid samples, floored at 0.01, and
        goes out beside the samples so the host restores the amplitudes
        (the reference's ``_decode_quantize``, in plain torch)."""
        wav = vits.decode_with(self.model, self.hp, z, g=g)
        wav_lengths = y_lengths * self.hp.hop_length
        valid = (torch.arange(wav.shape[1], device=wav.device)[None, :]
                 < wav_lengths[:, None])
        peak = torch.amax(torch.abs(wav) * valid, dim=1, keepdim=True)
        scale = 32767.0 / torch.clamp(peak, min=0.01)
        wav_i16 = torch.clamp(wav * scale, -32768.0, 32767.0).to(torch.int16)
        return wav_i16, wav_lengths, peak[:, 0]

    @torch.inference_mode()
    def _infer_batch(self, ids_list: list[list[int]], sc: SynthesisConfig,
                     speakers: Optional[list[Optional[int]]] = None,
                     scales: "Optional[list[Optional[SynthesisConfig]]]"
                     = None) -> list[np.ndarray]:
        """One dispatch group: ids → float32 waveforms (host), one per
        real row, at their true lengths."""
        n_real = len(ids_list)
        z, y_lengths, _frames, _f, g, _sid = self._encode_and_acoustics(
            ids_list, sc, speakers=speakers, scales=scales)
        wav_i16, wav_lengths, peaks = self._decode_quantize(z, y_lengths, g)
        wav_i16 = wav_i16[:n_real].cpu().numpy()
        wav_lengths = wav_lengths[:n_real].cpu().numpy()
        peaks = np.maximum(peaks[:n_real, None].cpu().numpy(), 0.01)
        # dequantize back to the model's original amplitudes
        wav = wav_i16.astype(np.float32) * (peaks / 32767.0)
        return [wav[i, :int(wav_lengths[i])] for i in range(n_real)]

    # ------------------------------------------------------------------
    # streaming (reference stream_synthesis, piper/src/lib.rs:652-668)
    # ------------------------------------------------------------------

    def stream_synthesis(self, phonemes: str, chunk_size: int,
                         chunk_padding: int) -> Iterator[Audio]:
        """One sentence → chunks of audio, following the reference's chunk
        plan; each chunk is one window decode."""
        sc = self.get_fallback_synthesis_config()
        ids = self._encode_phonemes(phonemes)
        info = self.audio_output_info()
        hop = self.hp.hop_length
        t_enc0 = time.perf_counter()
        z_row, total_frames, f, sid0 = self._stream_start(ids, sc)
        total_frames = min(total_frames, f)
        enc_ms = (time.perf_counter() - t_enc0) * 1000.0
        fused = self.fused_epilogue != "off"
        for plan in plan_chunks(total_frames, chunk_size, chunk_padding):
            width = bucket_for(plan.width, FRAME_BUCKETS)
            start = min(plan.win_start, max(f - width, 0))
            shift = plan.win_start - start  # window moved left by pad
            lo = (shift + plan.trim_left) * hop
            hi = (shift + plan.width - plan.trim_right) * hop
            t0 = time.perf_counter()
            samples = self._decode_window(z_row, start, width, sid0, lo, hi,
                                          fused)
            ms = (time.perf_counter() - t0) * 1000.0 + enc_ms
            enc_ms = 0.0  # encoder cost attributed to the first chunk
            yield Audio(samples, info, inference_ms=ms)

    @torch.inference_mode()
    def _stream_start(self, ids: list[int], sc: SynthesisConfig):
        """Encode + acoustics for one stream.  Returns ``(z_row, total_frames,
        f, sid0)``: the [f, C] latent on the device, the true frame count,
        the frame bucket, and the row's speaker id (None on single-speaker
        voices)."""
        z, _y_lengths, frames, f, _g, sid = self._encode_and_acoustics(
            [ids], sc)
        return (z[0], int(frames[0]), f,
                int(sid[0]) if sid is not None else None)

    @torch.inference_mode()
    def _decode_window(self, z_row, start: int, width: int,
                       sid0: Optional[int], lo: int, hi: int,
                       fused: bool) -> AudioSamples:
        """Decode frames ``[start, start + width)`` of ``z_row`` and return
        the emitted samples ``[lo, hi)``, tapered."""
        window = z_row[start:start + width][None]
        g = None
        if sid0 is not None:
            g = vits.speaker_embedding(
                self.model, torch.tensor([sid0], device=self.device))
        wav = vits.decode_with(self.model, self.hp, window, g=g)
        if not fused:  # a CPU voice: the GPU refuses "off" at construction
            samples = AudioSamples(wav[0, lo:hi].numpy())
            return samples.crossfade(CROSSFADE_SAMPLES)  # taper (:838)
        bounds = torch.tensor([[lo], [hi]], dtype=torch.int32,
                              device=self.device)
        q, peak = decode_opts.fused_epilogue(wav, bounds[0], bounds[1],
                                             CROSSFADE_SAMPLES)
        # slice before dequantizing: everything outside [lo, hi) is zero
        return AudioSamples(decode_opts.dequantize_chunk(
            q[0, lo:hi].cpu().numpy(), peak[0].item()))
