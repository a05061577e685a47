#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``sonata_tpu_torch``).

Run from the repository root on a host with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the script
exits non-zero; nothing is caught):

1. env      — ``nvidia-smi`` name and power limit, torch/CUDA versions, and
              the kernels' build from ``sonata_tpu_torch/csrc`` (nvcc, at
              first use).
2. main     — the port's main path at Piper medium width with random
              weights, through ``SpeechSynthesizer``: a 3-sentence text to a
              WAV file, then one streamed sentence.  The layers a random
              voice starts at zero (flow ``post``, duration-flow ``proj``)
              get seeded random values first, so the WaveNet gate's output
              reaches the audio.  Every kernel's launch
              count is set to 0 just before and read just after; the gate
              must have launched 16 times per acoustics call and the
              epilogue once per window decode.
3. parity   — the same weights and noise through the port on the CPU and on
              the GPU (the GPU acoustics fed the CPU's durations): the
              waveforms must agree within 1e-3 of the CPU waveform's peak
              (cuDNN and the CPU order float32 sums differently).
4. profile  — the same file and stream under ``torch.profiler``: wall time,
              device-busy time and idle share, kernel launches, and the
              kernels that take the most device time.
5. import   — the medium voice of phase 2, its zero-init layers filled the
              same way, written as ``voice.pt`` (the upstream state-dict
              naming, ``import_torch.params_to_state_dict``) beside a
              ``voice.onnx.json`` and loaded with
              ``PiperVoice.from_config_path`` on the card: the load time,
              and the phase-2 file from it and from a directly built voice
              (both fresh, same noise) must be identical, sample for sample.
6. tashkeel — two diacritizers on the card, each on a ~220-character
              Arabic text and on one longer than the CBHG's ``max_len``
              (315): the bundled tagger at its real weights, and a CBHG at
              the widths of the public CBHG configuration of libtashkeel's
              model family (``almodhfer/diacritization``,
              ``config/cbhg.yml``: embedding 256, bank K = 16, projections
              (128, 256), bi-GRU 256, one post bi-LSTM 256), random weights
              from ``tests/torch_cbhg.py``.  Logits on the card within 1e-4
              of the CPU port's, the classes equal wherever the top-2
              margin exceeds that, the strings identical; wall and device
              time and device events of one ``diacritize`` call.
7. arabic   — a medium voice with ``espeak.voice = "ar"`` over the default
              phoneme map (it covers every Arabic symbol the rules emit)
              with the bundled tagger as its engine: a 3-sentence text with
              digits to a WAV file and one streamed sentence, counted as in
              phase 2 (gate 16 per acoustics call, epilogue once a window),
              and each sentence against the CPU port as in phase 3.
8. kernels  — each kernel against its plain PyTorch version on the card, at
              the main and Arabic paths' shapes and at fixed check shapes that reach
              the kernels' edges (ragged and misaligned rows, a strided
              ``g``, slice boundaries inside fades).  Each is timed three
              ways: ``device_ms``, the kernel's own device time per call
              from the profiler; ``host_us``, wall time per call over 200
              back-to-back calls with one synchronise at the end (what the
              wrapper costs the host); ``call_ms``, host and device for one
              call (CUDA events around a single call).  ``floor_device_ms``
              is the device time of the smallest kernel (a one-element
              ``zero_()``) in the same run, and ``bound_share`` the bound
              over ``device_ms``.  The ``kernels`` line times each kernel
              at the main path's most frequent shape; its ``ms`` and
              ``plain_ms`` are device times per call.
9. the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

TEXT = ("The quick brown fox jumps over the lazy dog. "
        "Streaming speech synthesis turns text into audio one chunk at a "
        "time. A GPU runs every stage of the voice.")
STREAM_TEXT = ("This sentence is streamed in chunks, and each chunk ends in "
               "the fused taper and quantize epilogue.")
AR_TEXT = ("ذهب الولد إلى المدرسة في الصباح الباكر، وقرأ 3 كتب عن تاريخ "
           "المدن العربية القديمة. ثم عاد إلى البيت في الساعة 12 ظهرا، "
           "وتناول الغداء مع أسرته الكبيرة. وفي المساء كتب رسالة طويلة إلى "
           "صديقه الذي يسكن في مدينة بعيدة منذ 1998.")
AR_STREAM_TEXT = ("وفي المساء كتب الولد رسالة طويلة إلى صديقه الذي يسكن في "
                  "مدينة بعيدة، وقرأها على أسرته 2 مرات.")
#: the CBHG widths of almodhfer/diacritization, config/cbhg.yml
CBHG_WIDTHS = dict(emb=256, K=16, projections=(128, 256), gru_units=256,
                   lstm_units=256)
TASHKEEL_TOL = 1e-4


def require(ok: bool, what) -> None:
    """A check of the run's results: fails the script when not met."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters: int = 50) -> float:
    """Host and device for one call: median over ``iters`` single calls of
    the CUDA-event time around it (the device idles while the host
    prepares the launch, so this is mostly host time for a small kernel)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, calls: int = 200) -> float:
    """Wall microseconds per call over ``calls`` back-to-back calls with no
    synchronise between them, and one at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_ms(torch, fn, iters: int = 20, name=None):
    """Device time per call of ``fn`` from the profiler's CUDA kernel events
    (all kernels, or those whose name contains ``name``); None when the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and (name is None or name in e.name)]
    return sum(us) / iters / 1e3 if us else None


def profile_run(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall time, the union of
    device activity (busy time, idle share of the wall), device events,
    and the eight kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end_us = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    by_name: dict = {}
    for e in events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_s": wall, "device_events": len(events),
            "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "top": [{"name": name[:100], "count": n, "ms": us / 1e3}
                    for name, (n, us) in top]}


def fill_zero_init(torch, model, seed: int, std: float = 0.02) -> None:
    """Seeded random values in the layers a random voice starts at zero,
    as the reference's ``init_vits`` does: each flow layer's ``post`` and
    each duration flow's ``proj``.  At zero, the flow's WaveNet (and its
    gate) would reach nothing downstream."""
    gen = torch.Generator().manual_seed(seed)
    convs = ([layer["post"] for layer in model["flow"]["layers"]]
             + [flow["proj"] for flow in model["dp"]["flows"]])
    with torch.no_grad():
        for conv in convs:
            for param in (conv.weight, conv.bias):
                param.copy_(torch.randn(param.shape, generator=gen) * std)


def gate_inputs(torch, shape, g_mode, seed: int, offset: int = 0):
    """The [B, T, 2H] view of a contiguous [B, 2H, T], as wn passes it,
    ``offset`` floats into its storage; ``g`` None, a dense [B, 1, 2H], or
    (``strided``) layer 1's slice of a stacked [B, 2H*4, 1] conditioning,
    transposed, as wn passes it."""
    b, t, two_h = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randn((offset + b * two_h * t,), generator=gen,
                       device="cuda")
    x = flat[offset:].view(b, two_h, t).transpose(1, 2)
    g = None
    if g_mode == "dense":
        g = torch.randn((b, 1, two_h), generator=gen, device="cuda")
    elif g_mode == "strided":
        g = torch.randn((b, 4 * two_h, 1), generator=gen,
                        device="cuda")[:, two_h:2 * two_h].transpose(1, 2)
    return x, g


def gate_bound(shape, with_g: bool):
    """(bound ms, what bounds it) of the gate: read 2H floats and write H a
    time step, plus g; 7 operations an output."""
    b, t, two_h = shape
    nbytes = 4 * (b * t * two_h + b * t * two_h // 2
                  + (b * two_h if with_g else 0))
    return bound(nbytes, 7 * b * t * two_h // 2)


def epilogue_bound(b: int, s: int):
    """(bound ms, what bounds it) of the epilogue: read a float and write
    an int16 a sample, plus lo, hi and peak; 12 operations a sample."""
    return bound(b * s * (4 + 2) + b * (4 + 4 + 4), 12 * b * s)


def bound(nbytes: int, nops: int):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def timings(torch, fn, name: str, bound_ms: float, floor_ms: float) -> dict:
    """The kernel's timing fields for a ``*_check`` line."""
    dev = device_ms(torch, fn, name=name)
    require(dev is not None, f"no device time recorded for {name}")
    return {"device_ms": dev, "host_us": host_us(torch, fn),
            "call_ms": call_ms(torch, fn), "floor_device_ms": floor_ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / dev}


def check_gate(torch, gate, shape, g_mode, seed, offset=0):
    x, g = gate_inputs(torch, shape, g_mode, seed, offset)
    out = gate.fused_gate(x, g)
    torch.cuda.synchronize()
    ref = gate.fused_gate_reference(x if g is None else x + g)
    err = (out - ref).abs().max().item()
    require(out.shape == ref.shape and err <= 2e-6, ("gate", shape, err))
    return x, g, err


def epilogue_inputs(torch, b, s, bounds, seed, offset=0):
    """wav [b, s] at ``offset`` floats into its storage, and lo/hi."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randn((offset + b * s,), generator=gen, device="cuda")
    wav = flat[offset:].view(b, s).mul_(0.5)
    lo = torch.tensor([lo for lo, _ in bounds], dtype=torch.int32,
                      device="cuda")
    hi = torch.tensor([hi for _, hi in bounds], dtype=torch.int32,
                      device="cuda")
    return wav, lo, hi


def check_epilogue(torch, dop, wav, lo, hi):
    q, peak = dop.fused_epilogue(wav, lo, hi, 42)
    torch.cuda.synchronize()
    q_ref, peak_ref = dop.fused_epilogue_reference(wav, lo, hi, 42)
    lsb = (q.int() - q_ref.int()).abs()
    peak_err = ((peak - peak_ref).abs() / peak_ref.clamp(min=1e-30)).max()
    n_diff = int((lsb > 0).sum())
    require(int(lsb.max()) <= 1, ("epilogue lsb", int(lsb.max())))
    require(n_diff <= 0.001 * q.numel(), ("epilogue differing", n_diff))
    require(float(peak_err) <= 1e-6, ("epilogue peak", float(peak_err)))
    return int(lsb.max()), n_diff, float(peak_err)


def gpu_cpu_parity(torch, voice, cpu_voice, ids) -> dict:
    """One sentence's ids through the CPU port and the card on the same
    weights and noise, the GPU acoustics fed the CPU's durations; the
    waveforms must agree within 1e-3 of the CPU waveform's peak (cuDNN and
    the CPU order float32 sums differently)."""
    from sonata_tpu_torch.models import piper, vits
    from sonata_tpu_torch.utils.buckets import FRAME_BUCKETS, bucket_for

    hp = voice.hp
    with torch.inference_mode():
        outs = {}
        for name, v in (("cpu", cpu_voice), ("gpu", voice)):
            tok, lens, b, t = v._pad_batch([ids])
            dur = vits.per_row_normal(0, 1, piper.DUR_NOISE, (b, t, 2))
            outs[name] = vits.encode_text(
                v.model, hp, tok, lens, dur.to(v.device), noise_w=0.8,
                length_scale=1.0)
        m_p, logs_p, w_ceil, x_mask, _ = outs["cpu"]
        flips = int((outs["gpu"][2].cpu() != w_ceil).sum())
        f = bucket_for(int(w_ceil.sum()), FRAME_BUCKETS)
        prior = vits.per_row_normal(0, 1, piper.PRIOR_NOISE,
                                    (1, f, hp.inter_channels))
        wavs = {}
        for name, v, dev in (("cpu", cpu_voice, "cpu"),
                             ("gpu", voice, voice.device)):
            mp_, lp_ = outs[name][0], outs[name][1]
            z, _, _ = vits.acoustics(
                v.model, hp, mp_, lp_, w_ceil.to(dev), x_mask.to(dev),
                prior.to(dev), noise_scale=0.667, max_frames=f)
            wavs[name] = vits.decode_with(v.model, hp, z).cpu()
    diff = float((wavs["gpu"] - wavs["cpu"]).abs().max())
    peak = float(wavs["cpu"].abs().max())
    tolerance = 1e-3 * peak  # relative to the waveform's peak
    return {"frames": int(w_ceil.sum()), "frame_bucket": f,
            "w_ceil_flips": flips, "peak": peak, "max_abs_diff": diff,
            "max_rel_diff": diff / peak, "tolerance": tolerance,
            "tolerance_rel": 1e-3,
            "ok": peak > 0 and math.isfinite(diff) and diff <= tolerance}


def check_diacritizer(torch, gpu, cpu, texts, strip) -> dict:
    """A diacritizer on the card against the same model on the CPU:
    logits within :data:`TASHKEEL_TOL`, the classes equal wherever the
    CPU's top-2 margin exceeds it, the strings identical; then the wall
    time (median of 5 calls) and, under the profiler, the device time and
    device events of one ``diacritize`` call of the first text."""
    err, near_ties, flipped, chars = 0.0, 0, 0, 0
    for text in texts:
        base = strip(text)
        pieces = gpu.chunks(base) if hasattr(gpu, "chunks") else [base]
        for piece in (p for p in pieces if p.strip()):
            g = gpu.logits(piece).cpu()
            c = cpu.logits(piece)
            err = max(err, float((g - c).abs().max()))
            top2 = c.topk(2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > TASHKEEL_TOL
            near_ties += int((~decided).sum())
            flipped += int(((g.argmax(-1) != c.argmax(-1)) & decided).sum())
            chars += len(piece)
        require(gpu.diacritize(text) == cpu.diacritize(text),
                ("diacritized strings differ", text[:40]))
    require(err <= TASHKEEL_TOL and flipped == 0,
            ("diacritizer logits", err, flipped))
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        gpu.diacritize(texts[0])  # ends in the classes' copy to the host
        walls.append(time.perf_counter() - t0)
    prof = profile_run(torch, lambda: gpu.diacritize(texts[0]))
    return {"chars": chars, "max_abs_err": err, "tolerance": TASHKEEL_TOL,
            "near_ties": near_ties, "classes_flipped": flipped,
            "strings_identical": True,
            "wall_ms": statistics.median(walls) * 1e3,
            "device_ms": prof["device_busy_s"] * 1e3,
            "device_events": prof["device_events"],
            "profiled_wall_ms": prof["wall_s"] * 1e3, "top": prof["top"][:4]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from sonata_tpu_torch.models import PiperVoice, decode_opts as dop
    from sonata_tpu_torch.models import piper, vits
    from sonata_tpu_torch.ops import _build, gate
    from sonata_tpu_torch.synth import SpeechSynthesizer
    from sonata_tpu_torch.audio import read_wave_file
    from sonata_tpu_torch.models.import_torch import params_to_state_dict
    from sonata_tpu_torch.models.tashkeel import (
        _DEFAULT_VOCAB, strip_diacritics)
    from sonata_tpu_torch.models.tashkeel_cbhg import (
        TashkeelCBHGModel, state_dict_to_cbhg)
    from sonata_tpu_torch.models.weights import params_to_numpy
    from sonata_tpu_torch.text.tashkeel import BUNDLED_MODEL, TashkeelEngine

    gpu = card()
    # -- 1. env ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "env", "card": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "build_s": build_s,
          "built_now": _build.build_info.get("seconds", 0.0) > 0,
          "ptxas": ptxas})

    gate_shapes: list = []
    epi_shapes: list = []
    # -- 2. main path -----------------------------------------------------------
    # count the acoustics calls and note the shapes the kernels get:
    # each acoustics call gates [B, F, 2H] (channels first) per WN
    # layer, each window decode feeds the epilogue [1, width * hop]
    aco_calls = [0]
    acoustics = vits.acoustics
    decode_window = piper.PiperVoice._decode_window

    def counted_acoustics(p, hp, m_p, *a, max_frames, g=None, **k):
        aco_calls[0] += 1
        gate_shapes.append(((m_p.shape[0], max_frames,
                             2 * hp.hidden_channels), g is not None))
        return acoustics(p, hp, m_p, *a, max_frames=max_frames, g=g, **k)

    def recorded_window(self, z_row, start, width, *a, **k):
        epi_shapes.append((1, width * self.hp.hop_length))
        return decode_window(self, z_row, start, width, *a, **k)

    vits.acoustics = counted_acoustics
    piper.PiperVoice._decode_window = recorded_window
    voice = PiperVoice.random(seed=0)  # medium width, on the GPU
    fill_zero_init(torch, voice.model, seed=1)
    synth = SpeechSynthesizer(voice)
    hp = voice.hp
    # warm cuDNN's heuristics and the allocator on both paths, so the
    # timed run below is the steady state
    list(synth.synthesize_parallel("Warm up."))
    list(synth.synthesize_streamed("Warm up the stream too.",
                                   chunk_size=45, chunk_padding=3))
    torch.cuda.synchronize()
    gate_shapes.clear()
    epi_shapes.clear()
    aco_calls[0] = 0
    gate.fused_gate.launches = 0
    dop.fused_epilogue.launches = 0

    with tempfile.TemporaryDirectory() as tmp:
        wav_path = Path(tmp) / "smoke.wav"
        t0 = time.perf_counter()
        synth.synthesize_to_file(wav_path, TEXT)
        torch.cuda.synchronize()
        file_s = time.perf_counter() - t0
        samples, rate, _ = read_wave_file(wav_path)
    t0 = time.perf_counter()
    first_chunk_s = None
    chunks = []
    for chunk in synth.synthesize_streamed(STREAM_TEXT, chunk_size=45,
                                           chunk_padding=3):
        if first_chunk_s is None:
            first_chunk_s = time.perf_counter() - t0
        chunks.append(chunk.samples.data)
    stream_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {"fused_gate": gate.fused_gate.launches,
                "fused_epilogue": dop.fused_epilogue.launches}
    vits.acoustics = acoustics
    piper.PiperVoice._decode_window = decode_window
    main_gate_shapes, main_epi_shapes = list(gate_shapes), list(epi_shapes)

    n_wn = hp.flow_n_layers * hp.flow_wn_layers
    require(launches["fused_gate"] == n_wn * aco_calls[0] > 0,
            (launches, aco_calls))
    require(launches["fused_epilogue"] == len(chunks) > 0,
            (launches, len(chunks)))
    stream = np.concatenate(chunks)
    require(rate == 22050 and samples.size > 0, ("wav", rate, samples.size))
    require(np.abs(samples).max() > 0, "silent WAV")
    require(stream.size % hp.hop_length == 0
            and bool(np.isfinite(stream).all()), "stream length/finite")
    require(np.abs(stream).max() > 0, "silent stream")
    file_audio_s = samples.size / rate
    stream_audio_s = stream.size / rate
    emit({"phase": "main", "card": gpu, "width": "medium",
          "acoustics_calls": aco_calls[0], "launches": launches,
          "file_wall_s": file_s,
          "file_audio_s": file_audio_s,
          "file_rtf": file_s / file_audio_s,
          "stream_wall_s": stream_s,
          "stream_audio_s": stream_audio_s,
          "stream_rtf": stream_s / stream_audio_s,
          "first_chunk_s": first_chunk_s,
          "chunks": len(chunks)})

    # -- 3. GPU against the CPU port --------------------------------------------
    cpu_voice = PiperVoice.random(seed=0, device="cpu")
    fill_zero_init(torch, cpu_voice.model, seed=1)
    ids = voice._encode_phonemes(voice.phonemize_text(STREAM_TEXT)[0])
    parity = gpu_cpu_parity(torch, voice, cpu_voice, ids)
    emit({"phase": "parity", "card": gpu, **parity})
    require(parity.pop("ok"), ("gpu vs cpu", parity))

    # -- 4. where the time goes ------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        file_prof = profile_run(torch, lambda: synth.synthesize_to_file(
            Path(tmp) / "profiled.wav", TEXT))
    stream_prof = profile_run(torch, lambda: list(
        synth.synthesize_streamed(STREAM_TEXT, chunk_size=45,
                                  chunk_padding=3)))
    emit({"phase": "profile", "card": gpu, "file": file_prof,
          "stream": stream_prof})

    # -- 5. a voice loaded from a torch checkpoint ------------------------------
    direct = PiperVoice.random(seed=0)
    fill_zero_init(torch, direct.model, seed=1)
    state = params_to_state_dict(params_to_numpy(direct.model), direct.hp)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in state.items()}, tmp / "voice.pt")
        config = {"audio": {"sample_rate": 22050, "quality": "medium"},
                  "num_speakers": 1, "espeak": {"voice": "en-us"},
                  "num_symbols": direct.config.num_symbols,
                  "phoneme_id_map": direct.config.phoneme_id_map}
        (tmp / "voice.onnx.json").write_text(json.dumps(config),
                                            encoding="utf-8")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = PiperVoice.from_config_path(tmp / "voice.onnx.json")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        wavs = {}
        for name, v in (("direct", direct), ("loaded", loaded)):
            SpeechSynthesizer(v).synthesize_to_file(tmp / f"{name}.wav", TEXT)
            wavs[name] = read_wave_file(tmp / f"{name}.wav")[0]
        file_mb = (tmp / "voice.pt").stat().st_size / 2 ** 20
    n_params = sum(p.numel() for p in loaded.model.parameters())
    same_shape = wavs["loaded"].shape == wavs["direct"].shape
    import_diff = (int(np.abs(wavs["loaded"].astype(np.int32)
                              - wavs["direct"].astype(np.int32)).max())
                   if same_shape else None)
    emit({"phase": "import", "card": gpu, "format": "pt",
          "tensors": len(state), "params": n_params, "file_mb": file_mb,
          "load_s": load_s, "samples": int(wavs["loaded"].size),
          "max_abs_diff": import_diff})
    require(same_shape and wavs["loaded"].size > 0 and import_diff == 0,
            ("imported voice's WAV differs", import_diff))
    del direct, loaded

    # -- 6. the two diacritizers on the card -----------------------------------
    ar_long = " ".join([AR_TEXT] * 3)  # longer than the CBHG's max_len
    tagger = {dev: TashkeelEngine(str(BUNDLED_MODEL), device=dev)
              for dev in (None, "cpu")}
    # the torch mirror of the CBHG family, loaded from its file: the
    # card's host may have a ``tests`` package of its own
    spec = importlib.util.spec_from_file_location(
        "torch_cbhg", Path(__file__).resolve().parent / "tests"
        / "torch_cbhg.py")
    torch_cbhg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_cbhg)
    torch.manual_seed(0)
    mirror = torch_cbhg.CBHGTagger(n_vocab=len(_DEFAULT_VOCAB) + 1,
                                   **CBHG_WIDTHS).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # inference BatchNorm statistics to fold
        for bn in (m for m in mirror.modules()
                   if isinstance(m, torch.nn.BatchNorm1d)):
            bn.running_mean.copy_(torch.randn(bn.num_features,
                                              generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(bn.num_features,
                                            generator=gen) + 0.5)
    cbhg_tree = state_dict_to_cbhg(
        {k: v.numpy() for k, v in mirror.state_dict().items()})
    cbhg = {dev: TashkeelCBHGModel(cbhg_tree, device=dev)
            for dev in (None, "cpu")}
    require(len(ar_long) > cbhg[None].max_len > len(AR_TEXT),
            "text lengths")
    models = {"tagger": (tagger[None].model, tagger["cpu"].model),
              "cbhg": (cbhg[None], cbhg["cpu"])}
    require(all(e.has_model for e in tagger.values()), "tagger not loaded")
    tashkeel = {}
    for name, (gpu_model, cpu_model) in models.items():
        gpu_model.diacritize(AR_TEXT)  # warm cuDNN and the allocator
        tashkeel[name] = {
            "params": sum(p.numel() for p in gpu_model.module.parameters()),
            **check_diacritizer(torch, gpu_model, cpu_model,
                                [AR_TEXT, ar_long], strip_diacritics)}
    emit({"phase": "tashkeel", "card": gpu, "text_chars": len(AR_TEXT),
          "long_chars": len(ar_long), "cbhg_widths": CBHG_WIDTHS,
          "cbhg_vocab": len(_DEFAULT_VOCAB) + 1, **tashkeel})
    del cbhg, mirror

    # -- 7. an Arabic voice through the diacritizer ------------------------------
    ar_voice = PiperVoice.random(seed=0, tashkeel=tagger[None],
                                 espeak={"voice": "ar"})
    fill_zero_init(torch, ar_voice.model, seed=1)
    ar_synth = SpeechSynthesizer(ar_voice)
    list(ar_synth.synthesize_parallel("مرحبا بالعالم."))
    list(ar_synth.synthesize_streamed("مرحبا بالعالم العربي.",
                                      chunk_size=45, chunk_padding=3))
    torch.cuda.synchronize()
    vits.acoustics = counted_acoustics
    piper.PiperVoice._decode_window = recorded_window
    gate_shapes.clear()
    epi_shapes.clear()
    aco_calls[0] = 0
    gate.fused_gate.launches = 0
    dop.fused_epilogue.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ar_synth.synthesize_to_file(Path(tmp) / "ar.wav", AR_TEXT)
        torch.cuda.synchronize()
        ar_file_s = time.perf_counter() - t0
        ar_samples, ar_rate, _ = read_wave_file(Path(tmp) / "ar.wav")
    t0 = time.perf_counter()
    ar_first_s, ar_chunks = None, []
    for chunk in ar_synth.synthesize_streamed(AR_STREAM_TEXT, chunk_size=45,
                                              chunk_padding=3):
        if ar_first_s is None:
            ar_first_s = time.perf_counter() - t0
        ar_chunks.append(chunk.samples.data)
    ar_stream_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ar_launches = {"fused_gate": gate.fused_gate.launches,
                   "fused_epilogue": dop.fused_epilogue.launches}
    ar_aco = aco_calls[0]
    vits.acoustics = acoustics
    piper.PiperVoice._decode_window = decode_window
    require(ar_launches["fused_gate"] == n_wn * ar_aco > 0,
            (ar_launches, ar_aco))
    require(ar_launches["fused_epilogue"] == len(ar_chunks) > 0,
            (ar_launches, len(ar_chunks)))
    ar_stream = np.concatenate(ar_chunks)
    require(ar_rate == 22050 and np.abs(ar_samples).max() > 0, "Arabic WAV")
    require(bool(np.isfinite(ar_stream).all())
            and np.abs(ar_stream).max() > 0, "Arabic stream")
    cpu_ar_voice = PiperVoice.random(seed=0, device="cpu",
                                     tashkeel=tagger["cpu"],
                                     espeak={"voice": "ar"})
    fill_zero_init(torch, cpu_ar_voice.model, seed=1)
    sentences = ar_voice.phonemize_text(AR_TEXT).sentences
    require(sentences == cpu_ar_voice.phonemize_text(AR_TEXT).sentences,
            "Arabic phonemes differ between the card and the CPU")
    ar_parity = [gpu_cpu_parity(torch, ar_voice, cpu_ar_voice,
                                ar_voice._encode_phonemes(sentence))
                 for sentence in sentences]
    emit({"phase": "arabic", "card": gpu, "width": "medium",
          "sentences": len(sentences),
          "symbols_dropped": ar_voice.drop_stats["symbols_dropped"],
          "acoustics_calls": ar_aco, "launches": ar_launches,
          "file_wall_s": ar_file_s,
          "file_audio_s": ar_samples.size / ar_rate,
          "file_rtf": ar_file_s / (ar_samples.size / ar_rate),
          "stream_wall_s": ar_stream_s,
          "stream_audio_s": ar_stream.size / ar_rate,
          "stream_rtf": ar_stream_s / (ar_stream.size / ar_rate),
          "first_chunk_s": ar_first_s, "chunks": len(ar_chunks),
          "parity": ar_parity})
    require(all(r["ok"] for r in ar_parity), ("Arabic gpu vs cpu", ar_parity))

    # -- 8. kernels against their plain versions --------------------------------
    tiny = torch.empty(1, device="cuda")
    floor_ms = device_ms(torch, tiny.zero_)
    require(floor_ms is not None, "no device time recorded for zero_()")
    emit({"phase": "floor", "card": gpu, "floor_device_ms": floor_ms})
    rows = []
    # gate: the main path's shapes (a conditioned one takes g as wn passes
    # it) and fixed check shapes: T % 4 == 1 and 2, x at a storage offset,
    # g dense and strided
    gate_cases = [(shape, "strided" if with_g else None, 0)
                  for shape, with_g in sorted(set(main_gate_shapes
                                                  + gate_shapes))]
    gate_cases += [((4, 512, 384), "dense", 0), ((4, 384, 384), "strided", 0),
                   ((2, 37, 48), "dense", 0), ((2, 37, 48), None, 0),
                   ((2, 38, 48), "strided", 0), ((2, 38, 48), None, 0),
                   ((2, 64, 48), None, 1), ((2, 38, 48), "dense", 3)]
    gate_err = 0.0
    for i, (shape, g_mode, offset) in enumerate(gate_cases):
        x, g, err = check_gate(torch, gate, shape, g_mode, seed=i,
                               offset=offset)
        gate_err = max(gate_err, err)
        emit({"phase": "gate_check", "shape": list(shape), "g": g_mode,
              "offset": offset, "max_abs_err": err,
              **timings(torch, lambda: gate.fused_gate(x, g), "gate_kernel",
                        gate_bound(shape, g is not None)[0], floor_ms)})
    # time at the main path's most frequent shape
    shape, with_g = Counter(main_gate_shapes).most_common(1)[0][0]
    x, g = gate_inputs(torch, shape, "strided" if with_g else None, seed=99)
    kernel = lambda: gate.fused_gate(x, g)  # noqa: E731
    plain = lambda: gate.fused_gate_reference(  # noqa: E731
        x if g is None else x + g)
    bound_ms, bound_by = gate_bound(shape, with_g)
    kt = timings(torch, kernel, "gate_kernel", bound_ms, floor_ms)
    plain_dev = device_ms(torch, plain)
    require(plain_dev is not None, "no device time recorded for the plain")
    rows.append({"name": "fused_gate", "route": "cuda",
                 "source": "sonata_tpu_torch/csrc/gate.cu",
                 "replaces": "sonata_tpu/ops/gate.py:58",
                 "launches": launches["fused_gate"],
                 "max_abs_err": gate_err, "ms": kt["device_ms"],
                 "plain_ms": plain_dev, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None, **kt,
                 "plain_call_ms": call_ms(torch, plain),
                 "timed_shape": list(shape),
                 "checked_shapes": len(gate_cases)})

    # epilogue: the main path's window shapes, a [4, 256*256] check with
    # mixed ranges (full row, interior, shorter than 2*42, empty), rows off
    # a vector boundary (S = 1001, B = 2), fewer samples than a block has
    # threads (S = 256), lo/hi and both fades across the 4096-sample slice
    # boundaries of [1, 32768], and wav at an odd storage offset
    s_chk = 256 * 256
    epi_cases = [(4, s_chk, [(0, s_chk), (768, s_chk - 768),
                             (1000, 1050), (4000, 4000)], 0),
                 (2, 1001, [(0, 1001), (37, 990)], 0),
                 (1, 256, [(10, 250)], 0),
                 (1, 32768, [(4096 - 20, 3 * 4096 + 20)], 0),
                 (3, 4099, [(5, 4090), (2000, 2000), (100, 130)], 1)]
    for b, s in sorted(set(main_epi_shapes + epi_shapes)):
        epi_cases.append((b, s, [(3 * 256, s - 3 * 256)] * b, 0))
    epi_lsb, epi_diff, epi_peak = 0, 0, 0.0
    for i, (b, s, bounds, offset) in enumerate(epi_cases):
        wav, lo, hi = epilogue_inputs(torch, b, s, bounds, seed=i,
                                      offset=offset)
        lsb, n_diff, peak_err = check_epilogue(torch, dop, wav, lo, hi)
        epi_lsb, epi_peak = max(epi_lsb, lsb), max(epi_peak, peak_err)
        epi_diff += n_diff
        emit({"phase": "epilogue_check", "shape": [b, s], "offset": offset,
              "cluster": dop.epilogue_plan(b, s)[0],
              "max_lsb": lsb, "samples_differing": n_diff,
              "peak_rel_err": peak_err,
              **timings(torch, lambda: dop.fused_epilogue(wav, lo, hi, 42),
                        "epilogue_kernel", epilogue_bound(b, s)[0],
                        floor_ms)})
    b, s = Counter(main_epi_shapes).most_common(1)[0][0]
    bounds = [(3 * 256, s - 3 * 256)] * b
    wav, lo, hi = epilogue_inputs(torch, b, s, bounds, seed=98)
    kernel = lambda: dop.fused_epilogue(wav, lo, hi, 42)  # noqa: E731
    plain = lambda: dop.fused_epilogue_reference(  # noqa: E731
        wav, lo, hi, 42)
    bound_ms, bound_by = epilogue_bound(b, s)
    kt = timings(torch, kernel, "epilogue_kernel", bound_ms, floor_ms)
    plain_dev = device_ms(torch, plain)
    require(plain_dev is not None, "no device time recorded for the plain")
    rows.append({"name": "fused_epilogue", "route": "cuda",
                 "source": "sonata_tpu_torch/csrc/epilogue.cu",
                 "replaces": "sonata_tpu/models/decode_opts.py:158",
                 "launches": launches["fused_epilogue"],
                 "max_abs_err": epi_lsb, "ms": kt["device_ms"],
                 "plain_ms": plain_dev, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None, **kt,
                 "plain_call_ms": call_ms(torch, plain),
                 "timed_shape": [b, s],
                 "samples_differing": epi_diff,
                 "peak_rel_err": epi_peak})

    # -- 9. summary --------------------------------------------------------------
    emit({"kernels": rows})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
