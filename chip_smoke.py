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
              WAV file, then one streamed sentence (through the stage
              coalescer and the window-decode engine the voice's dispatch
              policy picks).  The layers a random
              voice starts at zero (flow ``post``, duration-flow ``proj``)
              get seeded random values first, so the WaveNet gate's output
              reaches the audio.  Every kernel's launch
              count is set to 0 just before and read just after; the gate
              must have launched 16 times per acoustics call and the
              epilogue once per batched window decode.
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
8. concurrent — a medium voice with zero noise scales and the coalescing
              policy (its stage window long enough that 8 starts form one
              group): 8 streams of 8 sentences started together on 8
              threads through ``synthesize_streamed``, once with
              ``SONATA_BATCH_MODE=dispatch`` and once with ``iteration``
              (a warm round, a measured round, a profiled round each):
              coalescing ratios, rows and padded rows, the kernels' launches
              and batch shapes, first-chunk time per stream, audio seconds
              per wall second, device idle share; each stream against a
              CPU-port run of the same 8 streams in the same group: within
              1e-3 of its peak, chunk boundaries identical.
9. scheduler — a ``BatchScheduler`` over that voice, 16 sentences submitted
              from 16 threads: dispatches and rows per dispatch, each WAV
              against the same sentences through one ``speak_batch`` call
              (same lengths, within 1e-3 of the peak).
10. prosody — ``synthesize_to_file`` and ``synthesize_streamed`` with
              ``AudioOutputConfig(rate=30, volume=80, pitch=60,
              appended_silence_ms=200)``, once per ``stream_normalization``,
              against the CPU port (same lengths, within 1e-3 of the peak),
              and which DSP arm (C++ or numpy) ran.
11. precision — one file and one stream through each decoder arm on the
              card (float32, ``compute_dtype=bfloat16``,
              ``decode_quant=int8``), each voice fresh and warmed as in phase
              2 so its noise reaches the file where phase 2's did: bf16 and
              int8 against float32 with SNR > 25 dB (the JAX package's bf16
              bar), int8 also with log-spectral distance < 1 dB (its int8
              bar; bf16's is reported), the float32 WAV identical to phase
              2's, and each arm's HiFi-GAN device time at a [4, 384]
              decode (CUDA events around one call, the median of 10; the
              profiler's reading of its kernels beside).
12. warmup  — a medium voice in iteration mode with a ``BatchScheduler``
              attached, calibrated by one utterance, then the ``full``
              warm-up lattice (``serving.warmup.warm_model_lattice``: shape
              count and seconds), then 8 concurrent streams and a
              3-sentence text sentence by sentence through the scheduler,
              on texts the lattice never saw: no first use of a (shape,
              thread) pair the lattice warmed (``PiperVoice.first_uses``
              against ``warmed_shapes``), first chunk p50 and max.
13. serve   — the gRPC server (``frontends.grpc_server.create_server``)
              on loopback with ``--continuous-batching``, a 1-replica pool
              on the card and the ``full`` lattice: the medium voice saved
              as ``voice.pt`` and loaded by ``LoadVoice``; the warm-up that
              gates ``/readyz``; 8 concurrent ``SynthesizeUtteranceRealtime``
              and 4 single-sentence ``SynthesizeUtterance`` (2 lazy, 2
              batched) one after another; time to first message, audio
              seconds per wall second; ``sonata_runtime_cold_compiles_total``
              must be 0 and ``/readyz`` 200; one realtime response within
              1e-3 of its peak against the CPU port (same chunks); a
              sentence's first batch on 3 fresh threads against the
              scheduler's warm worker; then the drain, whose phases must run
              in ``DRAIN_PHASES`` order.  The warm-up's launches are
              counted as a path of their own (``serve_warmup``).
13b. serve_plain — the server without ``--continuous-batching`` and its
              ``full`` lattice: single-sentence ``SynthesizeUtterance`` with
              speech args from fresh threads run on the voice's warmed batch
              thread; no batch shape first met after the warm-up, cold
              compiles 0.
13c. router — inside phase 13, before its drain: the port's ``sonata-mesh``
              router (``frontends.mesh_server.create_mesh_server``, fleet
              cache on) on loopback in front of that server: the voice
              loaded through it, one ``SynthesizeUtterance`` and one
              ``SynthesizeUtteranceRealtime`` through the router, each
              identical to the same call made to the server directly; the
              ``x-sonata-node-id`` trailer must name the server, the
              router's ``/metrics`` must count ``sonata_mesh_routed_total``,
              and the router's fleet-cache key must equal the server's.
14. frontends — the saved voice through the CLI (``python3 -m
              sonata_tpu_torch.frontends.cli`` in a subprocess), the C ABI
              (``libsonata_tpu`` built with ``g++`` and loaded with
              ``ctypes`` into this process) and ``pysonata``: each WAV
              identical to the library's (``synthesize_to_file``) on the
              card, and the C ABI's realtime events identical to the
              library's stream of 72-frame chunks.
14b. mesh   — the device mesh at medium width, on meshes whose device
              lists repeat the one card (``make_mesh(devices=[cuda:0] *
              n)``): (data 2), (data 1, seq 2) and (data 2, seq 2, model
              2).  Each runs the 3-sentence file, one stream and a long
              utterance (over 3000 samples, split over the seq shards) on a
              fresh voice, held against the unsharded voice on the card
              (fresh, same weights and noise, same call order) within 1e-3
              of the peak, lengths and chunk boundaries identical.  The
              gate and the epilogue are recorded at the per-shard shapes
              they launch at (the kernel checks take them), and each launch
              counter must equal its recorded calls.  The bf16
              ``decode_sp`` against the unsharded bf16 decode (SNR above
              the bf16 bar); the server's ``main()`` with ``--mesh-devices
              1`` serves a sentence on a voice with that mesh;
              ``--mesh-devices 2`` on a one-card host is refused.  Cross-card transport is not measured: the
              mesh repeats one card.
14c. train  — the Arabic tagger trained on the card at the bundled tagger's
              width (hidden 96, filter 256, 2 heads, 2 layers, kernel 3,
              window 8; ``models/tashkeel_train.py``, the counterpart of
              ``tools/train_tashkeel.py``): from
              ``TashkeelModel.random(seed=0)``, 400 Adam steps of batch 32
              at lr 3e-3 on the tool's batches.  Step 0 on the card against
              the CPU port (same parameters, same batch): loss within
              relative 1e-5, every gradient within 1e-5.  The loss at steps
              0, 50, ..., 399; wall seconds of the 400 steps, host seconds
              making batches, and each step's time on the card (CUDA events
              around it); held-out class accuracy at least 0.97; ``save``,
              reloaded with ``from_path`` on the card, diacritizes the 50
              held-out sentences identically; DER without case endings and
              case-ending accuracy on ``tools/tashkeel_gold.txt`` beside the
              bundled tagger's.  Training launches neither hand kernel (0
              launches, counted like a path).
15. kernels — each kernel against its plain PyTorch version on the card, at
              the shapes every path above gave it and at fixed check shapes that reach
              the kernels' edges (ragged and misaligned rows, a strided
              ``g``, slice boundaries inside fades).  Each is timed four
              ways: ``device_ms``, device time per call from CUDA events
              around 20 calls, each on inputs of its own, queued behind a
              sleeping kernel after twice the L2 cache was written (so the
              calls run back to back and every input comes from device
              memory, as the bound assumes: one input set reused stays in
              L2 and beats the bound); ``profiler_ms``, the profiler's
              kernel events for the same calls, beside it (``PERF.md``
              says why both); ``host_us``, wall time per call over 200
              back-to-back calls with one synchronise at the end (what the
              wrapper costs the host); ``call_ms``, host and device for one
              call (CUDA events around a single call).  ``floor_device_ms``
              is the device time of the smallest kernel (a one-element
              ``zero_()``, timed as ``device_ms``), and ``bound_share`` the bound
              over ``device_ms``.  The ``kernels`` line times each kernel
              at the main path's most frequent shape; its ``ms`` and
              ``plain_ms`` are device times per call.
16. the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20     # H100 SXM L2 cache
#: calls a kernel timing spreads over, each on inputs of its own
COLD_CALLS = 20
#: the sleeping kernel the timed calls queue behind: about 10 ms at the
#: H100's 1.98 GHz, longer than the host takes to enqueue them
SLEEP_CYCLES = 20_000_000

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
#: 8 sentences of one text bucket (192 ids), so that their starts can share
#: one stage group; 286-336 frames each at zero noise scales (bucket 384)
CONCURRENT_TEXTS = (
    "Every stream starts on its own thread at once, and the card serves "
    "them together.",
    "The graphics card decodes the windows of many streams in one batched "
    "call.",
    "A batched encode serves eight callers at the same time, then each one "
    "goes its way.",
    "Each caller hears its own sentence while the rest of it is still being "
    "made.",
    "Short chunks arrive first so the listener waits less, and longer ones "
    "follow later.",
    "The iteration loop keeps the running batch full while the streams come "
    "and go.",
    "Streams join the running batch when their encode lands and leave it "
    "when they end.",
    "One launch of the epilogue tapers and quantizes every window that "
    "rides in it.")
#: the scheduler's 16: those 8 and 8 more of the same text and frame
#: buckets, so a sentence's frame bucket is the same in every group
SCHED_TEXTS = CONCURRENT_TEXTS + (
    "Sixteen short requests wait in the queue of the scheduler for a "
    "moment.",
    "The scheduler gathers them into one call and the voice speaks them all.",
    "A request that arrives late simply rides in the next dispatch instead.",
    "The queue is bounded, so a burst of traffic is shed rather than stored.",
    "The results come back in the order in which the requests were made.",
    "Padding rows cost a little compute but keep the shapes to a few.",
    "Each sentence gets its own peak, so quiet ones stay quiet here.",
    "The batch path quantizes on the card before it copies to the host.")
#: the concurrent voice's stage window: a group closes when its 8th start
#: arrives, long before this
STAGE_WAIT_MS = 5000.0
#: GPU against CPU port, or against another batch shape: of the peak
PARITY_TOL = 1e-3
#: phase 14b's meshes over the one card: (name, entries, seq, model)
MESH_LAYOUTS = (("data2", 2, 1, 1), ("data1_seq2", 2, 2, 1),
                ("data2_seq2_model2", 8, 2, 2))
MESH_LONG_TEXT = ("This long utterance runs across both halves of the "
                  "sequence axis, so that its latent frames and its "
                  "waveform are split between the shards of the mesh and "
                  "joined again at the end, where the listener hears one "
                  "sentence.")
PROSODY = dict(rate=30, volume=80, pitch=60, appended_silence_ms=200)
#: phase 14c: the tool's run, and the card's step 0 against the CPU port's
#: (float32 on both, TF32 off on the card; sums in another order)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR = 400, 32, 3e-3
TRAIN_LOSS_RTOL, TRAIN_GRAD_ATOL = 1e-5, 1e-5
#: the JAX package's bars for a reduced-precision decoder against float32:
#: SNR for both arms, the log-spectral distance for the int8 arm
SNR_DB_MIN, LSD_DB_MAX = 25.0, 1.0
#: a lone stream on the card before the port had a warm-up (NVIDIA H100
#: 80GB HBM3, 700 W): first chunk 0.36389 s when its engine thread met a
#: new window shape, and 0.039-0.060 s warm
#: (``tools/torch_stream_timeline.py``)
UNWARMED_FIRST_CHUNK_S, WARM_FIRST_CHUNK_S = 0.36389, (0.039, 0.060)
#: texts the warm-up lattice never saw (it runs zero-valued dummies)
WARM_TEXTS = (
    "The lattice warmed every shape before this stream asked for one.",
    "A listener on a slow phone line waits for the first chunk only.",
    "Nine hundred callers may arrive at the same moment after a deploy.",
    "Readiness turns on once every serving thread has met its shapes.",
    "The plans are built per thread, so each worker warms its own.",
    "A window of speech decodes while the next one is still queued.",
    "The decoder's batch grows and shrinks as the streams come and go.",
    "Nothing in this sentence was synthesized during the warm-up.")
WARM_FILE_TEXT = ("The scheduler speaks this file one sentence at a time. "
                  "Each sentence lands on a shape the lattice warmed. "
                  "Its worker thread built the plans before readiness.")
#: the serve phase's realtime texts and single-sentence utterances
SERVE_TEXTS = WARM_TEXTS
SERVE_UTTERANCES = ("The server answers this request in lazy mode.",
                    "A second lazy request follows the first one.",
                    "Batched mode synthesizes this sentence now.",
                    "The last request of the serve phase is batched.")


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


def cold_device_ms(torch, calls, rounds: int = 3) -> float:
    """Device time per call, each of ``calls`` on inputs of its own: after
    a write of twice the L2 cache, the calls are enqueued behind a sleeping
    kernel, so they run back to back on the card however slow the host is
    to launch them, every input read from device memory and every output
    kept (written to memory no earlier call used); CUDA events around
    them, the median of ``rounds``.  A round in which the host was still
    enqueuing when the sleep ended is run again with twice the sleep."""
    flush = torch.empty(2 * L2_BYTES // 4, device="cuda")
    kept = [fn() for fn in calls]  # the outputs' memory, allocated once
    del kept
    times, cycles = [], SLEEP_CYCLES
    for _ in range(rounds + 4):
        flush.zero_()
        sleep_start = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sleep_start.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        kept = [fn() for fn in calls]
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        del kept
        if enqueue_ms >= sleep_start.elapsed_time(start):
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / len(calls))
        if len(times) == rounds:
            return statistics.median(times)
    raise RuntimeError(f"chip_smoke: the host outran the sleep "
                       f"({enqueue_ms} ms to enqueue)")


def profiler_ms(torch, calls, name=None, attempts: int = 3):
    """The same calls' device time per call from the profiler's kernel
    events (all kernels, or those whose name contains ``name``), after the
    same L2 flush; None when a capture records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(2 * L2_BYTES // 4, device="cuda")
    calls[0]()
    for _ in range(attempts):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kept = [fn() for fn in calls]
            torch.cuda.synchronize()
        del kept
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (name is None or name in e.name)]
        if us:
            return sum(us) / len(calls) / 1e3
    return None


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


def timings(torch, calls, name: str, bound_ms: float, floor_ms: float,
            shape=None) -> dict:
    """The kernel's timing fields for a ``*_check`` line: ``device_ms``
    over ``calls`` (:func:`cold_device_ms`) and the profiler's reading of
    them, the host's over the first."""
    dev = cold_device_ms(torch, calls)
    return {"device_ms": dev,
            "profiler_ms": profiler_ms(torch, calls, name=name),
            "host_us": host_us(torch, calls[0]),
            "call_ms": call_ms(torch, calls[0]), "floor_device_ms": floor_ms,
            "bound_ms": bound_ms, "bound_share": bound_ms / dev}


def gate_calls(torch, fn, shape, g_mode, seed: int, offset: int = 0):
    """``fn(x, g)`` on :data:`COLD_CALLS` copies of the gate's inputs."""
    return [lambda x=x, g=g: fn(x, g) for x, g in (
        gate_inputs(torch, shape, g_mode, seed + k, offset)
        for k in range(COLD_CALLS))]


def epilogue_calls(torch, fn, b, s, bounds, seed: int, offset: int = 0):
    """``fn(wav, lo, hi)`` on :data:`COLD_CALLS` copies of the epilogue's
    inputs."""
    return [lambda w=w, lo=lo, hi=hi: fn(w, lo, hi) for w, lo, hi in (
        epilogue_inputs(torch, b, s, bounds, seed + k, offset)
        for k in range(COLD_CALLS))]


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


class PathCounts:
    """One path's counts, for ``with``: the acoustics calls and batched
    window decodes it makes (by wrapping ``vits.acoustics`` and
    ``PiperVoice._decode_windows``, on whatever thread runs them), the
    shapes it gives each hand kernel, and the kernels' launches.  Every
    count is set to 0 when the path starts and read when it ends.  The
    shapes also go to ``shapes``, the kernel checks' list."""

    def __init__(self, torch, vits, piper, gate, dop, shapes: dict):
        self._mods = torch, vits, piper, gate, dop
        self.shapes = shapes
        self.gate_shapes, self.epi_shapes = [], []

    def __enter__(self):
        torch, vits, piper, gate, dop = self._mods
        acoustics, windows = vits.acoustics, piper.PiperVoice._decode_windows
        self._saved = acoustics, windows
        self.acoustics_calls = self.window_decodes = 0

        def counted_acoustics(p, hp, m_p, *a, max_frames, g=None, **k):
            self.acoustics_calls += 1
            shape = ((m_p.shape[0], max_frames, 2 * hp.hidden_channels),
                     g is not None)
            self.gate_shapes.append(shape)
            self.shapes["gate"].append(shape)
            return acoustics(p, hp, m_p, *a, max_frames=max_frames, g=g, **k)

        def counted_windows(voice, z, sid, lo, hi):
            self.window_decodes += 1
            shape = (z.shape[0], z.shape[1] * voice.hp.hop_length)
            self.epi_shapes.append(shape)
            self.shapes["epilogue"].append(shape)
            return windows(voice, z, sid, lo, hi)

        torch.cuda.synchronize()
        vits.acoustics = counted_acoustics
        piper.PiperVoice._decode_windows = counted_windows
        gate.fused_gate.launches = 0
        dop.fused_epilogue.launches = 0
        return self

    def __exit__(self, *exc):
        torch, vits, piper, gate, dop = self._mods
        torch.cuda.synchronize()
        self.launches = {"fused_gate": gate.fused_gate.launches,
                         "fused_epilogue": dop.fused_epilogue.launches}
        vits.acoustics, piper.PiperVoice._decode_windows = self._saved
        return False

    def check(self, n_wn: int, what: str) -> None:
        """Each acoustics call launched the gate once per WN layer, each
        batched window decode the epilogue once."""
        require(self.launches["fused_gate"]
                == n_wn * self.acoustics_calls, (what, self.launches,
                                                 self.acoustics_calls))
        require(self.launches["fused_epilogue"] == self.window_decodes,
                (what, self.launches, self.window_decodes))

    def summary(self) -> dict:
        return {"acoustics_calls": self.acoustics_calls,
                "window_decodes": self.window_decodes,
                "launches": self.launches,
                "gate_shapes": sorted({s for s, _ in self.gate_shapes}),
                "epilogue_shapes": {f"{b}x{n}": c for (b, n), c in sorted(
                    Counter(self.epi_shapes).items())}}


def zero_noise(voice) -> None:
    """Zero noise scales: a row's audio then does not depend on its slot
    in a coalesced group, nor on the noise counter."""
    sc = voice.get_fallback_synthesis_config()
    sc.noise_w = 0.0
    sc.noise_scale = 0.0
    voice.set_fallback_synthesis_config(sc)


def run_together(fn, n: int) -> float:
    """``fn(i)`` for each ``i < n`` on its own thread, all released at once:
    the wall seconds from the release to the end of the last.  A thread's
    error is raised here."""
    errors = []
    barrier = threading.Barrier(n + 1, timeout=60)

    def run(i):
        try:
            barrier.wait()
            fn(i)
        except Exception as e:  # raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    require(not any(t.is_alive() for t in threads), "a thread hung")
    return wall


def run_streams(synth, texts) -> dict:
    """One stream a text, all started together through
    ``synthesize_streamed(chunk_size=45, chunk_padding=3)``: each stream's
    chunks and first-chunk time, and the wall time of the whole."""
    chunks, first = [None] * len(texts), [None] * len(texts)

    def stream(i):
        t0 = time.perf_counter()
        out = []
        for chunk in synth.synthesize_streamed(texts[i], chunk_size=45,
                                               chunk_padding=3):
            if not out:
                first[i] = time.perf_counter() - t0
            out.append(chunk.samples.data)
        chunks[i] = out

    wall = run_together(stream, len(texts))
    return {"chunks": chunks, "first_chunk_s": first, "wall_s": wall}


def stats_delta(before: dict, after: dict) -> dict:
    """An engine's counters over one round (``dispatch_stats`` views)."""
    before = before or {}
    d = {k: v - before.get(k, 0) for k, v in after.items()
         if isinstance(v, int) and k != "coalescing_ratio"}
    d["coalescing_ratio"] = d["requests"] / max(d["dispatches"], 1)
    return d


def audio_parity(got, want) -> dict:
    """Two float waveforms: the largest difference over ``want``'s peak."""
    import numpy as np

    diff = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    peak = float(np.abs(want).max())
    return {"samples": int(want.size), "peak": peak, "max_abs_diff": diff,
            "max_rel_diff": diff / peak if peak > 0 else float("inf")}


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


def snr_db(ref, x) -> float:
    """Waveform SNR (dB) of ``x`` against ``ref`` (the JAX test's)."""
    import numpy as np

    ref = np.asarray(ref, np.float64)
    err = np.asarray(x, np.float64) - ref
    return float(10 * np.log10(max(float((ref ** 2).mean()), 1e-12)
                               / max(float((err ** 2).mean()), 1e-30)))


def lsd_db(ref, x, nfft: int = 512) -> float:
    """Mean log-magnitude spectral distance (dB), the JAX test's."""
    import numpy as np

    ref = np.asarray(ref, np.float64).ravel()
    x = np.asarray(x, np.float64).ravel()
    n = (min(len(ref), len(x)) // nfft) * nfft
    r = np.fft.rfft(ref[:n].reshape(-1, nfft) * np.hanning(nfft), axis=1)
    y = np.fft.rfft(x[:n].reshape(-1, nfft) * np.hanning(nfft), axis=1)
    lr = 20 * np.log10(np.maximum(np.abs(r), 1e-8))
    ly = 20 * np.log10(np.maximum(np.abs(y), 1e-8))
    return float(np.sqrt(((lr - ly) ** 2).mean()))


class Ctx:
    """What the serving phases share with ``main``: torch, the card's line,
    the kernels' launch counting, each path's counts, the WN layers per
    acoustics call, and phase 2's file."""

    def __init__(self, torch, gpu, counting, paths, n_wn, main_wav, shapes):
        self.torch, self.gpu, self.counting = torch, gpu, counting
        self.paths, self.n_wn, self.main_wav = paths, n_wn, main_wav
        self.shapes = shapes


def medium_voice(torch, **kwargs):
    """Phase 2's voice: medium width, seed 0, its zero-init layers filled."""
    from sonata_tpu_torch.models import PiperVoice

    voice = PiperVoice.random(seed=0, **kwargs)
    fill_zero_init(torch, voice.model, seed=1)
    return voice


class env_set:
    """Set environment variables for a block, and restore them."""

    def __init__(self, **values):
        self._values = values

    def __enter__(self):
        self._saved = {k: os.environ.get(k) for k in self._values}
        os.environ.update(self._values)

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def phase_precision(ctx) -> None:
    """Phase 11: the file and a stream through each decoder arm."""
    import numpy as np

    from sonata_tpu_torch.audio import read_wave_file
    from sonata_tpu_torch.synth import SpeechSynthesizer

    torch = ctx.torch
    arms = {"float32": {}, "bfloat16": {"compute_dtype": "bfloat16"},
            "int8": {"decode_quant": "int8"}}
    out = {}
    with ctx.counting() as pc, tempfile.TemporaryDirectory() as tmp:
        for name, kw in arms.items():
            voice = medium_voice(torch, **kw)
            synth = SpeechSynthesizer(voice)
            # phase 2's warm-ups: the noise counter reaches the file where
            # phase 2's did
            list(synth.synthesize_parallel("Warm up."))
            list(synth.synthesize_streamed("Warm up the stream too.",
                                           chunk_size=45, chunk_padding=3))
            path = Path(tmp) / f"{name}.wav"
            t0 = time.perf_counter()
            synth.synthesize_to_file(path, TEXT)
            torch.cuda.synchronize()
            file_s = time.perf_counter() - t0
            chunks = [c.samples.data for c in synth.synthesize_streamed(
                STREAM_TEXT, chunk_size=45, chunk_padding=3)]
            # the HiFi-GAN at the main path's file shape, [4, 384] frames
            z = torch.randn((4, 384, voice.hp.inter_channels),
                            generator=torch.Generator().manual_seed(7)
                            ).to(voice.device)
            with torch.inference_mode():
                dec = call_ms(torch, lambda: voice._decode(z), iters=10)
                dec_prof = profiler_ms(torch, [lambda: voice._decode(z)] * 3)
                wav = voice._decode(z)
            require(wav.dtype == torch.float32, ("decode", name))
            out[name] = {"wav": read_wave_file(path)[0], "file_s": file_s,
                         "stream": np.concatenate(chunks),
                         "decode_device_ms": dec,
                         "decode_profiler_ms": dec_prof,
                         "dec_dtype": str(getattr(
                             voice.model.dec.conv_pre, "w_q",
                             voice.model.dec.conv_pre.weight).dtype),
                         "compute_dtype": str(voice.compute_dtype
                                              or torch.float32)}
            voice.close()
    ctx.paths["precision"] = pc
    pc.check(ctx.n_wn, "precision")
    ref = out["float32"]
    rows = {}
    for name, r in out.items():
        same = r["wav"].shape == ref["wav"].shape
        rows[name] = {"file_s": r["file_s"],
                      "decode_device_ms": r["decode_device_ms"],
                      "decode_profiler_ms": r["decode_profiler_ms"],
                      "decoder_weights": r["dec_dtype"],
                      "compute_dtype": r["compute_dtype"],
                      "samples": int(r["wav"].size)}
        if name != "float32":
            require(same and r["stream"].shape == ref["stream"].shape,
                    ("arm lengths", name))
            rows[name].update(
                file_snr_db=snr_db(ref["wav"], r["wav"]),
                file_lsd_db=lsd_db(ref["wav"], r["wav"]),
                stream_snr_db=snr_db(ref["stream"], r["stream"]),
                stream_lsd_db=lsd_db(ref["stream"], r["stream"]))
    f32_same = (ref["wav"].shape == ctx.main_wav.shape
                and bool(np.array_equal(ref["wav"], ctx.main_wav)))
    emit({"phase": "precision", "card": ctx.gpu, "arms": rows,
          "float32_identical_to_main": f32_same,
          "snr_db_min": SNR_DB_MIN, "lsd_db_max": LSD_DB_MAX,
          **pc.summary()})
    require(f32_same, "the float32 arm's WAV differs from phase 2's")
    for name in ("bfloat16", "int8"):
        r = rows[name]
        require(min(r["file_snr_db"], r["stream_snr_db"]) > SNR_DB_MIN,
                (name, r))
    # the spectral bar is the int8 arm's: a bfloat16 conv stack lifts the
    # quiet bins' noise floor past it in the reference too (PERF.md)
    r = rows["int8"]
    require(max(r["file_lsd_db"], r["stream_lsd_db"]) < LSD_DB_MAX,
            ("int8", r))


def phase_warmup(ctx) -> None:
    """Phase 12: the full lattice, then traffic it never saw."""
    from sonata_tpu_torch.serving import warmup
    from sonata_tpu_torch.synth import BatchScheduler, SpeechSynthesizer

    torch = ctx.torch
    with env_set(SONATA_BATCH_MODE="iteration"):
        voice = medium_voice(torch)
        sched = BatchScheduler(voice)
        voice.attach_batch_worker(lambda: sched)
        synth = SpeechSynthesizer(voice)
        try:
            list(synth.synthesize_parallel("Ready."))  # the calibration
            shapes = voice.lattice_shapes("full")
            progress = warmup.WarmupProgress()
            progress.reset()
            with ctx.counting() as lc:
                t0 = time.perf_counter()
                warmed = warmup.warm_model_lattice(
                    voice, mode="full", deadline=time.monotonic() + 900,
                    progress=progress, label="warmup")
                lattice_s = time.perf_counter() - t0
            ctx.paths["warmup_lattice"] = lc
            mark = len(voice.first_uses)
            sentences = list(voice.phonemize_text(WARM_FILE_TEXT))
            with ctx.counting() as wc:
                run = run_streams(synth, list(WARM_TEXTS))
                t0 = time.perf_counter()
                audio = [sched.speak(p, timeout=300) for p in sentences]
                file_s = time.perf_counter() - t0
            ctx.paths["warmup"] = wc
        finally:
            sched.shutdown()
            voice.close()
    lc.check(ctx.n_wn, "warmup lattice")
    wc.check(ctx.n_wn, "warmup traffic")
    new = voice.first_uses[mark:]
    inside = [u for u in new if (u[0], u[1]) in voice.warmed_shapes]
    outside = [u for u in new if (u[0], u[1]) not in voice.warmed_shapes]
    first = run["first_chunk_s"]
    kinds = Counter(s[0] if isinstance(s[0], str) else "full"
                    for s in shapes)
    emit({"phase": "warmup", "card": ctx.gpu, "mode": "full",
          "batch_mode": "iteration",
          "calibrated_frames_per_id": voice._frames_per_id,
          "lattice_shapes": len(shapes), "by_kind": dict(kinds),
          "warmed": warmed, "progress": progress.fraction(),
          "engine_shapes_warmed": len(voice.warmed_shapes),
          "lattice_s": lattice_s,
          "first_chunk_s": {"p50": statistics.median(first),
                            "max": max(first), "each": first},
          "unwarmed_lone_stream_first_chunk_s": {
              "cold": UNWARMED_FIRST_CHUNK_S, "warm": WARM_FIRST_CHUNK_S},
          "streams_wall_s": run["wall_s"],
          "file_sentences": len(audio), "file_wall_s": file_s,
          "cold_inside_lattice": [list(map(str, u)) for u in inside],
          "cold_outside_lattice": [list(map(str, u)) for u in outside],
          **wc.summary()})
    require(warmed == len(shapes) and progress.fraction() == 1.0,
            ("lattice incomplete", warmed, len(shapes)))
    require(not inside, ("cold dispatch on a warmed shape", inside))
    require(all(len(a.samples) > 0 for a in audio)
            and all(run["chunks"]), "warm-up traffic made no audio")


def save_voice(torch, directory: Path) -> Path:
    """Phase 2's voice as ``voice.pt`` beside ``voice.onnx.json`` with zero
    noise scales; returns the config path."""
    import numpy as np

    from sonata_tpu_torch.models.import_torch import params_to_state_dict
    from sonata_tpu_torch.models.weights import params_to_numpy

    voice = medium_voice(torch)
    state = params_to_state_dict(params_to_numpy(voice.model), voice.hp)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state.items()}, directory / "voice.pt")
    config = {"audio": {"sample_rate": 22050, "quality": "medium"},
              "num_speakers": 1, "espeak": {"voice": "en-us"},
              "num_symbols": voice.config.num_symbols,
              "phoneme_id_map": voice.config.phoneme_id_map,
              "model": dataclasses.asdict(voice.hp),
              "inference": {"noise_scale": 0.0, "length_scale": 1.0,
                            "noise_w": 0.0}}
    path = directory / "voice.onnx.json"
    path.write_text(json.dumps(config), encoding="utf-8")
    voice.close()
    return path


def http_get(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.getcode(), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def phase_serve(ctx, cfg: Path) -> None:
    """Phase 13: the gRPC server on the card, over loopback."""
    import grpc
    import numpy as np

    from sonata_tpu_torch.frontends import grpc_messages as pb
    from sonata_tpu_torch.frontends.grpc_server import create_server
    from sonata_tpu_torch.models import PiperVoice
    from sonata_tpu_torch.serving import parse_prometheus_text
    from sonata_tpu_torch.serving.drain import DRAIN_PHASES
    from sonata_tpu_torch.synth import SpeechSynthesizer

    torch = ctx.torch
    with env_set(SONATA_WARMUP_LATTICE="full",
                 SONATA_BATCH_MODE="iteration"):
        server, port = create_server(0, continuous_batching=True,
                                     replicas=1, metrics_port=0)
        service, rt = server.sonata_service, server.sonata_runtime
        server.start()
        try:
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")

            def unary(name, req, resp):
                return channel.unary_unary(
                    f"/sonata_grpc.sonata_grpc/{name}",
                    request_serializer=lambda m: m.encode(),
                    response_deserializer=resp.decode)(req)

            def stream(name, req, resp):
                return channel.unary_stream(
                    f"/sonata_grpc.sonata_grpc/{name}",
                    request_serializer=lambda m: m.encode(),
                    response_deserializer=resp.decode)(req)

            base = f"http://127.0.0.1:{rt.http_port}"
            t0 = time.perf_counter()
            vid = unary("LoadVoice", pb.VoicePath(config_path=str(cfg)),
                        pb.VoiceInfo).voice_id
            load_s = time.perf_counter() - t0
            ready_before = http_get(base + "/readyz")[0]
            with ctx.counting() as swc:
                t0 = time.perf_counter()
                service.warmup_and_mark_ready()
                warm_s = time.perf_counter() - t0
            ctx.paths["serve_warmup"] = swc
            ready_after = http_get(base + "/readyz")[0]
            v = service._voices[vid]
            texts = list(SERVE_TEXTS)
            responses, ttfb = [None] * len(texts), [None] * len(texts)

            def realtime(i):
                t0 = time.perf_counter()
                out = []
                for msg in stream("SynthesizeUtteranceRealtime",
                                  pb.Utterance(voice_id=vid,
                                               text=texts[i]),
                                  pb.WaveSamples):
                    if not out:
                        ttfb[i] = time.perf_counter() - t0
                    out.append(np.frombuffer(msg.wav_samples, "<i2"))
                responses[i] = out

            with ctx.counting() as sc:
                wall = run_together(realtime, len(texts))
                utter = []
                for i, text in enumerate(SERVE_UTTERANCES):
                    mode = (pb.SynthesisMode.LAZY if i < 2
                            else pb.SynthesisMode.BATCHED)
                    t0 = time.perf_counter()
                    items = list(stream("SynthesizeUtterance", pb.Utterance(
                        voice_id=vid, text=text, synthesis_mode=mode),
                        pb.SynthesisResult))
                    utter.append({"mode": "lazy" if i < 2 else "batched",
                                  "wall_s": time.perf_counter() - t0,
                                  "items": len(items),
                                  "samples": sum(len(m.wav_samples) // 2
                                                 for m in items)})
            ctx.paths["serve"] = sc
            code, body = http_get(base + "/metrics")
            require(code == 200, ("metrics scrape", code))
            parsed = parse_prometheus_text(body)
            cold = sum(val for _l, val in parsed.get(
                "sonata_runtime_cold_compiles_total", []))
            ready_code = http_get(base + "/readyz")[0]
            # a sentence's first batch on fresh threads (a handler pool's)
            # against the same sentence on the scheduler's warm worker
            replica = v.pool.replicas[0].model
            sentence = list(replica.phonemize_text(SERVE_UTTERANCES[0]))[0]
            fresh_ms = []
            for _ in range(3):
                box = {}

                def one():
                    t0 = time.perf_counter()
                    replica.speak_batch([sentence])
                    box["ms"] = (time.perf_counter() - t0) * 1e3

                t = threading.Thread(target=one)
                t.start()
                t.join(120)
                fresh_ms.append(box["ms"])
            worker_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                v.pool.speak(sentence, timeout=120)
                worker_ms.append((time.perf_counter() - t0) * 1e3)
            phase_router(ctx, cfg, port, rt, service, vid)
            drained = service.drain(reason="chip_smoke")
            phases = [p for p, _ms in rt.drain.phases]
            stragglers = rt.admission.in_flight
        finally:
            server.stop(grace=None)
            service.shutdown()
    swc.check(ctx.n_wn, "serve warm-up")
    sc.check(ctx.n_wn, "serve")
    # one realtime response against the CPU port's stream of its text
    cpu = PiperVoice.from_config_path(cfg, device="cpu")
    want = [np.frombuffer(c.as_wave_bytes(), "<i2") for c in
            SpeechSynthesizer(cpu).synthesize_streamed(
                texts[0], chunk_size=55, chunk_padding=3)]
    cpu.close()
    got = responses[0]
    same = [len(c) for c in got] == [len(c) for c in want]
    par = audio_parity(np.concatenate(got).astype(np.float32),
                       np.concatenate(want).astype(np.float32))
    audio_s = sum(sum(len(c) for c in r) for r in responses) / 22050
    emit({"phase": "serve", "card": ctx.gpu, "transport": "grpc loopback",
          "replicas": len(v.pool.replicas),
          "devices": [str(r.device) for r in v.pool.replicas],
          "lattice": "full", "batch_mode": "iteration",
          "load_voice_s": load_s, "warmup_s": warm_s,
          "warmup_progress": rt.warmup_progress.snapshot(),
          "readyz_before_warmup": ready_before,
          "readyz_after_warmup": ready_after,
          "realtime": {"streams": len(texts),
                       "ttfb_s": {"p50": statistics.median(ttfb),
                                  "max": max(ttfb), "each": ttfb},
                       "wall_s": wall, "audio_s": audio_s,
                       "audio_s_per_wall_s": audio_s / wall},
          "utterances": utter, "runtime_cold_compiles_total": cold,
          "readyz": ready_code,
          "first_batch_fresh_thread_ms": fresh_ms,
          "scheduler_worker_ms": worker_ms,
          "parity": {**par, "boundaries_identical": same,
                     "tolerance_rel": PARITY_TOL},
          "drained": drained, "drain_phases": phases,
          "stragglers": stragglers,
          "warmup_counts": {k: v for k, v in swc.summary().items()
                            if k in ("acoustics_calls", "window_decodes",
                                     "launches")},
          **sc.summary()})
    require(ready_before == 503 and ready_after == 200 and ready_code == 200,
            ("readyz", ready_before, ready_after, ready_code))
    require(cold == 0, ("runtime cold compiles after the warm-up", cold))
    require(all(responses) and all(u["samples"] > 0 for u in utter),
            "serve made no audio")
    require(same and par["max_rel_diff"] <= PARITY_TOL,
            ("serve vs CPU port", par, same))
    require(drained and phases == list(DRAIN_PHASES) and stragglers == 0,
            ("drain", drained, phases, stragglers))


def phase_router(ctx, cfg: Path, port: int, rt, service, vid: str) -> None:
    """Phase 13c: the port's router in front of phase 13's server."""
    import grpc
    import numpy as np

    from sonata_tpu_torch.frontends import grpc_messages as pb
    from sonata_tpu_torch.frontends.mesh_server import create_mesh_server
    from sonata_tpu_torch.serving import parse_prometheus_text

    with env_set(SONATA_FLEETCACHE="1"):
        router, rport = create_mesh_server(
            0, backends=f"127.0.0.1:{port}/{rt.http_port}", metrics_port=0,
            request_timeout_s=120.0)
    router.start()
    chans = {"router": grpc.insecure_channel(f"127.0.0.1:{rport}"),
             "direct": grpc.insecure_channel(f"127.0.0.1:{port}")}
    out, wall, trailers = {}, {}, {}
    try:
        routed_vid = chans["router"].unary_unary(
            "/sonata_grpc.sonata_grpc/LoadVoice",
            request_serializer=lambda m: m.encode(),
            response_deserializer=pb.VoiceInfo.decode)(
                pb.VoicePath(config_path=str(cfg))).voice_id
        calls = (("SynthesizeUtterance", pb.SynthesisResult,
                  SERVE_UTTERANCES[0]),
                 ("SynthesizeUtteranceRealtime", pb.WaveSamples,
                  SERVE_TEXTS[0]))
        with ctx.counting() as rc:
            for via in ("router", "direct"):
                for rpc, resp, text in calls:
                    t0 = time.perf_counter()
                    call = chans[via].unary_stream(
                        f"/sonata_grpc.sonata_grpc/{rpc}",
                        request_serializer=lambda m: m.encode(),
                        response_deserializer=resp.decode)(
                            pb.Utterance(voice_id=vid, text=text),
                            timeout=120.0)
                    out[via, rpc] = [np.frombuffer(m.wav_samples, "<i2")
                                     for m in call]
                    wall[f"{via}_{rpc}_s"] = time.perf_counter() - t0
                    trailers[via, rpc] = dict(call.trailing_metadata() or ())
        ctx.paths["router"] = rc
        code, body = http_get(
            f"http://127.0.0.1:{router.sonata_runtime.http_port}/metrics")
        routed = sum(v for _l, v in parse_prometheus_text(body).get(
            "sonata_mesh_routed_total", []))
        request = pb.Utterance.decode(pb.Utterance(
            voice_id=vid, text=SERVE_UTTERANCES[0]).encode())
        keys = {kind: (router.sonata_service.fleetcache.routing_key(
                           kind, request),
                       service._cache_key_for(service._voices[vid], request,
                                              kind))
                for kind in ("utterance", "realtime")}
    finally:
        for ch in chans.values():
            ch.close()
        router.stop(grace=None)
        router.sonata_service.shutdown()
    rc.check(ctx.n_wn, "router")
    identical = {rpc: len(out["router", rpc]) == len(out["direct", rpc]) > 0
                 and all(np.array_equal(a, b) for a, b in zip(
                     out["router", rpc], out["direct", rpc]))
                 for rpc, _r, _t in calls}
    node = {rpc: trailers["router", rpc].get("x-sonata-node-id")
            for rpc, _r, _t in calls}
    emit({"phase": "router", "card": ctx.gpu, "transport": "grpc loopback",
          "backend": rt.node_id, "voice_id_routed": routed_vid,
          "identical_to_direct": identical, "node_id_trailer": node,
          "metrics_code": code, "sonata_mesh_routed_total": routed,
          "fleetcache_keys_equal": {k: a == b for k, (a, b) in keys.items()},
          **wall, **rc.summary()})
    require(routed_vid == vid, ("router LoadVoice", routed_vid, vid))
    require(all(identical.values()), ("router vs direct", identical))
    require(all(n == rt.node_id for n in node.values()), ("trailer", node))
    require(code == 200 and routed >= 2, ("router metrics", code, routed))
    require(all(a == b and a is not None for a, b in keys.values()),
            ("fleet-cache key", keys))


class KernelRecorder:
    """The hand kernels' launches and shapes on a sharded path, for
    ``with``: the gate wrapped where ``wn_nct`` calls it and the epilogue
    where the voice calls it, each call's shape recorded (``[B, T, 2H]``
    with whether ``g`` came, and ``[B, S]``), on whatever thread or lane
    runs it.  The launch counts are set to 0 on entry and read on exit; the
    recorded shapes join ``shapes``, the kernel checks' list."""

    def __init__(self, torch, modules, gate, dop, shapes: dict):
        self._mods = torch, modules, gate, dop
        self.shapes = shapes

    def __enter__(self):
        torch, modules, gate, dop = self._mods
        self.gate_shapes, self.epi_shapes = [], []
        orig_gate, orig_epi = modules.gate_op, dop.fused_epilogue
        self._saved = orig_gate, orig_epi

        def gate_rec(x, g=None):
            self.gate_shapes.append((tuple(x.shape), g is not None))
            return orig_gate(x, g)

        def epi_rec(wav, lo, hi, *a, **k):
            self.epi_shapes.append(tuple(wav.shape))
            return orig_epi(wav, lo, hi, *a, **k)

        torch.cuda.synchronize()
        # the epilogue's wrapper counts through its module's name, which
        # now names the recorder: its launches land on the recorder
        gate.fused_gate.launches = epi_rec.launches = 0
        modules.gate_op, dop.fused_epilogue = gate_rec, epi_rec
        return self

    def __exit__(self, *exc):
        torch, modules, gate, dop = self._mods
        torch.cuda.synchronize()
        self.launches = {"fused_gate": gate.fused_gate.launches,
                         "fused_epilogue": dop.fused_epilogue.launches}
        modules.gate_op, dop.fused_epilogue = self._saved
        self.shapes["gate"].extend(sorted(set(self.gate_shapes)))
        self.shapes["epilogue"].extend(sorted(set(self.epi_shapes)))
        return False

    def summary(self) -> dict:
        return {"launches": self.launches,
                "gate_shapes": {f"{b}x{t}x{h}" + ("+g" if g else ""): c
                                for ((b, t, h), g), c in sorted(
                                    Counter(self.gate_shapes).items())},
                "epilogue_shapes": {f"{b}x{n}": c for (b, n), c in sorted(
                    Counter(self.epi_shapes).items())}}


def mesh_run(torch, voice) -> dict:
    """Phase 14b's traffic on a fresh voice, in one order: the file, one
    stream, the long utterance."""
    from sonata_tpu_torch.audio import read_wave_file
    from sonata_tpu_torch.synth import SpeechSynthesizer

    synth = SpeechSynthesizer(voice)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        synth.synthesize_to_file(Path(tmp) / "mesh.wav", TEXT)
        torch.cuda.synchronize()
        out["file_s"] = time.perf_counter() - t0
        out["file"] = read_wave_file(Path(tmp) / "mesh.wav")[0]
    t0 = time.perf_counter()
    out["chunks"] = [c.samples.data for c in synth.synthesize_streamed(
        STREAM_TEXT, chunk_size=45, chunk_padding=3)]
    out["stream_s"] = time.perf_counter() - t0
    sentence = list(voice.phonemize_text(MESH_LONG_TEXT))[0]
    t0 = time.perf_counter()
    out["long"] = voice.speak_batch([sentence])[0].samples.data
    out["long_s"] = time.perf_counter() - t0
    synth.close()
    return out


def phase_mesh(ctx, cfg: Path) -> None:
    """Phase 14b: the device mesh on the one card."""
    import numpy as np

    from sonata_tpu_torch.frontends import grpc_messages as pb
    from sonata_tpu_torch.frontends import grpc_server
    from sonata_tpu_torch.models import PiperVoice, decode_opts as dop
    from sonata_tpu_torch.models import modules, vits
    from sonata_tpu_torch.models.seq_parallel import decode_sp
    from sonata_tpu_torch.ops import gate
    from sonata_tpu_torch.parallel import make_mesh
    from sonata_tpu_torch.utils.buckets import FRAME_BUCKETS

    torch = ctx.torch
    base = medium_voice(torch)  # its weights, shared by every voice below
    hp = base.hp

    def fresh(mesh=None):
        return PiperVoice(base.config, base.model, seed=0, mesh=mesh)

    want = mesh_run(torch, fresh())
    emit({"phase": "mesh", "card": ctx.gpu, "layout": "unsharded",
          **{k: want[k] for k in ("file_s", "stream_s", "long_s")},
          "long_samples": len(want["long"])})
    card0 = base.device  # the one card, repeated in every mesh
    for name, n, seq, model in MESH_LAYOUTS:
        mesh = make_mesh(devices=[card0] * n, seq_parallel=seq,
                         model_parallel=model)
        voice = fresh(mesh)
        with KernelRecorder(torch, modules, gate, dop, ctx.shapes) as rec:
            got = mesh_run(torch, voice)
        ctx.paths[f"mesh_{name}"] = rec
        file_par = audio_parity(got["file"].astype(np.float32),
                                want["file"].astype(np.float32))
        stream_par = audio_parity(np.concatenate(got["chunks"]),
                                  np.concatenate(want["chunks"]))
        stream_par["boundaries_identical"] = (
            [len(c) for c in got["chunks"]]
            == [len(c) for c in want["chunks"]])
        long_par = audio_parity(got["long"], want["long"])
        # frame counts the flow ran on that are a bucket split over seq
        sharded_t = sorted({t for (_b, t, _h), _g in rec.gate_shapes
                            if t * seq in FRAME_BUCKETS}
                           if seq > 1 and model == 1 else ())
        emit({"phase": "mesh", "card": ctx.gpu, "layout": name,
              "mesh": mesh.shape, "devices": [str(d) for d in
                                              mesh.devices.flat],
              "file": file_par, "stream": stream_par, "long": long_par,
              "file_s": got["file_s"], "stream_s": got["stream_s"],
              "long_s": got["long_s"], "long_samples": len(got["long"]),
              "seq_shard_frames": sharded_t,
              "tolerance_rel": PARITY_TOL, **rec.summary()})
        require(rec.launches["fused_gate"] == len(rec.gate_shapes) > 0
                and rec.launches["fused_epilogue"]
                == len(rec.epi_shapes) > 0, (name, rec.summary()))
        require(all(p["max_rel_diff"] <= PARITY_TOL
                    for p in (file_par, stream_par, long_par))
                and stream_par["boundaries_identical"]
                and len(got["long"]) > 3000, (name, file_par, stream_par,
                                              long_par))
        require(seq == 1 or model > 1 or sharded_t,
                (name, "the flow never ran on frame shards"))
        voice.close()
    # the bf16 decode_sp against the unsharded bf16 decode
    gen = torch.Generator(device=card0).manual_seed(5)
    z = torch.randn((2, 256, hp.inter_channels), generator=gen,
                    device=card0)
    with torch.inference_mode():
        sharded = decode_sp(base.model, hp, z,
                            make_mesh(devices=[card0] * 2, seq_parallel=2),
                            compute_dtype=torch.bfloat16)
        whole = vits.decode_with(base.model, hp, z,
                                 compute_dtype=torch.bfloat16)
    sharded, whole = sharded.cpu().numpy(), whole.cpu().numpy()
    bf16 = {"shape": list(sharded.shape),
            "max_abs_diff": float(np.abs(sharded - whole).max()),
            "snr_db": snr_db(whole, sharded), "snr_db_min": SNR_DB_MIN}
    # the server's main() with --mesh-devices 1 serves a sentence (its
    # blocking wait is replaced by the requests), and a 2 is refused
    import grpc
    import signal

    real_create, box = grpc_server.create_server, {}

    def create_and_serve(*a, **k):
        server, port = real_create(*a, **k)

        def requests():
            ch = grpc.insecure_channel(f"127.0.0.1:{port}")
            try:
                vid = ch.unary_unary(
                    "/sonata_grpc.sonata_grpc/LoadVoice",
                    request_serializer=lambda m: m.encode(),
                    response_deserializer=pb.VoiceInfo.decode)(
                        pb.VoicePath(config_path=str(cfg))).voice_id
                box["served"] = list(ch.unary_stream(
                    "/sonata_grpc.sonata_grpc/SynthesizeUtterance",
                    request_serializer=lambda m: m.encode(),
                    response_deserializer=pb.SynthesisResult.decode)(
                        pb.Utterance(voice_id=vid,
                                     text=SERVE_UTTERANCES[0]),
                        timeout=120.0))
                box["mesh"] = server.sonata_service._voices[
                    vid].voice.mesh.shape
            finally:
                ch.close()
            raise KeyboardInterrupt  # main() then stops the server

        server.wait_for_termination = requests
        return server, port

    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    grpc_server.create_server = create_and_serve
    try:
        grpc_server.main(["--port", "0", "--mesh-devices", "1",
                          "--request-timeout-s", "120"])
    finally:
        grpc_server.create_server = real_create
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    served, served_mesh = box.get("served"), box.get("mesh")
    too_many = torch.cuda.device_count() + 1

    def accepted(*_a, **_k):  # reached only when the flag was accepted
        raise RuntimeError("--mesh-devices was accepted")

    saved, grpc_server.create_server = grpc_server.create_server, accepted
    try:
        grpc_server.main(["--mesh-devices", str(too_many)])
        refused = False
    except SystemExit as e:
        refused = e.code not in (0, None)
    except RuntimeError:
        refused = False
    finally:
        grpc_server.create_server = saved
    emit({"phase": "mesh_serve", "card": ctx.gpu, "bf16_decode_sp": bf16,
          "served_mesh": served_mesh,
          "served_samples": sum(len(m.wav_samples) // 2
                                for m in served or ()),
          f"mesh_devices_{too_many}_refused": refused,
          "cross_card_transport": "not measured: the mesh repeats one card"})
    require(bf16["snr_db"] > SNR_DB_MIN, ("bf16 decode_sp", bf16))
    require(served and served_mesh == {"data": 1, "seq": 1, "model": 1},
            ("mesh server", served_mesh))
    require(refused, f"--mesh-devices {too_many} was not refused")
    base.close()


def phase_serve_plain(ctx, cfg: Path) -> None:
    """Phase 13b: the gRPC server as ``create_server`` builds it by default
    (no ``--continuous-batching``, no pool), the ``full`` lattice.  Batch
    synthesis from its handler threads runs on the voice's batch thread,
    which the lattice warms: 8 single-sentence ``SynthesizeUtterance``
    calls with speech args, lazy and batched in turn, each from a fresh
    client thread; the wall time of each, no batch shape met for the first
    time after the warm-up, and ``sonata_runtime_cold_compiles_total`` 0."""
    import grpc

    from sonata_tpu_torch.frontends import grpc_messages as pb
    from sonata_tpu_torch.frontends.grpc_server import create_server
    from sonata_tpu_torch.serving import parse_prometheus_text

    with env_set(SONATA_WARMUP_LATTICE="full"):
        server, port = create_server(0, metrics_port=0)
        service, rt = server.sonata_service, server.sonata_runtime
        server.start()
        try:
            channel = grpc.insecure_channel(f"127.0.0.1:{port}")
            vid = channel.unary_unary(
                "/sonata_grpc.sonata_grpc/LoadVoice",
                request_serializer=lambda m: m.encode(),
                response_deserializer=pb.VoiceInfo.decode)(
                pb.VoicePath(config_path=str(cfg))).voice_id
            synth = channel.unary_stream(
                "/sonata_grpc.sonata_grpc/SynthesizeUtterance",
                request_serializer=lambda m: m.encode(),
                response_deserializer=pb.SynthesisResult.decode)
            with ctx.counting() as wc:
                t0 = time.perf_counter()
                service.warmup_and_mark_ready()
                warm_s = time.perf_counter() - t0
            ctx.paths["serve_plain_warmup"] = wc
            voice = service._voices[vid].voice
            mark = len(voice.first_uses)
            args = pb.SpeechArgs(**PROSODY)
            calls = []
            with ctx.counting() as pc:
                for i in range(8):
                    mode = ("lazy", "batched")[i % 2]
                    req = pb.Utterance(
                        voice_id=vid, text=SERVE_UTTERANCES[i // 2],
                        synthesis_mode=getattr(pb.SynthesisMode,
                                               mode.upper()),
                        speech_args=args)
                    box = {}

                    def one():
                        t0 = time.perf_counter()
                        box["items"] = list(synth(req))
                        box["ms"] = (time.perf_counter() - t0) * 1e3

                    t = threading.Thread(target=one)
                    t.start()
                    t.join(120)
                    calls.append({"mode": mode, "ms": box["ms"],
                                  "items": len(box["items"]),
                                  "samples": sum(len(m.wav_samples) // 2
                                                 for m in box["items"])})
            ctx.paths["serve_plain"] = pc
            code, body = http_get(
                f"http://127.0.0.1:{rt.http_port}/metrics")
            require(code == 200, ("metrics scrape", code))
            cold = sum(val for _l, val in parse_prometheus_text(body).get(
                "sonata_runtime_cold_compiles_total", []))
            new = [u for u in voice.first_uses[mark:] if u[0] == "batch"]
            batch_threads = sorted({u[2] for u in voice.first_uses
                                    if u[0] == "batch"})
        finally:
            server.stop(grace=None)
            service.shutdown()
    wc.check(ctx.n_wn, "serve_plain warm-up")
    pc.check(ctx.n_wn, "serve_plain")
    emit({"phase": "serve_plain", "card": ctx.gpu, "lattice": "full",
          "continuous_batching": False, "warmup_s": warm_s,
          "speech_args": PROSODY, "calls": calls,
          "batch_first_uses_after_warmup": [list(map(str, u)) for u in new],
          "batch_threads": batch_threads,
          "runtime_cold_compiles_total": cold,
          "warmup_counts": {k: v for k, v in wc.summary().items()
                            if k in ("acoustics_calls", "window_decodes",
                                     "launches")},
          **pc.summary()})
    require(all(c["items"] == 1 and c["samples"] > 0 for c in calls),
            ("serve_plain made no audio", calls))
    require(batch_threads == ["sonata_batch_thread"],
            ("a batch ran off the voice's batch thread", batch_threads))
    require(not new and cold == 0,
            ("serve_plain met a batch shape cold", new, cold))


def _capi_types():
    """``SonataSynthesisEvent``, the callback type and
    ``SonataSynthesisParams`` of ``libsonata_tpu.h``, for ctypes."""
    import ctypes

    class Event(ctypes.Structure):
        _fields_ = [("event_type", ctypes.c_int32),
                    ("error", ctypes.c_char_p), ("len", ctypes.c_uint64),
                    ("data", ctypes.POINTER(ctypes.c_int16))]

    callback = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.POINTER(Event),
                                ctypes.c_void_p)

    class Params(ctypes.Structure):
        _fields_ = [("mode", ctypes.c_int32), ("rate", ctypes.c_uint8),
                    ("volume", ctypes.c_uint8), ("pitch", ctypes.c_uint8),
                    ("appended_silence_ms", ctypes.c_uint32),
                    ("callback", callback), ("user_data", ctypes.c_void_p),
                    ("nonblocking", ctypes.c_int32)]

    return callback, Params


def phase_frontends(ctx, cfg: Path) -> None:
    """Phase 14: the CLI, the C ABI and pysonata against the library."""
    import ctypes

    from sonata_tpu_torch import pysonata
    from sonata_tpu_torch.audio import read_wave_file
    from sonata_tpu_torch.native import load_capi_library
    from sonata_tpu_torch.synth import SpeechSynthesizer

    callback, CapiParams = _capi_types()
    times, wavs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with ctx.counting() as fc:
            t0 = time.perf_counter()
            synth = SpeechSynthesizer.from_config_path(cfg)
            synth.synthesize_to_file(tmp / "library.wav", TEXT)
            times["library"] = time.perf_counter() - t0
            # the C ABI's realtime mode (2) streams 72-frame chunks
            lib_chunks = [c.as_wave_bytes() for c in synth.synthesize_streamed(
                STREAM_TEXT, chunk_size=72, chunk_padding=3)]
            synth.close()
            t0 = time.perf_counter()
            lib = load_capi_library()
            require(lib is not None, "the C ABI library did not build")
            lib.libsonataLoadVoiceFromConfigPath.restype = ctypes.c_int64
            lib.libsonataLoadVoiceFromConfigPath.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
            lib.libsonataSpeakToFile.argtypes = [
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(CapiParams)]
            lib.libsonataUnloadSonataVoice.argtypes = [ctypes.c_int64]
            err = ctypes.c_char_p()
            handle = lib.libsonataLoadVoiceFromConfigPath(
                str(cfg).encode(), ctypes.byref(err))
            require(handle > 0, ("C ABI load", err.value))
            # libsonata_tpu.h's SonataSynthesisParams, in the batched mode
            # (1): the library's synthesize_to_file batches the same way
            params = CapiParams(mode=1, rate=255, volume=255, pitch=255)
            rc = lib.libsonataSpeakToFile(handle, TEXT.encode(),
                                          str(tmp / "capi.wav").encode(),
                                          ctypes.byref(params))
            require(rc == 0, ("C ABI speak", rc))
            events = []

            def on_event(ev_ptr, user):
                ev = ev_ptr.contents
                events.append(ctypes.string_at(ev.data, 2 * ev.len)
                              if ev.event_type == 0 else ev.event_type)
                return 0

            lib.libsonataSpeak.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                           ctypes.POINTER(CapiParams)]
            stream_params = CapiParams(mode=2, rate=255, volume=255,
                                       pitch=255,
                                       callback=callback(on_event))
            rc = lib.libsonataSpeak(handle, STREAM_TEXT.encode(),
                                    ctypes.byref(stream_params))
            require(rc == 0 and events and events[-1] == 1,
                    ("C ABI realtime", rc, events[-1:]))
            require(lib.libsonataUnloadSonataVoice(handle) == 0,
                    "C ABI unload")
            times["capi"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            model = pysonata.PiperModel(cfg)
            pysonata.Sonata.with_piper(model).synthesize_to_file(
                tmp / "pysonata.wav", TEXT)
            times["pysonata"] = time.perf_counter() - t0
            model._voice.close()
        ctx.paths["frontends"] = fc
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sonata_tpu_torch.frontends.cli",
             str(cfg), TEXT, "-o", str(tmp / "cli.wav")],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        times["cli_subprocess"] = time.perf_counter() - t0
        require(proc.returncode == 0, ("CLI", proc.returncode,
                                       proc.stderr[-2000:]))
        for name in ("library", "cli", "capi", "pysonata"):
            wavs[name] = read_wave_file(tmp / f"{name}.wav")
    fc.check(ctx.n_wn, "frontends")
    ref, rate, _ = wavs["library"]
    same = {name: bool(w[0].shape == ref.shape and (w[0] == ref).all()
                       and w[1] == rate)
            for name, w in wavs.items() if name != "library"}
    same["capi_realtime"] = events[:-1] == lib_chunks
    emit({"phase": "frontends", "card": ctx.gpu, "samples": int(ref.size),
          "capi_realtime_chunks": len(events) - 1,
          "identical_to_library": same, "wall_s": times, **fc.summary()})
    require(ref.size > 0 and all(same.values()),
            ("a frontend's WAV differs from the library's", same))


def phase_train(ctx) -> None:
    """Phase 14c: the tagger trained on the card."""
    import numpy as np

    from sonata_tpu_torch.models import tashkeel_train as tt
    from sonata_tpu_torch.models.tashkeel import TashkeelModel
    from sonata_tpu_torch.text.tashkeel import BUNDLED_MODEL

    torch, hp = ctx.torch, tt.BUNDLED_HP
    model = TashkeelModel.random(hp, seed=0)  # on the card
    cpu = TashkeelModel.random(hp, seed=0, device="cpu")
    # step 0 on both: the same parameters, the tool's first batch
    batch = tt.make_batch(model, random.Random(0), TRAIN_BATCH)
    loss_card, grads_card = tt.loss_and_grads(model.module, *batch)
    loss_cpu, grads_cpu = tt.loss_and_grads(cpu.module,
                                            *(t.cpu() for t in batch))
    grad_err = {k: float((grads_card[k].cpu() - g).abs().max())
                for k, g in grads_cpu.items()}
    loss_rel = abs(float(loss_card) / float(loss_cpu) - 1)
    step0 = {"loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
             "loss_rel_err": loss_rel, "grads": len(grad_err),
             "grad_max_abs_err": max(grad_err.values()),
             "worst_grad": max(grad_err, key=grad_err.get),
             "grad_max_abs": max(float(g.abs().max())
                                 for g in grads_cpu.values()),
             "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                           "grad_atol": TRAIN_GRAD_ATOL}}
    require(loss_rel <= TRAIN_LOSS_RTOL
            and step0["grad_max_abs_err"] <= TRAIN_GRAD_ATOL,
            ("training step 0, card against CPU port", step0))
    del cpu

    with ctx.counting() as counts:
        run = tt.train(hp, steps=TRAIN_STEPS, batch=TRAIN_BATCH, lr=TRAIN_LR,
                       model=model, log=None)
    ctx.paths["train"] = counts
    losses = run.losses
    require(len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
            and losses[-1] < losses[0], ("training losses", losses[::50]))
    accuracy = tt.held_out_accuracy(model)

    held_out = tt.held_out_sentences()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tagger.npz"
        model.save(path)
        file_mb = path.stat().st_size / 2 ** 20
        loaded = TashkeelModel.from_path(path, device="cuda")
        same = [loaded.diacritize(t) == model.diacritize(t)
                for t in held_out]

    gold = [ln.strip() for ln in (Path(__file__).resolve().parent / "tools"
                                  / "tashkeel_gold.txt").read_text(
        encoding="utf-8").splitlines() if ln.strip()]
    bundled = TashkeelModel.from_path(BUNDLED_MODEL)
    scores = {name: tt.gold_report(m.diacritize, gold)
              for name, m in (("trained", model), ("bundled", bundled))}

    step_ms = run.step_ms
    emit({"phase": "train", "card": ctx.gpu, "hp": dataclasses.asdict(hp),
          "params": sum(p.numel() for p in model.module.parameters()),
          "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
          "step0_card_vs_cpu": step0,
          "loss": {str(i): losses[i] for i in
                   list(range(0, TRAIN_STEPS, 50)) + [TRAIN_STEPS - 1]},
          "wall_s": run.wall_s, "batch_host_s": run.batch_s,
          "step_clock": run.step_clock,
          "steps_device_s": sum(step_ms) / 1e3,
          "ms_per_step": run.wall_s * 1e3 / TRAIN_STEPS,
          "step_device_ms_median": statistics.median(step_ms),
          "step_device_ms_max": max(step_ms),
          "steps_per_s": TRAIN_STEPS / run.wall_s,
          "held_out_accuracy": accuracy, "gate": tt.ACCURACY_GATE,
          "round_trip": {"file_mb": file_mb, "sentences": len(same),
                         "identical": sum(same)},
          "gold": {"corpus": "tools/tashkeel_gold.txt",
                   "sentences": len(gold), **scores},
          "hand_kernels": "training launches neither the gate nor the "
                          "epilogue", **counts.summary()})
    require(accuracy >= tt.ACCURACY_GATE, ("held-out accuracy", accuracy))
    require(all(same), ("reloaded tagger diacritizes otherwise",
                        same.count(False)))
    require(counts.launches == {"fused_gate": 0, "fused_epilogue": 0},
            ("training launched a hand kernel", counts.launches))


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
    from sonata_tpu_torch.native import load_dsp_library
    from sonata_tpu_torch.synth import (
        AudioOutputConfig, BatchScheduler, SpeechSynthesizer)
    from sonata_tpu_torch.synth import output as synth_output
    from sonata_tpu_torch.utils.dispatch_policy import resolve_policy
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

    shapes = {"gate": [], "epilogue": []}  # every path's, for the checks
    paths = {}  # each path's counts

    def counting():
        return PathCounts(torch, vits, piper, gate, dop, shapes)

    # -- 2. main path -----------------------------------------------------------
    voice = PiperVoice.random(seed=0)  # medium width, on the GPU
    fill_zero_init(torch, voice.model, seed=1)
    synth = SpeechSynthesizer(voice)
    hp = voice.hp
    n_wn = hp.flow_n_layers * hp.flow_wn_layers
    # warm cuDNN's heuristics and the allocator on both paths, so the
    # timed run below is the steady state
    list(synth.synthesize_parallel("Warm up."))
    list(synth.synthesize_streamed("Warm up the stream too.",
                                   chunk_size=45, chunk_padding=3))
    with counting() as main_counts:
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
    paths["main"] = main_counts
    launches = main_counts.launches
    main_gate_shapes = [s for s in main_counts.gate_shapes]
    main_epi_shapes = list(main_counts.epi_shapes)

    main_counts.check(n_wn, "main")
    require(main_counts.acoustics_calls > 0 and chunks
            and main_counts.window_decodes > 0, "main path did nothing")
    stream = np.concatenate(chunks)
    require(rate == 22050 and samples.size > 0, ("wav", rate, samples.size))
    require(np.abs(samples).max() > 0, "silent WAV")
    require(stream.size % hp.hop_length == 0
            and bool(np.isfinite(stream).all()), "stream length/finite")
    require(np.abs(stream).max() > 0, "silent stream")
    file_audio_s = samples.size / rate
    stream_audio_s = stream.size / rate
    emit({"phase": "main", "card": gpu, "width": "medium",
          "policy": voice.dispatch_policy.as_dict(),
          "batch_mode": voice.dispatch_stats()["batch_mode"],
          **main_counts.summary(),
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
    with counting() as ar_counts:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ar_synth.synthesize_to_file(Path(tmp) / "ar.wav", AR_TEXT)
            torch.cuda.synchronize()
            ar_file_s = time.perf_counter() - t0
            ar_samples, ar_rate, _ = read_wave_file(Path(tmp) / "ar.wav")
        t0 = time.perf_counter()
        ar_first_s, ar_chunks = None, []
        for chunk in ar_synth.synthesize_streamed(AR_STREAM_TEXT,
                                                  chunk_size=45,
                                                  chunk_padding=3):
            if ar_first_s is None:
                ar_first_s = time.perf_counter() - t0
            ar_chunks.append(chunk.samples.data)
        ar_stream_s = time.perf_counter() - t0
    paths["arabic"] = ar_counts
    ar_counts.check(n_wn, "arabic")
    require(ar_counts.acoustics_calls > 0 and ar_chunks
            and ar_counts.window_decodes > 0, "Arabic path did nothing")
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
          **ar_counts.summary(),
          "file_wall_s": ar_file_s,
          "file_audio_s": ar_samples.size / ar_rate,
          "file_rtf": ar_file_s / (ar_samples.size / ar_rate),
          "stream_wall_s": ar_stream_s,
          "stream_audio_s": ar_stream.size / ar_rate,
          "stream_rtf": ar_stream_s / (ar_stream.size / ar_rate),
          "first_chunk_s": ar_first_s, "chunks": len(ar_chunks),
          "parity": ar_parity})
    require(all(r["ok"] for r in ar_parity), ("Arabic gpu vs cpu", ar_parity))

    # -- 8. concurrent streams through the coalescers ----------------------------
    base = resolve_policy(env={"SONATA_DISPATCH_POLICY": "on"})
    conc = {}
    for dev in (None, "cpu"):
        v = PiperVoice.random(seed=0, device=dev, dispatch_policy=(
            dataclasses.replace(base, backend="cpu" if dev else "cuda",
                                stream_stage_max_wait_ms=STAGE_WAIT_MS)))
        fill_zero_init(torch, v.model, seed=1)
        zero_noise(v)
        conc[dev] = SpeechSynthesizer(v)
    texts = list(CONCURRENT_TEXTS)
    mode_env = os.environ.get("SONATA_BATCH_MODE")
    try:
        # the reference: the same 8 streams in one group on the CPU port
        os.environ["SONATA_BATCH_MODE"] = "iteration"
        t0 = time.perf_counter()
        cpu_run = run_streams(conc["cpu"], texts)
        cpu_s = time.perf_counter() - t0
        for mode in ("dispatch", "iteration"):
            os.environ["SONATA_BATCH_MODE"] = mode
            gsynth = conc[None]
            engine = "stream_decode" if mode == "dispatch" else "iteration"
            run_streams(gsynth, texts)  # warm this engine's shapes
            before = gsynth.dispatch_stats()
            with counting() as cc:
                run = run_streams(gsynth, texts)
            after = gsynth.dispatch_stats()
            paths[f"concurrent_{mode}"] = cc
            prof = profile_run(torch, lambda: run_streams(gsynth, texts))
            stage = stats_delta(before["stream_stage"], after["stream_stage"])
            decode = stats_delta(before[engine], after[engine])
            parity = []
            for i, (g_, c_) in enumerate(zip(run["chunks"],
                                             cpu_run["chunks"])):
                par = audio_parity(np.concatenate(g_), np.concatenate(c_))
                par["boundaries_identical"] = (
                    [len(c) for c in g_] == [len(c) for c in c_])
                par["chunks"] = len(g_)
                parity.append(par)
            audio_s = sum(sum(len(c) for c in ch)
                          for ch in run["chunks"]) / 22050
            first = run["first_chunk_s"]
            emit({"phase": "concurrent", "card": gpu, "mode": mode,
                  "streams": len(texts), "policy": after["policy"],
                  "stage": stage, "decode": decode, **cc.summary(),
                  "first_chunk_s": {"p50": statistics.median(first),
                                    "max": max(first), "each": first},
                  "wall_s": run["wall_s"], "audio_s": audio_s,
                  "audio_s_per_wall_s": audio_s / run["wall_s"],
                  "profiled": {k: prof[k] for k in (
                      "wall_s", "device_busy_s", "idle_share",
                      "device_events")},
                  "cpu_reference_s": cpu_s, "tolerance_rel": PARITY_TOL,
                  "parity": parity})
            cc.check(n_wn, ("concurrent", mode))
            require(stage["dispatches"] == 1
                    and stage["requests"] == len(texts),
                    ("the 8 starts were not one stage group", stage))
            require(any(b == 8 for (b, _, _), _ in cc.gate_shapes),
                    ("gate not at B = 8", cc.gate_shapes))
            require(cc.window_decodes > 0
                    and max(b for b, _ in cc.epi_shapes) > 1,
                    ("epilogue never batched", cc.epi_shapes))
            require(decode["dispatches"] == cc.window_decodes
                    and decode["requests"] == sum(p["chunks"]
                                                  for p in parity),
                    ("decode counters", decode, cc.window_decodes))
            require(all(p["boundaries_identical"]
                        and p["max_rel_diff"] <= PARITY_TOL
                        for p in parity), ("concurrent parity", parity))
    finally:
        if mode_env is None:
            os.environ.pop("SONATA_BATCH_MODE", None)
        else:
            os.environ["SONATA_BATCH_MODE"] = mode_env
    conc["cpu"].close()

    # -- 9. the batch scheduler over the GPU voice -------------------------------
    svoice = conc[None].model
    phonemes = [svoice.phonemize_text(t).sentences[0] for t in SCHED_TEXTS]
    want = svoice.speak_batch(phonemes)  # the reference: one call
    sizes = []
    speak_batch = piper.PiperVoice.speak_batch

    def recorded_batch(self, sentences, *a, **k):
        sizes.append(len(sentences))
        return speak_batch(self, sentences, *a, **k)

    sched = BatchScheduler(svoice)  # knobs from the voice's policy
    got = [None] * len(phonemes)

    def submit(i):
        got[i] = sched.speak(phonemes[i], timeout=300)

    piper.PiperVoice.speak_batch = recorded_batch
    try:
        with counting() as sc_counts:
            sched_wall = run_together(submit, len(phonemes))
    finally:
        piper.PiperVoice.speak_batch = speak_batch
        sched.shutdown()
    paths["scheduler"] = sc_counts
    sched_stats = sched.stats_view()
    sched_parity = [audio_parity(g.samples.data, w.samples.data)
                    for g, w in zip(got, want)]
    emit({"phase": "scheduler", "card": gpu, "sentences": len(phonemes),
          "max_batch": sched._max_batch,
          "max_wait_ms": sched._max_wait * 1e3,
          "requests": sched_stats["requests"],
          "dispatches": sched_stats["dispatches"],
          "coalescing_ratio": sched_stats["coalescing_ratio"],
          "rows_per_dispatch": sizes, "wall_s": sched_wall,
          **sc_counts.summary(), "tolerance_rel": PARITY_TOL,
          "parity": sched_parity})
    sc_counts.check(n_wn, "scheduler")
    require(sched_stats["requests"] == len(phonemes) and sc_counts.launches[
        "fused_gate"] > 0, ("scheduler", sched_stats))
    require(all(p["max_rel_diff"] <= PARITY_TOL for p in sched_parity),
            ("scheduler parity", sched_parity))
    conc[None].close()
    del conc, svoice

    # -- 10. prosody output ------------------------------------------------------
    arms = dict(synth_output.process_prosody.arms)
    for v in (voice, cpu_voice):
        zero_noise(v)
    cpu_synth = SpeechSynthesizer(cpu_voice)
    norms = (None, "global")

    def prosody_run(sy, norm, tmp):
        cfg = AudioOutputConfig(**PROSODY, stream_normalization=norm)
        path = Path(tmp) / f"{id(sy)}-{norm}.wav"
        sy.synthesize_to_file(path, TEXT, cfg)
        chunks = list(sy.synthesize_streamed(STREAM_TEXT, cfg, chunk_size=45,
                                             chunk_padding=3))
        return read_wave_file(path)[0], chunks

    with tempfile.TemporaryDirectory() as tmp:
        want = {norm: prosody_run(cpu_synth, norm, tmp) for norm in norms}
        with counting() as pr_counts:
            got = {norm: prosody_run(synth, norm, tmp) for norm in norms}
    paths["prosody"] = pr_counts
    pr_counts.check(n_wn, "prosody")
    arms = {k: v - arms[k]
            for k, v in synth_output.process_prosody.arms.items()}
    prosody = []
    for norm in norms:
        (gw, gc), (cw, cc_) = got[norm], want[norm]
        file_par = audio_parity(gw.astype(np.float32), cw.astype(np.float32))
        stream_par = audio_parity(
            np.concatenate([c.samples.data for c in gc]),
            np.concatenate([c.samples.data for c in cc_]))
        stream_par["boundaries_identical"] = (
            [len(c.samples) for c in gc] == [len(c.samples) for c in cc_])
        flags = {c.samples.peak_normalize for c in gc}
        prosody.append({"normalization": norm or "per-chunk",
                        "file": file_par, "stream": stream_par,
                        "chunks": len(gc),
                        "peak_normalize": sorted(flags)})
        require(file_par["max_rel_diff"] <= PARITY_TOL
                and stream_par["max_rel_diff"] <= PARITY_TOL
                and stream_par["boundaries_identical"]
                and flags == {norm != "global"}, ("prosody", prosody[-1]))
    emit({"phase": "prosody", "card": gpu, "config": PROSODY,
          "dsp_arm": "cpp" if load_dsp_library() is not None else "numpy",
          "arm_calls": arms, **pr_counts.summary(),
          "tolerance_rel": PARITY_TOL, "runs": prosody})
    require(sum(arms.values()) > 0, "no prosody processing ran")

    # -- 11-14c. precision arms, warm-up, the server, the frontends, the mesh
    # and training ----------------------------------------------------------------
    ctx = Ctx(torch, gpu, counting, paths, n_wn, samples, shapes)
    phase_precision(ctx)
    phase_warmup(ctx)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = save_voice(torch, Path(tmp))
        phase_serve(ctx, cfg)
        phase_serve_plain(ctx, cfg)
        phase_frontends(ctx, cfg)
        phase_mesh(ctx, cfg)
    phase_train(ctx)

    # -- 15. kernels against their plain versions --------------------------------
    def mesh_shapes(kernel: str) -> dict:
        """The per-shard shapes each mesh path launched ``kernel`` at (all
        of them are among the checked shapes)."""
        return {name: sorted({str(list(s[0]) + (["g"] if s[1] else []))
                              if kernel == "gate" else str(list(s))
                              for s in (c.gate_shapes if kernel == "gate"
                                        else c.epi_shapes)})
                for name, c in paths.items() if name.startswith("mesh_")}

    tiny = torch.empty(1, device="cuda")
    floor_ms = cold_device_ms(torch, [tiny.zero_] * COLD_CALLS)
    emit({"phase": "floor", "card": gpu, "floor_device_ms": floor_ms,
          "profiler_ms": profiler_ms(torch, [tiny.zero_] * COLD_CALLS)})
    rows = []
    # gate: the main path's shapes (a conditioned one takes g as wn passes
    # it) and fixed check shapes: T % 4 == 1 and 2, x at a storage offset,
    # g dense and strided
    gate_cases = [(shape, "strided" if with_g else None, 0)
                  for shape, with_g in sorted(set(shapes["gate"]))]
    gate_cases += [((4, 512, 384), "dense", 0), ((4, 384, 384), "strided", 0),
                   ((2, 37, 48), "dense", 0), ((2, 37, 48), None, 0),
                   ((2, 38, 48), "strided", 0), ((2, 38, 48), None, 0),
                   ((2, 64, 48), None, 1), ((2, 38, 48), "dense", 3)]
    gate_err = 0.0

    def gate_plain(x, g):
        return gate.fused_gate_reference(x if g is None else x + g)

    for i, (shape, g_mode, offset) in enumerate(gate_cases):
        x, g, err = check_gate(torch, gate, shape, g_mode, seed=i,
                               offset=offset)
        gate_err = max(gate_err, err)
        emit({"phase": "gate_check", "shape": list(shape), "g": g_mode,
              "offset": offset, "max_abs_err": err,
              **timings(torch, gate_calls(torch, gate.fused_gate, shape,
                                          g_mode, 1000 * i, offset),
                        "gate_kernel", gate_bound(shape, g is not None)[0],
                        floor_ms, shape)})
    # time at the main path's most frequent shape
    shape, with_g = Counter(main_gate_shapes).most_common(1)[0][0]
    g_mode = "strided" if with_g else None
    kernels = gate_calls(torch, gate.fused_gate, shape, g_mode, seed=99)
    plains = gate_calls(torch, gate_plain, shape, g_mode, seed=99)
    bound_ms, bound_by = gate_bound(shape, with_g)
    kt = timings(torch, kernels, "gate_kernel", bound_ms, floor_ms)
    plain_dev = cold_device_ms(torch, plains)
    rows.append({"name": "fused_gate", "route": "cuda",
                 "source": "sonata_tpu_torch/csrc/gate.cu",
                 "replaces": "sonata_tpu/ops/gate.py:58",
                 "launches": launches["fused_gate"],
                 "launches_by_path": {name: c.launches["fused_gate"]
                                      for name, c in paths.items()},
                 "max_abs_err": gate_err, "ms": kt["device_ms"],
                 "plain_ms": plain_dev, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None, **kt,
                 "plain_call_ms": call_ms(torch, plains[0]),
                 "plain_profiler_ms": profiler_ms(torch, plains),
                 "timed_shape": list(shape),
                 "checked_shapes": len(gate_cases),
                 "mesh_shapes": mesh_shapes("gate")})

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
    for b, s in sorted(set(shapes["epilogue"])):
        epi_cases.append((b, s, [(3 * 256, s - 3 * 256)] * b, 0))
    epi_lsb, epi_diff, epi_peak = 0, 0, 0.0

    def epi_kernel(wav, lo, hi):
        return dop.fused_epilogue(wav, lo, hi, 42)

    def epi_plain(wav, lo, hi):
        return dop.fused_epilogue_reference(wav, lo, hi, 42)

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
              **timings(torch, epilogue_calls(torch, epi_kernel, b, s,
                                              bounds, 1000 * i, offset),
                        "epilogue_kernel", epilogue_bound(b, s)[0],
                        floor_ms, (b, s))})
    b, s = Counter(main_epi_shapes).most_common(1)[0][0]
    bounds = [(3 * 256, s - 3 * 256)] * b
    kernels = epilogue_calls(torch, epi_kernel, b, s, bounds, seed=98)
    plains = epilogue_calls(torch, epi_plain, b, s, bounds, seed=98)
    bound_ms, bound_by = epilogue_bound(b, s)
    kt = timings(torch, kernels, "epilogue_kernel", bound_ms, floor_ms)
    plain_dev = cold_device_ms(torch, plains)
    rows.append({"name": "fused_epilogue", "route": "cuda",
                 "source": "sonata_tpu_torch/csrc/epilogue.cu",
                 "replaces": "sonata_tpu/models/decode_opts.py:158",
                 "launches": launches["fused_epilogue"],
                 "launches_by_path": {name: c.launches["fused_epilogue"]
                                      for name, c in paths.items()},
                 "max_abs_err": epi_lsb, "ms": kt["device_ms"],
                 "plain_ms": plain_dev, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None, **kt,
                 "plain_call_ms": call_ms(torch, plains[0]),
                 "plain_profiler_ms": profiler_ms(torch, plains),
                 "timed_shape": [b, s],
                 "mesh_shapes": mesh_shapes("epilogue"),
                 "samples_differing": epi_diff,
                 "peak_rel_err": epi_peak})

    # -- 16. summary --------------------------------------------------------------
    emit({"kernels": rows})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
