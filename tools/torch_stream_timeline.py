#!/usr/bin/env python3
"""Where a single GPU stream's host time goes, and what a new shape costs.

Run from the repository root on a host with one NVIDIA GPU:

    python3 tools/torch_stream_timeline.py

Builds the medium voice of ``chip_smoke.py`` (random weights, seed 0, its
zero-initialised layers filled), warms it as ``chip_smoke.py``'s main phase
does, then streams ``chip_smoke.STREAM_TEXT`` six times through
``SpeechSynthesizer.synthesize_streamed`` and prints one JSON line per run:
its first-chunk time and wall time, and for each stage group and each
batched window decode the engine ran, its rows and frames and the host time
of its enqueue (``_encode_and_acoustics`` includes the frame-count copy;
``_assemble_window_dispatch`` returns before the decode ends).  A window
shape the engine's thread meets for the first time shows as a long enqueue.

Last, one JSON line of a batched window decode's wall time (synchronised)
at 3 rows: its first call on the main thread, repeats, its first call on a
new thread, and a first call at 5 rows — the cost of a new shape on a
thread, and of a new thread.

Prints the card's name and power limit first.  Without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from sonata_tpu_torch.models import PiperVoice, piper
    from sonata_tpu_torch.synth import SpeechSynthesizer

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    events = []
    assemble = piper._assemble_window_dispatch
    stages = piper.PiperVoice._encode_and_acoustics

    def timed_assemble(v, key, payloads, b):
        t0 = time.perf_counter()
        out = assemble(v, key, payloads, b)
        events.append({"decode_rows": b, "width": key[0],
                       "enqueue_ms": (time.perf_counter() - t0) * 1e3})
        return out

    def timed_stages(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = stages(self, *args, **kwargs)
        events.append({"stage_rows": out[0].shape[0], "frames": out[3],
                       "host_ms": (time.perf_counter() - t0) * 1e3})
        return out

    piper._assemble_window_dispatch = timed_assemble
    piper.PiperVoice._encode_and_acoustics = timed_stages
    voice = PiperVoice.random(seed=0)
    smoke.fill_zero_init(torch, voice.model, seed=1)
    synth = SpeechSynthesizer(voice)
    list(synth.synthesize_parallel("Warm up."))
    list(synth.synthesize_streamed("Warm up the stream too.", chunk_size=45,
                                   chunk_padding=3))
    for run in range(6):
        events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = None
        for _chunk in synth.synthesize_streamed(smoke.STREAM_TEXT,
                                                chunk_size=45,
                                                chunk_padding=3):
            if first is None:
                first = time.perf_counter() - t0
        wall = time.perf_counter() - t0
        print(json.dumps({"run": run, "first_chunk_ms": first * 1e3,
                          "wall_ms": wall * 1e3,
                          "batch_mode": voice.dispatch_stats()["batch_mode"],
                          "events": list(events)}), flush=True)

    z = torch.randn(8, 64, voice.hp.inter_channels, device="cuda") * 0.1

    def decode_ms(rows: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voice._decode_windows(z[:rows], None, None, None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    costs = {"main_first_3": decode_ms(3), "main_repeat_3": decode_ms(3),
             "main_repeat2_3": decode_ms(3)}

    def on_new_thread():
        costs["thread_first_3"] = decode_ms(3)
        costs["thread_repeat_3"] = decode_ms(3)

    thread = threading.Thread(target=on_new_thread)
    thread.start()
    thread.join()
    costs.update(main_first_5=decode_ms(5), main_repeat_5=decode_ms(5))
    print(json.dumps({"decode_width": 64, **costs}), flush=True)
    voice.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
