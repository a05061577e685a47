#!/usr/bin/env python3
"""Time both hand kernels and their plain versions two ways, in a fresh
process on one GPU: CUDA events around calls queued behind a sleeping
kernel (``chip_smoke.cold_device_ms``) and the profiler's kernel events
(``chip_smoke.profiler_ms``), each over 20 input sets after an L2 flush.

    python3 tools/torch_kernel_timing.py

Prints one JSON line per kernel and shape, then the card's name and power
limit.  ``chip_smoke.py`` reads the same two clocks late in a long
process; this gives them where nothing else ran before.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sonata_tpu_torch.models import decode_opts as dop  # noqa: E402
from sonata_tpu_torch.ops import gate  # noqa: E402

GATE_SHAPES = [(4, 384, 384), (16, 3072, 384)]
EPILOGUE_SHAPES = [(1, 32768), (8, 393216)]


def row(name, shape, kernels, plains, bound_ms, kernel_name):
    dev = cs.cold_device_ms(torch, kernels)
    return {"kernel": name, "shape": list(shape), "device_ms": dev,
            "profiler_ms": cs.profiler_ms(torch, kernels, name=kernel_name),
            "plain_ms": cs.cold_device_ms(torch, plains),
            "plain_profiler_ms": cs.profiler_ms(torch, plains),
            "bound_ms": bound_ms, "bound_share": bound_ms / dev}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    tiny = torch.empty(1, device="cuda")
    floor = [tiny.zero_] * cs.COLD_CALLS
    print(json.dumps({"floor_device_ms": cs.cold_device_ms(torch, floor),
                      "floor_profiler_ms": cs.profiler_ms(torch, floor)}))
    for shape in GATE_SHAPES:
        print(json.dumps(row(
            "fused_gate", shape,
            cs.gate_calls(torch, gate.fused_gate, shape, None, 1),
            cs.gate_calls(torch, lambda x, g: gate.fused_gate_reference(x),
                          shape, None, 1),
            cs.gate_bound(shape, False)[0], "gate_kernel")))
    for b, s in EPILOGUE_SHAPES:
        bounds = [(768, s - 768)] * b
        print(json.dumps(row(
            "fused_epilogue", (b, s),
            cs.epilogue_calls(torch, lambda w, lo, hi: dop.fused_epilogue(
                w, lo, hi, 42), b, s, bounds, 1),
            cs.epilogue_calls(
                torch, lambda w, lo, hi: dop.fused_epilogue_reference(
                    w, lo, hi, 42), b, s, bounds, 1),
            cs.epilogue_bound(b, s)[0], "epilogue_kernel")))
    print(cs.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
