#!/usr/bin/env python3
"""Old against new for the PyTorch port's two CUDA kernels, on one card.

    python3 tools/torch_kernel_ab.py --baseline DIR [--out FILE]

``DIR`` holds another tree's ``gate.cu`` and ``epilogue.cu`` with the C
interface the port's kernels had before ``g``'s row stride and the
epilogue's cluster plan were added:

    sonata_gate_f32(y, g, out, B, T, H, device, stream)
    sonata_epilogue_f32(wav, lo, hi, q, peak, B, S, fade, device, stream)

(``g`` there is a contiguous ``[B, 2H]``.)  The baseline is built with the
package's own ``nvcc`` flags, beside the package's build.  At each of the
main path's shapes (and the epilogue's longer check rows) the script checks
that both libraries agree within the kernels' tolerances, then takes the kernel's device
time per call (``torch.profiler``, 20 launches a reading) in the order
baseline, current, current, baseline, and the wall time per call of the
current wrapper over 200 back-to-back calls.  The device time of a
one-element ``zero_()`` in the same process is the launch floor.  Last it
counts, per kernel, the global memory and integer-division instructions in
each library's SASS (``cuobjdump -sass``).  One JSON line per reading; all
of them, with the card's name and power limit, go to ``--out``.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FADE = 42
# global loads/stores by width, and what a division leaves in SASS: the
# reciprocal seed of the integer-division sequence, or a call into a
# division subroutine
SASS_OPS = re.compile(r"\b(LDG\.E(?:\.\w+)*|STG\.E(?:\.\w+)*|"
                      r"I2F\.U64\.RP|I2F\.U32\.RP|I2F\.RP|CALL\.\w+(?:\.\w+)*)")


def sass_summary(lib: Path, nvcc: str) -> dict:
    """Counts of SASS_OPS in each kernel of ``lib``."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = Counter()
        elif name is not None:
            out[name].update(SASS_OPS.findall(line))
    return {k: dict(sorted(v.items())) for k, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "kernel_ab.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from sonata_tpu_torch.models import decode_opts as dop
    from sonata_tpu_torch.ops import _build, gate

    gpu = cs.card()
    lines = []

    def emit(obj):
        lines.append(obj)
        cs.emit(obj)

    new_lib = _build.build()
    _build.library()
    old_lib = _build.build(args.baseline.resolve())
    old = ctypes.CDLL(str(old_lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    old.sonata_gate_f32.argtypes = [p, p, p, i, i, i, i, p]
    old.sonata_gate_f32.restype = i
    old.sonata_epilogue_f32.argtypes = [p, p, p, p, p, i, i, i, i, p]
    old.sonata_epilogue_f32.restype = i

    def old_gate(x, g2d):
        b, t, two_h = x.shape
        out = torch.empty((b, two_h // 2, t), device=x.device).transpose(1, 2)
        rc = old.sonata_gate_f32(
            x.data_ptr(), None if g2d is None else g2d.data_ptr(),
            out.data_ptr(), b, t, two_h // 2, x.device.index,
            _build.stream_of(x))
        cs.require(rc == 0, ("baseline gate launch", rc))
        return out

    def old_epilogue(wav, lo, hi):
        b, s = wav.shape
        q = torch.empty((b, s), dtype=torch.int16, device=wav.device)
        peak = torch.empty((b,), device=wav.device)
        rc = old.sonata_epilogue_f32(
            wav.data_ptr(), lo.data_ptr(), hi.data_ptr(), q.data_ptr(),
            peak.data_ptr(), b, s, FADE, wav.device.index,
            _build.stream_of(wav))
        cs.require(rc == 0, ("baseline epilogue launch", rc))
        return q, peak

    tiny = torch.empty(1, device="cuda")
    floor_ms = cs.device_ms(torch, tiny.zero_)
    emit({"phase": "floor", "card": gpu, "floor_device_ms": floor_ms})

    def turns(name, old_fn, new_fn, bound_ms):
        """Device ms per call, baseline/current/current/baseline."""
        readings = [cs.device_ms(torch, fn, name=name)
                    for fn in (old_fn, new_fn, new_fn, old_fn)]
        cs.require(None not in readings, (name, readings))
        old_ms = statistics.mean(readings[0::3])
        new_ms = statistics.mean(readings[1:3])
        return {"baseline_device_ms": old_ms, "device_ms": new_ms,
                "readings": readings, "ratio": new_ms / old_ms,
                "host_us": cs.host_us(torch, new_fn),
                "floor_device_ms": floor_ms, "bound_ms": bound_ms,
                "bound_share": bound_ms / new_ms,
                "baseline_bound_share": bound_ms / old_ms}

    # gate: the file's and the stream's shapes, and the file's with g as a
    # multi-speaker voice's wn passes it
    for shape, g_mode in [((4, 384, 384), None), ((1, 512, 384), None),
                          ((4, 384, 384), "strided")]:
        x, g = cs.gate_inputs(torch, shape, g_mode, seed=7)
        g2d = None if g is None else g.reshape(shape[0], shape[2])
        g2d = None if g2d is None else g2d.contiguous()
        new_out = gate.fused_gate(x, g)
        diff = float((new_out - old_gate(x, g2d)).abs().max())
        cs.require(diff <= 2e-6, ("gate old vs new", shape, diff))
        emit({"phase": "gate_ab", "card": gpu, "shape": list(shape),
              "g": g_mode, "max_abs_diff_old_new": diff,
              **turns("gate_kernel", lambda: old_gate(x, g2d),
                      lambda: gate.fused_gate(x, g),
                      cs.gate_bound(shape, g is not None)[0])})

    # epilogue: the stream's window rows and the longer check rows
    for b, s in [(1, 16384), (1, 32768), (1, 65536), (4, 65536)]:
        wav, lo, hi = cs.epilogue_inputs(
            torch, b, s, [(3 * 256, s - 3 * 256)] * b, seed=s)
        q_new, p_new = dop.fused_epilogue(wav, lo, hi, FADE)
        q_old, p_old = old_epilogue(wav, lo, hi)
        differing = int((q_new != q_old).sum())
        peak_diff = float((p_new - p_old).abs().max())
        cs.require(differing <= 0.001 * q_new.numel()
                   and peak_diff <= 1e-6 * float(p_old.abs().max()),
                   ("epilogue old vs new", b, s, differing, peak_diff))
        emit({"phase": "epilogue_ab", "card": gpu, "shape": [b, s],
              "cluster": dop.epilogue_plan(b, s)[0],
              "samples_differing_old_new": differing,
              "peak_abs_diff_old_new": peak_diff,
              **turns("epilogue_kernel", lambda: old_epilogue(wav, lo, hi),
                      lambda: dop.fused_epilogue(wav, lo, hi, FADE),
                      cs.epilogue_bound(b, s)[0])})

    nvcc = _build.find_nvcc()
    emit({"phase": "sass", "current": sass_summary(new_lib, nvcc),
          "baseline": sass_summary(old_lib, nvcc)})
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": gpu, "lines": lines}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
