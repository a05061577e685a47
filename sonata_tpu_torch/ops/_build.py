"""Build and load the port's CUDA kernels.

The kernel sources (``csrc/*.cu``) have a plain C interface.  At first use,
each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library that ``ctypes`` loads.  No PyTorch header is compiled, which keeps
the build to seconds.

The library lands in ``build/sonata_tpu_torch/<key>/`` at the repository
root, where ``key`` hashes the sources and the compiler flags, so an edited
source rebuilds and an unchanged one is reused.  A file lock serialises
concurrent first uses (several processes, or threads of one process).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from ..core import OperationError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sonata_tpu_torch"
SOURCES = ("gate.cu", "epilogue.cu")
LIB_NAME = "libsonata_tpu_torch_kernels.so"
# no --use_fast_math: the tolerances assume IEEE tanhf/expf/sinf/cosf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
#: how the library was obtained in this process: wall seconds of the build
#: (0.0 when an earlier build was reused) and the compiler's log
build_info: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise OperationError("nvcc not found: the CUDA kernels cannot be built")


def _build_key(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise OperationError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stdout}"
            f"{proc.stderr}")
    return proc.stdout + proc.stderr


def build(csrc: Path = CSRC) -> Path:
    """Return the path of the library built from ``csrc`` (the package's
    sources unless another tree's are given), building it if needed."""
    out_dir = BUILD_ROOT / _build_key(csrc)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():  # another process built it meanwhile
            build_info.setdefault("seconds", 0.0)
            return lib_path
        t0 = time.perf_counter()
        objs = [out_dir / (Path(s).stem + ".o") for s in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", str(csrc / so[0]),
                                 "-o", str(so[1])]),
                zip(SOURCES, objs)))
        tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
        logs.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *map(str, objs)]))
        os.replace(tmp, lib_path)
        log = "".join(logs)
        (out_dir / "build.log").write_text(log)
        build_info.update(seconds=time.perf_counter() - t0, log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            # gate: y, g, g row stride, out, B, T, H, device, stream
            lib.sonata_gate_f32.argtypes = [p, p, ctypes.c_int64, p, i, i, i,
                                            i, p]
            lib.sonata_gate_f32.restype = i
            # epilogue: wav, lo, hi, q, peak, B, S, fade, cluster size,
            # vectors a block, device, stream
            lib.sonata_epilogue_f32.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                i, p]
            lib.sonata_epilogue_f32.restype = i
            lib.sonata_cuda_error_string.argtypes = [i]
            lib.sonata_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().sonata_cuda_error_string(rc).decode()
        raise OperationError(f"{kernel} launch failed: CUDA error {rc} "
                             f"({msg})")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device: kernels launch there, in order with torch's own work."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
