"""Build and load the prosody DSP library.

``src/sonata_dsp.cpp`` is compiled by ``g++ -O2 -shared -fPIC`` at first
use into ``build/sonata_tpu_torch/dsp-<key>/``, where ``key`` hashes the
source and the flags (an edited source rebuilds, an unchanged one is
reused), never next to the source.  A file lock serialises concurrent first
uses.  This is host code, so the JAX package's rule holds: a failed build
or load logs a warning and returns None, and the caller takes the numpy
arm.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_ROOT

log = logging.getLogger("sonata.native")

SRC = Path(__file__).resolve().parent / "src" / "sonata_dsp.cpp"
LIB_NAME = "libsonata_dsp.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
#: None until the first load; then the handle, or False after a failure
_lib = None


def build(src: Path = SRC) -> Path:
    """Return the path of the library built from ``src``, building it if
    needed; raises ``OSError`` or ``subprocess.CalledProcessError`` when
    the compiler is missing or fails."""
    h = hashlib.sha256(repr(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"dsp-{h.hexdigest()[:16]}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True, check=True,
                           timeout=120)
            os.replace(tmp, lib_path)
    return lib_path


def load_dsp_library() -> Optional[ctypes.CDLL]:
    """The prosody DSP library (rate/pitch/volume), or None when it cannot
    be built or loaded here."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", "") or e
                log.warning("prosody DSP library unavailable (%s); using "
                            "the numpy arm", str(detail)[-2000:])
                _lib = False
                return None
            lib.sonata_dsp_output_len.restype = ctypes.c_int64
            lib.sonata_dsp_output_len.argtypes = [
                ctypes.c_int64, ctypes.c_float, ctypes.c_float]
            lib.sonata_dsp_process.restype = ctypes.c_int64
            lib.sonata_dsp_process.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            lib.sonata_dsp_version.restype = ctypes.c_char_p
            _lib = lib
        return _lib or None
