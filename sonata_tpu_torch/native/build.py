"""Build and load the host C++ libraries: the prosody DSP library and the
C ABI.

Each source is compiled by ``g++ -O2 -shared -fPIC`` at first use into
``build/sonata_tpu_torch/<name>-<key>/``, where ``key`` hashes the source,
the headers it includes and the flags (an edited source rebuilds, an
unchanged one is reused), never next to the source.  A file lock
serialises concurrent first uses.  This is host code, so the JAX
package's rule holds: a failed build or load logs a warning and returns
None (the prosody caller then takes the numpy arm).

The C ABI (``src/sonata_capi.cpp``, declared in
``include/libsonata_tpu.h``) is compiled against the running
interpreter's headers and not linked to ``libpython``: loaded with
``ctypes`` into a Python process, it takes the CPython symbols of that
process and joins its interpreter.
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

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "src" / "sonata_dsp.cpp"
LIB_NAME = "libsonata_dsp.so"
CAPI_SRC = _DIR / "src" / "sonata_capi.cpp"
CAPI_HEADER = _DIR / "include" / "libsonata_tpu.h"
CAPI_LIB_NAME = "libsonata_capi.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
#: None until the first load; then the handle, or False after a failure
_lib = None
_capi = None


def build(src: Path = SRC, *, lib_name: str = LIB_NAME, prefix: str = "dsp",
          flags: tuple = (), deps: tuple = ()) -> Path:
    """Return the path of the library built from ``src`` (with the extra
    ``flags``; ``deps`` are the headers it includes), building it if
    needed; raises ``OSError`` or ``subprocess.CalledProcessError`` when
    the compiler is missing or fails."""
    h = hashlib.sha256(repr(CXX_FLAGS + tuple(flags)).encode())
    for path in (src, *deps):
        h.update(path.read_bytes())
    out_dir = BUILD_ROOT / f"{prefix}-{h.hexdigest()[:16]}"
    lib_path = out_dir / lib_name
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            tmp = out_dir / f"{lib_name}.tmp{os.getpid()}"
            subprocess.run(["g++", *CXX_FLAGS, *flags, "-o", str(tmp),
                            str(src)],
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


def load_capi_library() -> Optional[ctypes.CDLL]:
    """The C ABI (``libsonata_tpu.h``'s functions over
    :mod:`sonata_tpu_torch.frontends.capi_bridge`), built against this
    interpreter's headers, or None when it cannot be built or loaded."""
    global _capi
    with _lock:
        if _capi is None:
            import sysconfig

            try:
                path = build(CAPI_SRC, lib_name=CAPI_LIB_NAME, prefix="capi",
                             flags=(f"-I{sysconfig.get_path('include')}",),
                             deps=(CAPI_HEADER,))
                _capi = ctypes.CDLL(str(path))
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", "") or e
                log.warning("C ABI library unavailable (%s)",
                            str(detail)[-2000:])
                _capi = False
        return _capi or None
