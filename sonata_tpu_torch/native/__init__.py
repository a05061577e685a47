"""Host-side C++ for the port: the prosody DSP library (WSOLA) and the C
ABI (``include/libsonata_tpu.h``, over
:mod:`..frontends.capi_bridge`).

``src/sonata_dsp.cpp``, ``src/sonata_capi.cpp`` and the header are copies
of the JAX package's sources.  Each is
built with ``g++`` at first use into ``build/sonata_tpu_torch/`` at the
repository root, keyed by the source's hash (:mod:`.build`), and loaded
with ``ctypes``.  Without a compiler, :func:`load_dsp_library` returns
None and :mod:`..synth.output` takes its numpy arm.
"""

from .build import load_capi_library, load_dsp_library

__all__ = ["load_capi_library", "load_dsp_library"]
