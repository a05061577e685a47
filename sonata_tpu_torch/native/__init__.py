"""Host-side C++ for the port: the prosody DSP library (WSOLA).

``src/sonata_dsp.cpp`` is a copy of the JAX package's source.  It is
built with ``g++`` at first use into ``build/sonata_tpu_torch/`` at the
repository root, keyed by the source's hash (:mod:`.build`), and loaded
with ``ctypes``.  Without a compiler, :func:`load_dsp_library` returns
None and :mod:`..synth.output` takes its numpy arm.
"""

from .build import load_dsp_library

__all__ = ["load_dsp_library"]
