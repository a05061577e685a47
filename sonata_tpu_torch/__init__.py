"""sonata-tpu's PyTorch/CUDA port: Piper VITS voices on an NVIDIA GPU.

A package of its own beside the JAX package ``sonata_tpu``, which stays the
reference it is tested against.  It imports torch and numpy, never jax and
nothing of ``sonata_tpu``: the jax-free modules it needs (core, audio,
text, config, chunker, buckets) are its own copies.  Plain tensor code is
PyTorch; the two kernels the JAX package wrote in Pallas for the TPU (the
WaveNet gate and the streaming decode epilogue) are CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .core import (
    AudioInfo,
    BaseModel,
    FailedToLoadResource,
    Model,
    OperationError,
    Phonemes,
    PhonemizationError,
    SonataError,
)
from .audio import Audio, AudioSamples

__all__ = [
    "__version__",
    "AudioInfo",
    "BaseModel",
    "FailedToLoadResource",
    "Model",
    "OperationError",
    "Phonemes",
    "PhonemizationError",
    "SonataError",
    "Audio",
    "AudioSamples",
]
