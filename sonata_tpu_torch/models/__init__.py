"""Model implementations: Piper VITS voices on PyTorch."""

from pathlib import Path
from typing import Union

from .config import (
    ModelConfig,
    SynthesisConfig,
    VitsHyperParams,
    default_phoneme_id_map,
)
from .piper import PiperVoice, resolve_device


def from_config_path(config_path: Union[str, Path], **kwargs) -> PiperVoice:
    """Load a voice from a Piper JSON config (reference factory:
    ``crates/sonata/models/piper/src/lib.rs:88-110``)."""
    return PiperVoice.from_config_path(config_path, **kwargs)


__all__ = [
    "ModelConfig",
    "SynthesisConfig",
    "VitsHyperParams",
    "default_phoneme_id_map",
    "PiperVoice",
    "from_config_path",
    "resolve_device",
]
