"""Text front-end: segmentation and G2P phonemization (English rules)."""

from .phonemizer import (
    EspeakBackend,
    G2PBackend,
    RuleG2PBackend,
    get_default_backend,
    text_to_phonemes,
)
from .segmentation import Clause, split_clauses, split_sentences

__all__ = [
    "EspeakBackend",
    "G2PBackend",
    "RuleG2PBackend",
    "get_default_backend",
    "text_to_phonemes",
    "Clause",
    "split_clauses",
    "split_sentences",
]
