"""Hand-written CUDA kernels and their wrappers."""

from .gate import fused_gate, fused_gate_reference

__all__ = ["fused_gate", "fused_gate_reference"]
