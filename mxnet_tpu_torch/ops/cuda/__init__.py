"""Hand-written Hopper kernels and their wrappers. Each wrapper checks its
inputs, launches its kernel on a CUDA tensor (or raises), takes its plain
PyTorch version on a CPU tensor, and counts its launches in a module-level
counter (``launches``, ``launches_dq``, ``launches_dkv``)."""
from . import flash_attention, fused_conv1x1

__all__ = ["flash_attention", "fused_conv1x1"]
