"""Operators of the port: plain PyTorch functions (``nn``) and the
hand-written CUDA kernels with their wrappers (``cuda``)."""
from . import cuda, nn

__all__ = ["cuda", "nn"]
