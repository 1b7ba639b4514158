"""``mx.contrib`` of the port: ``quantization`` (``quantize_net`` and the
quantized Gluon layers)."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]
