"""``mx.contrib`` of the port: ``quantization`` (``quantize_net`` and the
quantized Gluon layers), and the legacy ``autograd``, ``io``
(``DataLoaderIter``) and ``ndarray`` (``nd.contrib``) modules."""
from . import quantization  # noqa: F401
from . import autograd      # noqa: F401
from . import io            # noqa: F401
from . import ndarray       # noqa: F401

__all__ = ["quantization", "autograd", "io", "ndarray"]
