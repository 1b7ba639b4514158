"""Operators of the port: the registry (``registry``), the op families
registered in it (``elemwise``, ``tensor``, ``nn``, ``random_ops``,
``contrib``, ``optimizer_ops``, ``image_ops``, ``quantization``) as plain
PyTorch functions, and the hand-written CUDA kernels with their wrappers
(``cuda``). Importing the package registers every op."""
from . import registry
from . import elemwise, tensor, nn, random_ops, contrib  # noqa: E402
from . import optimizer_ops  # noqa: E402
from . import image_ops  # noqa: E402
from . import quantization  # noqa: E402
from . import cuda
from .registry import apply_op, get_op, list_ops, register

__all__ = ["contrib", "cuda", "elemwise", "image_ops", "nn", "optimizer_ops",
           "quantization", "random_ops",
           "registry", "tensor",
           "apply_op", "get_op", "list_ops", "register"]
