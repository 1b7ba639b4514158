"""``mxnet.context`` (the counterpart of ``mxnet_tpu/context.py``): the
device model of ``base``, and the number of CUDA cards."""
import torch

from .base import Context, cpu, current_context, gpu

__all__ = ["Context", "cpu", "gpu", "num_gpus", "current_context"]


def num_gpus() -> int:
    """The number of CUDA cards visible."""
    return torch.cuda.device_count()
