"""Small utilities (the counterpart of ``mxnet_tpu/util.py``, less its
numpy-semantics switches, which come with the port's ``numpy`` modules,
ROADMAP Q1.13)."""
from __future__ import annotations

import os

import torch

from .base import Context

__all__ = ["get_gpu_count", "get_gpu_memory", "makedirs"]


def get_gpu_count() -> int:
    """The number of CUDA cards visible."""
    return torch.cuda.device_count()


def get_gpu_memory(dev_id=0):
    """(bytes allocated by PyTorch on card ``dev_id``, the card's total
    bytes); raises MXNetError where there is no such card."""
    dev = Context("gpu", dev_id).torch_device()
    return (torch.cuda.memory_allocated(dev),
            torch.cuda.get_device_properties(dev).total_memory)


def makedirs(d):
    os.makedirs(d, exist_ok=True)
