"""The resource manager (the counterpart of ``mxnet_tpu/resource.py``,
MXNet's ``include/mxnet/resource.h`` ``ResourceRequest`` and
``ResourceManager``).

What the port maps each request to:
  - kTempSpace (scratch): PyTorch's caching allocator gives device
    scratch to every op; ``Resource.get_space`` hands back a host numpy
    scratch buffer for host-side work.
  - kRandom / kParallelRandom (random streams): ``torch.Generator``s the
    port owns, seeded from draws of ``random.generator(ctx)`` (the
    generator ``mt.random.seed`` seeds), so a seeded program gets the same
    streams run to run.
  - kCuDNNDropoutDesc: none (Dropout draws its masks from
    ``random.generator``).
"""
from __future__ import annotations

from typing import List

import torch

from .base import Context, MXNetError, current_context

__all__ = ["ResourceRequest", "Resource", "request"]


class ResourceRequest:
    """Request tags (``resource.h:43-51``)."""
    kRandom = "random"
    kTempSpace = "temp_space"
    kParallelRandom = "parallel_random"
    kCuDNNDropoutDesc = "cudnn_dropout_desc"

    def __init__(self, type_=kTempSpace):
        self.type = type_


class Resource:
    """A granted resource on ``ctx`` (default :func:`current_context`)."""

    def __init__(self, req: ResourceRequest, ctx: Context = None):
        self.req = req
        self.ctx = ctx if ctx is not None else current_context()

    def get_random(self) -> torch.Generator:
        """A new generator on the resource's device, seeded by a draw from
        ``random.generator(ctx)`` (kRandom): each call another stream."""
        from . import random as _random
        dev = self.ctx.torch_device()
        seed = torch.randint(0, 2 ** 62, (1,), device=dev,
                             generator=_random.generator(self.ctx)).item()
        return torch.Generator(device=dev).manual_seed(seed)

    def get_space(self, shape, dtype="float32"):
        """Host scratch buffer (kTempSpace) for host-side work."""
        import numpy as onp
        return onp.empty(shape, dtype)

    def get_parallel_random(self, n) -> List[torch.Generator]:
        """``n`` independent generators (kParallelRandom)."""
        return [self.get_random() for _ in range(int(n))]


def request(req, ctx: Context = None) -> Resource:
    """``ResourceManager::Request``: a :class:`Resource` for ``req`` (a
    :class:`ResourceRequest` or its type tag) on ``ctx``."""
    if not isinstance(req, ResourceRequest):
        req = ResourceRequest(req)
    if req.type == ResourceRequest.kCuDNNDropoutDesc:
        raise MXNetError("cudnn_dropout_desc has no counterpart in the port "
                         "(Dropout draws its masks from random.generator)")
    return Resource(req, ctx)
