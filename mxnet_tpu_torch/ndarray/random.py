"""``nd.random``: samplers drawing from the context's own generator (the
counterpart of ``mxnet_tpu/ndarray/random.py``). Floating samples are drawn
and scaled in float32, then cast to ``dtype``."""
from __future__ import annotations

import torch

from .. import random as _rng
from ..base import DTypes, current_context
from .ndarray import NDArray, _wrap

__all__ = ["uniform", "normal", "randn", "randint", "seed"]

seed = _rng.seed


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _finish(t, ctx, out):
    if out is not None:
        out._set_data(t)
        return out
    return _wrap(t, ctx)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kwargs) -> NDArray:
    ctx = ctx or current_context()
    t = torch.rand(_shape(shape), generator=_rng.generator(ctx),
                   device=ctx.torch_device())
    t = (t * (float(high) - float(low)) + float(low)).to(DTypes.torch(dtype))
    return _finish(t, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kwargs) -> NDArray:
    ctx = ctx or current_context()
    t = torch.randn(_shape(shape), generator=_rng.generator(ctx),
                    device=ctx.torch_device())
    t = (t * float(scale) + float(loc)).to(DTypes.torch(dtype))
    return _finish(t, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None,
          **kwargs) -> NDArray:
    return normal(loc=loc, scale=scale, shape=shape, dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kwargs) -> NDArray:
    """Integers in [low, high); shape defaults to (1,), as the reference."""
    ctx = ctx or current_context()
    t = torch.randint(int(low), int(high), _shape(shape) or (1,),
                      generator=_rng.generator(ctx),
                      device=ctx.torch_device(), dtype=DTypes.torch(dtype))
    return _finish(t, ctx, out)
