"""The ``nd`` imperative frontend of the port: NDArray, its factories and the
functions the imperative and runtime-kernel paths use (the counterpart of
``mxnet_tpu/ndarray/__init__.py``), plus the ``.params`` reader ``utils``.

Arrays are made on ``ctx`` when given, else on :func:`current_context`,
which is ``gpu(0)`` unless the caller enters ``cpu()``.
"""
from __future__ import annotations

import torch

from ..base import DTypes, current_context
from . import utils
from .ndarray import NDArray, _apply, _wrap, array

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "zeros_like", "ones_like", "dot", "waitall", "sigmoid", "exp",
           "log", "tanh", "relu", "sqrt", "square", "abs", "clip", "where",
           "random", "utils"]


def _make(maker, ctx, dtype):
    ctx = ctx or current_context()
    return _wrap(maker(ctx.torch_device(), DTypes.torch(dtype)), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return _make(lambda dev, dt: torch.zeros(_shape(shape), dtype=dt,
                                             device=dev), ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return _make(lambda dev, dt: torch.ones(_shape(shape), dtype=dt,
                                            device=dev), ctx, dtype)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return _make(lambda dev, dt: torch.full(_shape(shape), val, device=dev)
                 .to(dt), ctx, dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Zeros, as the reference's ``empty``."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    if stop is None:
        start, stop = 0, start

    def mk(dev, dt):
        a = torch.arange(start, stop, step, dtype=torch.float64,
                         device=dev).to(dt)
        return a.repeat_interleave(repeat) if repeat > 1 else a
    return _make(mk, ctx, dtype)


def zeros_like(a: NDArray) -> NDArray:
    return _apply(torch.zeros_like, a)


def ones_like(a: NDArray) -> NDArray:
    return _apply(torch.ones_like, a)


def dot(lhs: NDArray, rhs: NDArray, transpose_a=False,
        transpose_b=False) -> NDArray:
    """The product over lhs's last and rhs's first axis (``dot-inl.h``)."""
    def f(a, b):
        if transpose_a and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_b and b.dim() >= 2:
            b = b.transpose(-1, -2)
        if a.dim() == 1 and b.dim() == 1:
            return torch.dot(a, b)
        return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))
    return _apply(f, lhs, rhs)


def waitall():
    """Wait for all work queued on every card (``MXNDArrayWaitAll``)."""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _unary(fn):
    def op(data: NDArray) -> NDArray:
        return _apply(fn, data)
    op.__name__ = fn.__name__
    return op


sigmoid = _unary(torch.sigmoid)
exp = _unary(torch.exp)
log = _unary(torch.log)
tanh = _unary(torch.tanh)
relu = _unary(torch.relu)
sqrt = _unary(torch.sqrt)
square = _unary(torch.square)
abs = _unary(torch.abs)   # noqa: A001  (the reference's name)


def clip(data: NDArray, a_min=None, a_max=None) -> NDArray:
    """Clamp to [a_min, a_max], the bounds cast to the array's dtype first
    (the reference keeps the operand dtype)."""
    dt = data._data.dtype

    def bound(v):
        return None if v is None else torch.tensor(v).to(dt).item()
    return _apply(lambda t: torch.clamp(t, bound(a_min), bound(a_max)), data)


def where(condition: NDArray, x: NDArray, y: NDArray) -> NDArray:
    return _apply(lambda c, a, b: torch.where(c.bool(), a, b),
                  condition, x, y)


from . import random  # noqa: E402  (nd.random namespace)
