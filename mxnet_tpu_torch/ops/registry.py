"""Operator registry and imperative dispatch of the port (the counterpart of
``mxnet_tpu/ops/registry.py``).

Each op is a plain function over torch tensors: arrays are its positional
parameters, attributes its keyword-only ones, as in the JAX package, and
the generated ``nd`` function of an op passes its arguments the same
way. ``invoke`` unwraps
NDArrays, runs the function on the context of the first array input (else
on :func:`current_context`) through AMP's cast-policy point
(:func:`mxnet_tpu_torch.amp.apply`: a no-op unless AMP is on), and wraps
the results on that context; every ``NDArray`` operation goes through it. PyTorch's autograd
builds the graph, and only while ``autograd.is_recording()``; an op marked
``differentiable=False`` runs without one, so its outputs carry no
gradient. Predicate results (comparisons, ``isnan``, ...) are tagged so
that indexing with them masks.

The JAX package's per-(op, attributes) ``jax.jit`` cache and its
``mxtpu_jit_cache_*`` families have no counterpart here: an op runs its
PyTorch calls eagerly and nothing is compiled, so there is nothing to cache.
While a profiler session runs, every dispatch is one profiler event
(``profiler._dispatch_profiled``), the ProfileOperator-per-engine-op analog.

Samplers (``random=True``) take ``generator`` and ``device`` keywords,
which ``invoke`` fills with ``random.generator(ctx)`` and the context's
device: they never draw from PyTorch's global generator.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from .. import amp as _amp
from ..base import MXNetError

__all__ = ["Op", "register", "get_op", "list_ops", "invoke", "apply_op",
           "make_nd_wrapper"]

_OPS: Dict[str, "Op"] = {}

# the port's profiler module, looked up by name so dispatch never imports it
_PROFILER_MODULE = __name__.rpartition(".ops")[0] + ".profiler"


def _profiler_running() -> bool:
    """Cheap check for an active profiler session (the profiler module
    never loads on the dispatch path unless the user started it)."""
    prof = sys.modules.get(_PROFILER_MODULE)
    return prof is not None and prof._STATE["running"]


class Op:
    """A registered operator: ``fn(*tensors, **attrs)`` returning a tensor
    or a tuple of tensors."""

    __slots__ = ("name", "fn", "differentiable", "random")

    def __init__(self, name: str, fn: Callable, differentiable: bool = True,
                 random: bool = False):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.random = random

    def __repr__(self):
        return f"<Op {self.name}>"


def register(name: Optional[str] = None, differentiable: bool = True,
             random: bool = False):
    """Register an operator implementation (``NNVM_REGISTER_OP``)."""
    def deco(fn):
        opname = name or fn.__name__
        if opname in _OPS:
            raise MXNetError(f"op {opname!r} already registered")
        _OPS[opname] = Op(opname, fn, differentiable=differentiable,
                          random=random)
        return fn
    return deco


def get_op(name: str) -> Op:
    if name not in _OPS:
        raise MXNetError(f"unknown op {name!r}")
    return _OPS[name]


def list_ops():
    return sorted(_OPS)


# ops whose output is a logical predicate (0/1-valued), taggable as a mask
_PREDICATE_OPS = frozenset([
    "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
    "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_logical_and", "broadcast_logical_or", "broadcast_logical_xor",
    "logical_not", "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
    "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
    "isnan", "isinf", "isfinite",
])


def invoke(op: Op, inputs: Sequence, attrs: Dict[str, Any]):
    """``Imperative::Invoke``: NDArrays (or None, scalars, tensors) in,
    an NDArray or a tuple of NDArrays out."""
    from .. import autograd
    from .. import random as _random
    from ..base import current_context
    from ..ndarray.ndarray import NDArray, _wrap

    ctx = next((x._ctx for x in (*inputs, *attrs.values())
                if isinstance(x, NDArray)), None)
    if ctx is None:
        ctx = current_context()
    tensors = [x._data if isinstance(x, NDArray) else x for x in inputs]
    # an array input may come by keyword (``softmax(x, length=l)``)
    attrs = {k: v._data if isinstance(v, NDArray) else v
             for k, v in attrs.items()}
    if op.random:
        attrs = dict(attrs, generator=_random.generator(ctx),
                     device=ctx.torch_device())
    with torch.set_grad_enabled(op.differentiable
                                and autograd.is_recording()):
        if _profiler_running():
            from .. import profiler
            out = profiler._dispatch_profiled(
                op.name, lambda: _amp.apply(op.name, op.fn, tensors, attrs))
        else:
            out = _amp.apply(op.name, op.fn, tensors, attrs)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(t, ctx) for t in out)
    out = _wrap(out, ctx)
    if op.name in _PREDICATE_OPS:
        out._is_predicate = True
    return out


def apply_op(name: str, *inputs, **attrs):
    """Call a registered op by name on NDArrays."""
    return invoke(get_op(name), inputs, attrs)


def make_nd_wrapper(op: Op) -> Callable:
    """The generated ``nd`` function of an op: arrays positionally,
    attributes by keyword."""
    def wrapper(*args, **kwargs):
        return invoke(op, args, kwargs)
    wrapper.__name__ = op.name
    wrapper.__qualname__ = op.name
    wrapper.__doc__ = op.fn.__doc__
    return wrapper
