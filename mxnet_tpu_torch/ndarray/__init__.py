"""The ``nd`` imperative frontend of the port (the counterpart of
``mxnet_tpu/ndarray/__init__.py``): NDArray, its factories, and one
function per registered op, generated from the registry
(``ops/registry.py``: arrays positionally, attributes by keyword) as the
JAX package generates its own, beside the same hand-written wrappers
(variadic ops, the BatchNorms' moving-stat write-back, Dropout's training
flag, the sequence ops' optional lengths, RNN's optional cell state) and
CamelCase legacy aliases. ``random`` holds the samplers, ``contrib`` the
control flow and the contrib ops without their ``_contrib_`` prefix,
``image`` the image ops, ``utils`` ``save``/``load`` of the ``.params``
format.

Arrays are made on ``ctx`` when given, else on :func:`current_context`,
which is ``gpu(0)`` unless the caller enters ``cpu()``.
"""
from __future__ import annotations

import sys as _sys

import numpy as _np
import torch

from ..base import DTypes, current_context
from ..ops import registry as _registry
from ..ops.registry import apply_op as _apply_op
from . import utils
from .ndarray import NDArray, _wrap, array
from .utils import load, save

_this = _sys.modules[__name__]


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
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


def _from_host(a, ctx, dtype):
    return _make(lambda dev, dt: torch.from_numpy(a).to(device=dev,
                                                        dtype=dt), ctx, dtype)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype="float32") -> NDArray:
    return _from_host(_np.linspace(start, stop, num, endpoint=endpoint),
                      ctx, dtype)


def eye(N, M=0, k=0, ctx=None, dtype="float32") -> NDArray:
    return _from_host(_np.eye(N, M if M else None, k), ctx, dtype)


def zeros_like(a) -> NDArray:
    return _apply_op("zeros_like", a)


def ones_like(a) -> NDArray:
    return _apply_op("ones_like", a)


def full_like(a, fill_value) -> NDArray:
    return zeros_like(a) + fill_value


def waitall():
    """Wait for all work queued on every card (``MXNDArrayWaitAll``)."""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# hand-written wrappers (state write-back, training flags, variadic calls,
# optional array inputs)
# ---------------------------------------------------------------------------
def _bn_writeback(op_name, data, gamma, beta, moving_mean, moving_var,
                  use_global_stats, **attrs):
    """BatchNorm's training-mode detection and the moving-stat write-back
    into ``moving_mean`` and ``moving_var`` (in-op mutation in the
    reference)."""
    from .. import autograd
    training = autograd.is_training() and not use_global_stats
    out, new_mean, new_var = _apply_op(
        op_name, data, gamma, beta, moving_mean, moving_var,
        use_global_stats=use_global_stats, training=training, **attrs)
    if training:
        moving_mean._set_data(new_mean._data.detach())
        moving_var._set_data(new_var._data.detach())
    return out


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, **kwargs):
    return _bn_writeback("BatchNorm", data, gamma, beta, moving_mean,
                         moving_var, use_global_stats, eps=eps,
                         momentum=momentum, fix_gamma=fix_gamma, axis=axis)


def BatchNorm_v1(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                 momentum=0.9, fix_gamma=True, use_global_stats=False,
                 output_mean_var=False, axis=1, **kwargs):
    return _bn_writeback("BatchNorm_v1", data, gamma, beta, moving_mean,
                         moving_var, use_global_stats, eps=eps,
                         momentum=momentum, fix_gamma=fix_gamma, axis=axis)


def BatchNormWithReLU(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
                      momentum=0.9, fix_gamma=True, use_global_stats=False,
                      axis=1, **kwargs):
    return _bn_writeback("BatchNormWithReLU", data, gamma, beta, moving_mean,
                         moving_var, use_global_stats, eps=eps,
                         momentum=momentum, fix_gamma=fix_gamma, axis=axis)


def Dropout(data, p=0.5, mode="training", axes=(), **kwargs):
    """Dropout while ``autograd.is_training()`` (or ``mode="always"``),
    drawing from the data's context's generator; else the identity."""
    from .. import autograd
    training = autograd.is_training() or mode == "always"
    if not training or p <= 0:
        return _apply_op("Dropout", data, p=p, training=False)
    return _apply_op("Dropout", data, p=p, axes=tuple(axes), training=True)


def _arrays(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return tuple(args[0])
    return args


def concat(*args, dim=1, **kwargs):
    return _apply_op("concat", *_arrays(args), dim=dim)


def stack(*args, axis=0, **kwargs):
    return _apply_op("stack", *_arrays(args), axis=axis)


def add_n(*args):
    return _apply_op("add_n", *_arrays(args))


ElementWiseSum = add_n


def split(data, num_outputs, axis=1, squeeze_axis=False):
    out = _apply_op("split", data, num_outputs=num_outputs, axis=axis,
                    squeeze_axis=squeeze_axis)
    return list(out) if isinstance(out, tuple) else out


def _with_length(data, sequence_length):
    return (data,) if sequence_length is None else (data, sequence_length)


def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    return _apply_op("sequence_mask", *_with_length(data, sequence_length),
                     use_sequence_length=use_sequence_length, value=value,
                     axis=axis)


def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    return _apply_op("sequence_last", *_with_length(data, sequence_length),
                     use_sequence_length=use_sequence_length, axis=axis)


def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    return _apply_op("sequence_reverse",
                     *_with_length(data, sequence_length),
                     use_sequence_length=use_sequence_length, axis=axis)


def RNN(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        bidirectional=False, mode="lstm", p=0.0, state_outputs=True,
        **kwargs):
    args = (data, parameters, state) if state_cell is None \
        else (data, parameters, state, state_cell)
    return _apply_op("RNN", *args, state_size=state_size,
                     num_layers=num_layers, bidirectional=bidirectional,
                     mode=mode, p=p, state_outputs=state_outputs)


def cast(data, dtype):
    return _apply_op("cast", data, dtype=DTypes.canonical(dtype))


def Cast(data, dtype):
    return cast(data, dtype)


def where(condition, x, y):
    return _apply_op("where", condition, x, y)


def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kwargs):
    """The product over lhs's last and rhs's first axis (``dot-inl.h``);
    a CSR or row-sparse operand takes ``sparse.dot``."""
    if lhs.stype != "default" or rhs.stype != "default":
        return sparse.dot(lhs, rhs, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    return _apply_op("dot", lhs, rhs, transpose_a=transpose_a,
                     transpose_b=transpose_b)


def multi_sum_sq(*arrays, num_arrays=0):
    """The sum of squares of each array (the AMP and LAMB helper)."""
    return tuple(_apply_op("sum", _apply_op("square", a))
                 for a in _arrays(arrays))


def all_finite(*arrays, init_output=True):
    """True if every entry of every array is finite (``all_finite.cc``)."""
    ok = None
    for a in _arrays(arrays):
        s = _apply_op("min", _apply_op("isfinite", a))
        ok = s if ok is None else ok * s
    return ok


# ---------------------------------------------------------------------------
# a generated function for every registered op not written above, and the
# legacy CamelCase names
# ---------------------------------------------------------------------------
_MANUAL = set(dir(_this))


def _install_wrappers():
    for name in _registry.list_ops():
        if name in _MANUAL or name.startswith("_random") or \
                name == "_shuffle":
            continue
        setattr(_this, name, _registry.make_nd_wrapper(
            _registry.get_op(name)))
    for legacy, new in [("Flatten", "flatten"), ("Concat", "concat"),
                        ("Reshape", "reshape"), ("LeakyReLU", "leaky_relu"),
                        ("SliceChannel", "split"), ("SwapAxis", "swapaxes"),
                        ("Pad", "pad"), ("stop_gradient", "BlockGrad")]:
        if not hasattr(_this, legacy):
            setattr(_this, legacy, getattr(_this, new))


_install_wrappers()

from . import random  # noqa: E402  (nd.random namespace)
from . import contrib  # noqa: E402  (nd.contrib namespace)
from . import image  # noqa: E402  (nd.image namespace)
from .. import sparse  # noqa: E402  (nd.sparse namespace)

# storage-type conversion (``cast_storage-inl.h``) and the sum of squares
# over a row-sparse array's stored rows
cast_storage = sparse.cast_storage
_square_sum = sparse.square_sum

# the array-parameter samplers at nd level too, as in the reference
sample_uniform = random.sample_uniform
sample_normal = random.sample_normal
sample_gamma = random.sample_gamma
sample_exponential = random.sample_exponential
sample_poisson = random.sample_poisson
sample_negative_binomial = random.sample_negative_binomial
sample_generalized_negative_binomial = \
    random.sample_generalized_negative_binomial
