"""Elementwise, scalar, broadcast and reduction operators of the port (the
counterpart of ``mxnet_tpu/ops/elemwise.py``): plain PyTorch functions
over tensors, registered under the JAX package's names, with its dtype
results where PyTorch's type promotion differs (named at each family).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import config
from ..base import DTypes
from .registry import register

_HALF = (torch.bfloat16, torch.float16)


def _float(x):
    """``x`` as a floating tensor: integers and bools become float32 (the
    JAX package's result for a float function of an integer array)."""
    return x if x.is_floating_point() else x.float()


# ---------------------------------------------------------------------------
# unary
# ---------------------------------------------------------------------------
def _unary(name, f, differentiable=True):
    def fn(x):
        return f(x)
    fn.__name__ = name
    fn.__doc__ = f"Elementwise {name} (src/operator/mshadow_op.h)."
    register(name, differentiable=differentiable)(fn)
    return fn


def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _softplus(x):
    """log(1 + exp(x)) without a threshold (``jax.nn.softplus``)."""
    x = _float(x)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _int_or(f):
    """Rounding functions keep an integer array as it is."""
    return lambda x: x.clone() if not x.is_floating_point() else f(x)


_unary("identity", lambda x: x.clone())
_unary("negative", torch.neg)
_unary("abs", torch.abs)
_unary("sign", lambda x: torch.where(torch.isnan(x), x, torch.sign(x))
       if x.is_floating_point() else torch.sign(x))
_unary("exp", lambda x: torch.exp(_float(x)))
_unary("expm1", lambda x: torch.expm1(_float(x)))
_unary("log", lambda x: torch.log(_float(x)))
_unary("log2", lambda x: torch.log2(_float(x)))
_unary("log10", lambda x: torch.log10(_float(x)))
_unary("log1p", lambda x: torch.log1p(_float(x)))
_unary("sqrt", lambda x: torch.sqrt(_float(x)))
_unary("rsqrt", lambda x: torch.rsqrt(_float(x)))
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("square", torch.square)
_unary("reciprocal", lambda x: 1.0 / _float(x))
_unary("sin", lambda x: torch.sin(_float(x)))
_unary("cos", lambda x: torch.cos(_float(x)))
_unary("tan", lambda x: torch.tan(_float(x)))
_unary("arcsin", lambda x: torch.asin(_float(x)))
_unary("arccos", lambda x: torch.acos(_float(x)))
_unary("arctan", lambda x: torch.atan(_float(x)))
_unary("sinh", lambda x: torch.sinh(_float(x)))
_unary("cosh", lambda x: torch.cosh(_float(x)))
_unary("tanh", lambda x: torch.tanh(_float(x)))
_unary("arcsinh", lambda x: torch.asinh(_float(x)))
_unary("arccosh", lambda x: torch.acosh(_float(x)))
_unary("arctanh", lambda x: torch.atanh(_float(x)))
_unary("erf", lambda x: torch.erf(_float(x)))
_unary("erfinv", lambda x: torch.erfinv(_float(x)))
_unary("gamma", lambda x: torch.exp(torch.lgamma(_float(x))))
_unary("gammaln", lambda x: torch.lgamma(_float(x)))
_unary("digamma", lambda x: torch.digamma(_float(x)))
_unary("floor", _int_or(torch.floor), differentiable=False)
_unary("ceil", _int_or(torch.ceil), differentiable=False)
_unary("round", _int_or(torch.round), differentiable=False)   # half to even
_unary("rint", lambda x: torch.round(_float(x)), differentiable=False)
_unary("trunc", _int_or(torch.trunc), differentiable=False)
_unary("fix", _int_or(torch.trunc), differentiable=False)
_unary("logical_not", torch.logical_not, differentiable=False)
_unary("isnan", torch.isnan, differentiable=False)
_unary("isinf", torch.isinf, differentiable=False)
_unary("isfinite", torch.isfinite, differentiable=False)
_unary("relu", torch.relu)
_unary("sigmoid", lambda x: torch.sigmoid(_float(x)))
_unary("softsign", lambda x: x / (1 + x.abs()))
_unary("softrelu", _softplus)
gelu = _unary("gelu", lambda x: F.gelu(_float(x)))
gelu_tanh = _unary("gelu_tanh",
                   lambda x: F.gelu(_float(x), approximate="tanh"))
_unary("silu", lambda x: F.silu(_float(x)))
_unary("mish", lambda x: x * torch.tanh(_softplus(x)))
_unary("hard_sigmoid", lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0))
_unary("erf_inv", lambda x: torch.erfinv(_float(x)))
_unary("degrees", lambda x: _float(x) * (180.0 / math.pi))
_unary("radians", lambda x: _float(x) * (math.pi / 180.0))


@register("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register("clip")
def clip(x, *, a_min=None, a_max=None):
    """Clamp to [a_min, a_max], the bounds cast to the input's dtype first
    (``matrix_op.cc`` clip keeps the operand dtype)."""
    def bound(v):
        return None if v is None else torch.tensor(v).to(x.dtype).item()
    return torch.clamp(x, bound(a_min), bound(a_max))


@register("cast")
def cast(x, *, dtype):
    return x.to(DTypes.torch(dtype))


@register("amp_cast")
def amp_cast(x, *, dtype):
    """AMP dtype cast (``amp_cast.cc``); identity for integer arrays."""
    if not x.is_floating_point():
        return x
    return x.to(DTypes.torch(dtype))


_FLOAT_ORDER = [torch.float16, torch.bfloat16, torch.float32, torch.float64]


@register("amp_multicast")
def amp_multicast(*arrays, num_outputs=None, cast_narrow=False):
    """Cast a group of arrays to their widest float dtype (narrowest with
    ``cast_narrow``), integer arrays untouched (``AMPMultiCast``)."""
    floats = [a.dtype for a in arrays if a.is_floating_point()]
    if not floats:
        return arrays if len(arrays) > 1 else arrays[0]
    pick = min if cast_narrow else max
    target = pick(floats, key=_FLOAT_ORDER.index)
    outs = tuple(a.to(target) if a.is_floating_point() else a
                 for a in arrays)
    return outs if len(outs) > 1 else outs[0]


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("leaky_relu")
def leaky_relu(x, *, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    """The LeakyReLU family (``leaky_relu.cc``): leaky, elu, selu, gelu;
    rrelu as leaky with the mean slope (the inference form)."""
    if act_type == "leaky":
        return torch.where(x >= 0, x, slope * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(x >= 0, x,
                                         _SELU_ALPHA * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "rrelu":
        return torch.where(x >= 0, x, 0.5 * (lower_bound + upper_bound) * x)
    raise ValueError(f"unknown act_type {act_type}")


@register("prelu")
def prelu(x, gamma):
    """Leaky ReLU with a learned slope per channel (axis 1)."""
    g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
        if gamma.dim() == 1 and x.dim() > 1 else gamma
    return torch.where(x >= 0, x, g * x)


# ---------------------------------------------------------------------------
# scalar ops: the scalar takes a floating array's dtype; an integer array
# with a Python float gives float32, with a Python int stays integer
# ---------------------------------------------------------------------------
def _scalar(x, scalar):
    if x.is_floating_point():
        dt = x.dtype
    elif isinstance(scalar, float):
        dt = torch.float32
    else:
        dt = torch.int32 if x.dtype == torch.bool else x.dtype
    return torch.tensor(scalar, dtype=dt, device=x.device)


def _hypot(a, b):
    return torch.hypot(_float(a), _float(b))


def _scalar_op(name, f):
    def fn(x, *, scalar=1.0, reverse=False):
        s = _scalar(x, scalar)
        if not x.is_floating_point() and s.is_floating_point():
            x = x.to(s.dtype)
        return f(s, x) if reverse else f(x, s)
    fn.__name__ = name
    register(name)(fn)


_scalar_op("_plus_scalar", torch.add)
_scalar_op("_minus_scalar", torch.sub)
_scalar_op("_mul_scalar", torch.mul)
_scalar_op("_div_scalar", torch.true_divide)
_scalar_op("_mod_scalar", torch.remainder)
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_maximum_scalar", torch.maximum)
_scalar_op("_minimum_scalar", torch.minimum)
_scalar_op("_hypot_scalar", _hypot)


# ---------------------------------------------------------------------------
# binary broadcast; comparisons and logical ops give 0/1 in a's dtype
# ---------------------------------------------------------------------------
def _binary(name, f, differentiable=True):
    def fn(a, b):
        return f(a, b)
    fn.__name__ = name
    register(name, differentiable=differentiable)(fn)


def _pred(f):
    return lambda a, b: f(a, b).to(a.dtype)


_binary("broadcast_add", torch.add)
_binary("broadcast_sub", torch.sub)
_binary("broadcast_mul", torch.mul)
_binary("broadcast_div", torch.true_divide)
_binary("broadcast_mod", torch.remainder)
_binary("broadcast_power", torch.pow)
_binary("broadcast_maximum", torch.maximum)
_binary("broadcast_minimum", torch.minimum)
_binary("broadcast_hypot", _hypot)
_binary("broadcast_equal", _pred(torch.eq), differentiable=False)
_binary("broadcast_not_equal", _pred(torch.ne), differentiable=False)
_binary("broadcast_greater", _pred(torch.gt), differentiable=False)
_binary("broadcast_greater_equal", _pred(torch.ge), differentiable=False)
_binary("broadcast_lesser", _pred(torch.lt), differentiable=False)
_binary("broadcast_lesser_equal", _pred(torch.le), differentiable=False)
_binary("broadcast_logical_and", _pred(torch.logical_and),
        differentiable=False)
_binary("broadcast_logical_or", _pred(torch.logical_or),
        differentiable=False)
_binary("broadcast_logical_xor", _pred(torch.logical_xor),
        differentiable=False)
# elementwise aliases (the reference's do not broadcast; these do)
_binary("elemwise_add", torch.add)
_binary("elemwise_sub", torch.sub)
_binary("elemwise_mul", torch.mul)
_binary("elemwise_div", torch.true_divide)
_binary("maximum", torch.maximum)
_binary("minimum", torch.minimum)
_binary("hypot", _hypot)
_binary("arctan2", lambda a, b: torch.atan2(_float(a), _float(b)))
_binary("ldexp", lambda a, b: a * torch.pow(2.0, _float(b)))


@register("add_n")
def add_n(*arrays):
    """Sum of N arrays (``elemwise_sum.cc``), left to right."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


@register("smooth_l1")
def smooth_l1(x, *, scalar=1.0):
    s2 = scalar * scalar
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


# ---------------------------------------------------------------------------
# reductions: f32 accumulation for bf16/fp16 (MXNET_SAFE_ACCUMULATION),
# cast back; integer sums and products are int32 (x64 is off in the
# reference), means of integers float32
# ---------------------------------------------------------------------------
def _acc_dtype(x):
    if x.dtype in _HALF and config.get("MXNET_SAFE_ACCUMULATION"):
        return torch.float32
    return x.dtype


def _dims(x, axis, exclude=False):
    """``axis`` as a tuple of non-negative dims (None: every dim)."""
    if axis is None:
        return tuple(range(x.dim()))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % max(x.dim(), 1) for a in axes)
    if exclude:
        axes = tuple(i for i in range(x.dim()) if i not in axes)
    return axes


def _over(f, x, dims, keepdims):
    """``f(x, dim)`` over every dim in ``dims``, highest first."""
    for d in sorted(dims, reverse=True):
        x = f(x, d, keepdims)
    return x


def _sum(x, dims, keepdims):
    return torch.sum(x, dim=dims, keepdim=keepdims) if dims else x


def _prod(x, dims, keepdims):
    return _over(lambda t, d, k: torch.prod(t, dim=d, keepdim=k), x, dims,
                 keepdims)


def _max(x, dims, keepdims):
    return torch.amax(x, dim=dims, keepdim=keepdims) if dims else x


def _min(x, dims, keepdims):
    return torch.amin(x, dim=dims, keepdim=keepdims) if dims else x


def _mean(x, dims, keepdims):
    return torch.mean(x, dim=dims, keepdim=keepdims) if dims else x


def _nansum(x, dims, keepdims):
    return torch.nansum(x, dim=dims, keepdim=keepdims) if dims else x


def _nanprod(x, dims, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, dims, keepdims)


def _int_acc(x):
    """Integer sums and products of the reference: int32, uint32 for
    unsigned inputs."""
    return torch.uint32 if x.dtype == torch.uint8 else torch.int32


def _reduce(name, f, integral=True):
    def fn(x, *, axis=None, keepdims=False, exclude=False):
        dims = _dims(x, axis, exclude)
        acc = _acc_dtype(x)
        if not x.is_floating_point() and not integral:
            out = f(x.float(), dims, keepdims)       # mean of integers
            return out
        out = f(x.to(acc), dims, keepdims)
        if not x.is_floating_point() and f in (_sum, _prod, _nansum,
                                                _nanprod):
            return out.to(_int_acc(x))
        return out.to(x.dtype)
    fn.__name__ = name
    register(name)(fn)


_reduce("sum", _sum)
_reduce("mean", _mean, integral=False)
_reduce("prod", _prod)
_reduce("max", _max)
_reduce("min", _min)
_reduce("nansum", _nansum)
_reduce("nanprod", _nanprod)
_reduce("sum_axis", _sum)


def _arg(f, x, axis, keepdims):
    if axis is None:
        return f(x.reshape(-1)).float()
    out = f(x, dim=axis, keepdim=keepdims)
    return out.float()               # the reference returns float indices


@register("argmax", differentiable=False)
def argmax(x, *, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin", differentiable=False)
def argmin(x, *, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argmax_channel", differentiable=False)
def argmax_channel(x):
    return torch.argmax(x, dim=1).float()


@register("norm")
def norm(x, *, ord=2, axis=None, keepdims=False):
    dims = _dims(x, axis)
    xa = x.to(_acc_dtype(x))
    if ord == 1:
        out = _sum(xa.abs(), dims, keepdims)
    elif ord == 2:
        out = torch.sqrt(_sum(xa * xa, dims, keepdims))
    else:
        out = _sum(xa.abs() ** ord, dims, keepdims) ** (1.0 / ord)
    return out.to(x.dtype)


@register("moments")
def moments(x, *, axes=None, keepdims=False):
    dims = _dims(x, axes)
    mean = _mean(x, dims, keepdims)
    mk = mean if keepdims else _mean(x, dims, True)
    var = _mean(torch.square(x - mk), dims, keepdims)
    return mean, var


def _cum(f, x, axis, dtype):
    dt = DTypes.torch(dtype) if dtype is not None else (
        x.dtype if x.is_floating_point() else _int_acc(x))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return f(x, dim=axis, dtype=dt)


@register("cumsum")
def cumsum(x, *, axis=None, dtype=None):
    return _cum(torch.cumsum, x, axis, dtype)


@register("cumprod")
def cumprod(x, *, axis=None, dtype=None):
    return _cum(torch.cumprod, x, axis, dtype)


@register("logsumexp")
def logsumexp(x, *, axis=None, keepdims=False):
    dims = _dims(x, axis)
    return torch.logsumexp(_float(x), dim=dims, keepdim=keepdims) \
        if dims else _float(x).clone()
