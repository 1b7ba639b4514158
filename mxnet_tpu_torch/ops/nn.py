"""Neural-network operators of the port: the counterparts of the functions
in ``mxnet_tpu/ops/nn.py`` (and ``gelu``/``gelu_tanh`` of
``ops/elemwise.py``, ``pick`` of ``ops/tensor.py``) that the BERT serving and
pretraining paths, the ResNet-50 training path and the generative serving
path run (``single_query_attention``, the decode step's attention, from
``ops/pallas/flash_attention.py``). Same layouts (NCHW
activations, OIHW convolution weights), conventions and dtype rules as the
JAX package, plain functions on tensors.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .cuda.flash_attention import (_dense_attention, flash_attention,
                                   single_query_attention)

__all__ = ["fully_connected", "convolution", "pooling", "activation",
           "batch_norm", "bn_scale_shift", "layer_norm", "embedding", "gelu",
           "gelu_tanh", "log_softmax", "pick", "multi_head_attention",
           "single_query_attention"]


def fully_connected(x, weight, bias=None, *, flatten: bool = True):
    """y = x W^T + b with weight (num_hidden, in_units), as the reference."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def _pair(v, default=1):
    """``v`` as an (h, w) pair: an int is repeated, None is ``default``."""
    if v is None:
        v = default
    return (v, v) if isinstance(v, int) else tuple(v)


def convolution(x, weight, bias=None, *, stride=None, dilate=None, pad=None,
                num_group=1):
    """2-D convolution over NCHW ``x`` with OIHW ``weight`` (cuDNN through
    ``torch.nn.functional.conv2d``, a library convolution in both packages;
    TF32 stays off). bf16 in gives bf16 out."""
    if x.dim() != 4:
        raise MXNetError(f"convolution: NCHW input expected, got "
                         f"{tuple(x.shape)}")
    return F.conv2d(x, weight, bias, stride=_pair(stride),
                    padding=_pair(pad, 0), dilation=_pair(dilate),
                    groups=num_group)


def pooling(x, *, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None):
    """The two forms of ``Pooling`` that ResNet v1 runs, over NCHW ``x``:
    max over ``kernel`` windows at ``stride`` (default the kernel) with
    ``pad`` on both sides, -inf padded and the output size rounded down
    (the reference's "valid" convention); and global average pooling
    (``global_pool``), which keeps H and W as size 1. Other pool types and
    windowed averages are not ported."""
    if global_pool and pool_type == "avg":
        return x.mean(dim=(2, 3), keepdim=True)
    if global_pool or pool_type != "max":
        raise MXNetError(f"pooling: {pool_type!r} pooling with global_pool="
                         f"{global_pool} is not ported")
    kernel = _pair(kernel)
    return F.max_pool2d(x, kernel, _pair(stride, kernel), _pair(pad, 0))


_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh}


def activation(x, *, act_type: str = "relu"):
    """``Activation``: relu (ResNet) or tanh (BERT's pooler)."""
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"activation {act_type!r} is not ported; expected "
                         f"one of {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](x)


def _flag(name: str, default: str) -> str:
    return os.environ.get(name, default).strip().lower()


def _bf16_reduce() -> bool:
    """``MXNET_BN_BF16_REDUCE`` as the JAX package reads it (default on)."""
    return _flag("MXNET_BN_BF16_REDUCE", "1") in ("1", "true", "yes", "on")


def _bn_onepass_enabled(dtype) -> bool:
    """``MXNET_BN_ONEPASS`` as the JAX package resolves it: "auto" (the
    default) takes the one-pass E[x^2] - E[x]^2 moments for bf16/fp16 input
    only; otherwise the flag's truth value."""
    v = _flag("MXNET_BN_ONEPASS", "auto")
    if v in ("auto", ""):
        return dtype in (torch.bfloat16, torch.float16)
    return v in ("1", "true", "yes", "on")


def bn_scale_shift(x, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   training=False, axis=1):
    """BatchNorm's statistics in f32: ``(a, b, mean, var, new_moving_mean,
    new_moving_var)`` with a = gamma / sqrt(var + eps) and b = beta - mean *
    a, so that out = x * a + b. In training mode (unless
    ``use_global_stats``) mean and var are the batch moments (one-pass
    E[x^2] - E[x]^2 for bf16 input while ``MXNET_BN_BF16_REDUCE`` is on,
    else as ``MXNET_BN_ONEPASS`` says), otherwise the moving ones. The
    moving-stat update takes no gradient."""
    red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    xa = x.float()
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    if training and not use_global_stats:
        mean = xa.mean(dim=red)
        if (x.dtype == torch.bfloat16 and _bf16_reduce()) or \
                _bn_onepass_enabled(x.dtype):
            var = (xa.square().mean(dim=red) - mean.square()).clamp_min(0.0)
        else:
            shape = [1] * x.dim()
            shape[axis] = x.shape[axis]
            var = (xa - mean.reshape(shape)).square().mean(dim=red)
        with torch.no_grad():
            new_mean = momentum * moving_mean.float() + (1 - momentum) * mean
            new_var = momentum * moving_var.float() + (1 - momentum) * var
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mean, new_var = mean, var
    a = torch.rsqrt(var + eps) * gamma.float()
    return a, beta.float() - mean * a, mean, var, new_mean, new_var


def batch_norm(x, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               training=False, axis=1):
    """BatchNorm (``nn/batch_norm.cc``): ``(out, new_moving_mean,
    new_moving_var)``, the write-back left to the caller as in the
    reference. bf16 input with ``MXNET_BN_BF16_REDUCE`` on (the default):
    out = x * a + b computed in f32 and rounded to bf16. Otherwise the f32
    form (x - mean) * a + beta. The new moving stats keep the moving
    stats' dtype."""
    a, b, mean, _, new_mean, new_var = bn_scale_shift(
        x, gamma, beta, moving_mean, moving_var, eps=eps, momentum=momentum,
        fix_gamma=fix_gamma, use_global_stats=use_global_stats,
        training=training, axis=axis)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if x.dtype == torch.bfloat16 and _bf16_reduce():
        out = x * a.reshape(shape) + b.reshape(shape)
    else:
        out = (x.float() - mean.reshape(shape)) * a.reshape(shape) \
            + beta.float().reshape(shape)
    return (out.to(x.dtype), new_mean.to(moving_mean.dtype),
            new_var.to(moving_var.dtype))


def layer_norm(x, gamma, beta, *, axis: int = -1, eps: float = 1e-5):
    """LayerNorm over ``axis`` with f32 statistics. For bf16 input, while
    the ``MXNET_BN_BF16_REDUCE`` flag is on (the default), the one-pass
    recipe: E[x^2] - E[x]^2 moments and an f32 scale/shift applied to x,
    every materialized tensor bf16. Otherwise the two-pass f32 form."""
    xa = x.float()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    g = gamma.float().reshape(shape)
    b = beta.float().reshape(shape)
    mean = xa.mean(dim=axis, keepdim=True)
    if x.dtype == torch.bfloat16 and _bf16_reduce():
        sq = xa.square().mean(dim=axis, keepdim=True)
        var = (sq - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + eps) * g
        return (xa * a + (b - mean * a)).to(x.dtype)
    var = (xa - mean).square().mean(dim=axis, keepdim=True)
    return ((xa - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def embedding(indices, weight):
    """Rows of ``weight`` at integer ``indices`` (any integer dtype)."""
    return F.embedding(indices.long(), weight)


def gelu(x):
    """The erf-exact GELU (``gelu`` of ``ops/elemwise.py``; the pretraining
    heads' MLM transform)."""
    return F.gelu(x)


def gelu_tanh(x):
    """The tanh-approximate GELU (original BERT)."""
    return F.gelu(x, approximate="tanh")


def log_softmax(x, axis: int = -1):
    """log-softmax over ``axis``, computed in f32 for bf16/fp16 input and
    cast back to the input dtype (``_softmax_core``, ``ops/nn.py:206``)."""
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype
    return torch.log_softmax(x.to(acc), dim=axis).to(x.dtype)


def pick(x, indices, *, axis: int = -1, keepdims: bool = False):
    """``x`` at ``indices`` along ``axis`` (``pick`` of ``ops/tensor.py``);
    ``indices`` has x's shape without ``axis``, any numeric dtype."""
    idx = indices.long().unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


def multi_head_attention(q, k, v, mask=None, *, heads: int = 1,
                         causal: bool = False):
    """Batched SDPA over q/k/v of shape (N, L, H*D).

    An unmasked call with Lq == Lk goes to :func:`flash_attention` (the
    hand-written kernels, K1 forward and K2 + K3 backward, on a CUDA tensor;
    their plain versions on a CPU one) with the (N, H, L, D) views of q, k
    and v as they are (the split QKV projection, read in place by K1), and
    K1's output is (N, L, H, D) memory, so the result is a view too;
    unmasked Lq != Lk takes the dense path; a ``mask`` (broadcastable to
    (N, H, Lq, Lk), nonzero = attend) takes the masked composite.

    ``causal=True`` is **bottom-right aligned** when Lq != Lk: query row i
    attends keys ``j <= i + (Lk - Lq)``, so the last query row sees every
    key; for Lq == Lk it is plain ``tril``."""
    N, Lq, HD = q.shape
    D = HD // heads
    qh = q.reshape(N, Lq, heads, D).transpose(1, 2)
    kh = k.reshape(N, -1, heads, D).transpose(1, 2)
    vh = v.reshape(N, -1, heads, D).transpose(1, 2)
    Lk = kh.shape[2]
    if mask is None and Lq == Lk:
        out = flash_attention(qh, kh, vh, causal=causal)
    elif mask is None:
        out = _dense_attention(qh, kh, vh, 1.0 / math.sqrt(D), causal)
    else:
        att = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
            / math.sqrt(D)
        if causal:
            keep = torch.ones(Lq, Lk, dtype=torch.bool,
                              device=q.device).tril(Lk - Lq)
            att = att.masked_fill(~keep, -math.inf)
        att = att.masked_fill(~mask.bool(), -math.inf)
        p = torch.softmax(att, dim=-1).to(q.dtype)
        out = torch.matmul(p.float(), vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(N, Lq, heads * D)
