"""Neural-network operators of the port: the counterparts of the functions
in ``mxnet_tpu/ops/nn.py`` (and ``gelu``/``gelu_tanh`` of
``ops/elemwise.py``, ``pick`` of ``ops/tensor.py``) that the BERT serving and
pretraining paths run. Same layouts, conventions and dtype rules as the JAX
package, plain functions on tensors.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from .cuda.flash_attention import _dense_attention, flash_attention

__all__ = ["fully_connected", "layer_norm", "embedding", "gelu", "gelu_tanh",
           "log_softmax", "pick", "multi_head_attention"]


def fully_connected(x, weight, bias=None, *, flatten: bool = True):
    """y = x W^T + b with weight (num_hidden, in_units), as the reference."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def _bf16_reduce() -> bool:
    """``MXNET_BN_BF16_REDUCE`` as the JAX package reads it (default on)."""
    raw = os.environ.get("MXNET_BN_BF16_REDUCE")
    return True if raw is None else raw.lower() in ("1", "true", "yes", "on")


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
    their plain versions on a CPU one);
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
        out = flash_attention(qh.contiguous(), kh.contiguous(),
                              vh.contiguous(), causal=causal)
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
