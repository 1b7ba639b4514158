"""Neural-network operators of the port: the counterparts of the functions
in ``mxnet_tpu/ops/nn.py``, plain PyTorch functions over tensors
registered under the JAX package's names, with its layouts (NC...
activations, OI... convolution weights, (in, out/groups, ...)
transposed-convolution weights), conventions and dtype rules. The gluon
layers and the model zoo call them directly.

Attention runs through :func:`multi_head_attention`, which routes to the
hand-written kernels (K1 forward, K2 + K3 backward; ``cuda/
flash_attention.py``) as the BERT paths do; ``single_query_attention``,
the decode step's attention, is plain torch ops.

The ops whose gradient the reference defines rather than derives
(``SoftmaxOutput``, the three regression outputs, ``MakeLoss``,
``SVMOutput``) are ``torch.autograd.Function`` s with its forward and
backward. The RNN op (:func:`rnn`) computes as the reference does: one
product for the input projection of all T steps, then per step the
recurrent product and the gates; it reads every layer's weights from one
flat vector in the reference's layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import config
from ..base import MXNetError
from .cuda.flash_attention import (_dense_attention, flash_attention,
                                   single_query_attention)
from .elemwise import gelu, gelu_tanh
from .registry import register
from .tensor import one_hot, pick

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "activation", "batch_norm", "bn_scale_shift", "layer_norm",
           "rms_norm", "group_norm", "instance_norm", "embedding", "gelu",
           "gelu_tanh", "softmax", "log_softmax", "pick", "dropout", "rnn",
           "rnn_param_size", "rnn_unpack_params", "ctc_loss",
           "multi_head_attention", "single_query_attention"]

_HALF = (torch.bfloat16, torch.float16)


def _tup(v, n, default=1):
    """``v`` as an n-tuple: an int is repeated, None is ``default``."""
    if v is None:
        v = default
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t * n


def _acc(x):
    return torch.float32 if x.dtype in _HALF else x.dtype


# ---------------------------------------------------------------------------
# FullyConnected, Convolution, Deconvolution
# ---------------------------------------------------------------------------
@register("FullyConnected")
def fully_connected(x, weight, bias=None, *, num_hidden=0, no_bias=False,
                    flatten=True):
    """y = x W^T + b with weight (num_hidden, in_units)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], math.prod(x.shape[1:]))
    return F.linear(x, weight, None if no_bias else bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _spatial(x, what):
    nd = x.dim() - 2
    if nd not in _CONV:
        raise MXNetError(f"{what}: NCW/NCHW/NCDHW input expected, got "
                         f"{tuple(x.shape)}")
    return nd


@register("Convolution")
def convolution(x, weight, bias=None, *, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=0, num_group=1,
                no_bias=False, layout=None):
    """1/2/3-D convolution over NC... ``x`` with OI... ``weight`` (cuDNN
    through ``torch.nn.functional``, a library convolution in both
    packages; TF32 stays off). bf16 in gives bf16 out."""
    nd = _spatial(x, "convolution")
    return _CONV[nd](x, weight, None if no_bias else bias,
                     stride=_tup(stride, nd), padding=_tup(pad, nd, 0),
                     dilation=_tup(dilate, nd), groups=num_group)


@register("Deconvolution")
def deconvolution(x, weight, bias=None, *, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=0, num_group=1,
                  no_bias=False, target_shape=None, layout=None):
    """Transposed convolution, weight (in_c, out_c / groups, *k);
    ``adj`` pads the output's high side."""
    nd = _spatial(x, "deconvolution")
    return _DECONV[nd](x, weight, None if no_bias else bias,
                       stride=_tup(stride, nd), padding=_tup(pad, nd, 0),
                       output_padding=_tup(adj, nd, 0), groups=num_group,
                       dilation=_tup(dilate, nd))


# ---------------------------------------------------------------------------
# Pooling, UpSampling, BilinearResize2D
# ---------------------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _windows(x, kernel, stride):
    """(N, C, *out, *kernel) windows of ``x`` as a view."""
    nd = len(kernel)
    for i in range(nd):
        x = x.unfold(2 + i, kernel[i], stride[i])
    return x


@register("Pooling")
def pooling(x, *, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None):
    """Pooling (``pooling.cc``) over NC... ``x``: max, avg, sum or lp (p =
    2) windows at ``stride`` (default the kernel) with ``pad`` on both
    sides; "valid" rounds the output size down, "full" up (padding the
    high side further); an average over padding counts it unless
    ``count_include_pad`` is False; ``global_pool`` reduces all of H, W
    (, D) keeping them as size 1."""
    nd = x.dim() - 2
    spatial = tuple(range(2, x.dim()))
    if global_pool:
        if pool_type == "max":
            return torch.amax(x, dim=spatial, keepdim=True)
        if pool_type == "avg":
            return x.mean(dim=spatial, keepdim=True)
        if pool_type == "sum":
            return x.sum(dim=spatial, keepdim=True)
        raise ValueError(pool_type)
    kernel = _tup(kernel, nd)
    stride = _tup(stride if stride is not None else kernel, nd)
    pad = _tup(pad, nd, 0)
    if pool_type == "max" and pooling_convention == "valid" and \
            all(2 * p <= k for p, k in zip(pad, kernel)):
        return _MAX_POOL[nd](x, kernel, stride, pad)
    pads = []
    for i in range(nd):
        hi = pad[i]
        if pooling_convention == "full":
            size = x.shape[2 + i]
            out = int(math.ceil((size + 2 * pad[i] - kernel[i]) / stride[i])) \
                + 1
            hi = max((out - 1) * stride[i] + kernel[i] - size - pad[i],
                     pad[i])
        pads.append((pad[i], hi))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    red = tuple(range(-nd, 0))
    if pool_type == "max":
        low = -math.inf if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        return torch.amax(_windows(F.pad(x, flat, value=low), kernel,
                                   stride), dim=red)
    if pool_type in ("avg", "sum"):
        s = _windows(F.pad(x, flat), kernel, stride).sum(dim=red)
        if pool_type == "sum":
            return s
        if count_include_pad:
            return s / math.prod(kernel)
        ones = F.pad(torch.ones_like(x), flat)
        return s / _windows(ones, kernel, stride).sum(dim=red)
    if pool_type == "lp":
        s = _windows(F.pad(x.abs() ** 2, flat), kernel, stride).sum(dim=red)
        return torch.sqrt(s)
    raise ValueError(pool_type)


@register("UpSampling")
def upsampling(x, *, scale=2, sample_type="nearest", num_args=1):
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register("BilinearResize2D")
def bilinear_resize_2d(x, *, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size"):
    """Bilinear resize with half-pixel centers, antialiased when it
    shrinks (``jax.image.resize``)."""
    h, w = x.shape[2:]
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False,
                         antialias=height < h or width < w)


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------
def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": _softplus, "softsign": lambda v: v / (1 + v.abs()),
    "log_sigmoid": F.logsigmoid,
    "mish": lambda v: v * torch.tanh(_softplus(v)),
    "gelu": F.gelu, "silu": F.silu}


@register("Activation")
def activation(x, *, act_type="relu"):
    """``Activation`` (``activation.cc``) by ``act_type``."""
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"activation {act_type!r}; expected one of "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](x)


# ---------------------------------------------------------------------------
# the softmax family (f32 accumulation for bf16/fp16 input)
# ---------------------------------------------------------------------------
def _softmax_core(x, axis, temperature, length, log: bool):
    xa = x.to(_acc(x))
    if temperature is not None and temperature != 1.0:
        xa = xa / temperature
    f = torch.log_softmax if log else torch.softmax
    if length is None:
        return f(xa, dim=axis).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    bshape = [1] * x.dim()
    bshape[0] = x.shape[0]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    mask = pos < length.to(torch.int32).reshape(bshape)
    out = f(xa.masked_fill(~mask, -math.inf), dim=axis)
    return out.masked_fill(~mask, 0.0).to(x.dtype)


@register("softmax")
def softmax(x, length=None, *, axis=-1, temperature=None, use_length=False,
            dtype=None):
    """Softmax over ``axis``; with ``use_length`` only the first
    ``length[b]`` positions of row b count (the rest give 0)."""
    return _softmax_core(x, axis, temperature,
                         length if use_length else None, log=False)


@register("log_softmax")
def log_softmax(x, length=None, *, axis=-1, temperature=None,
                use_length=False, dtype=None):
    """log-softmax over ``axis``, computed in f32 for bf16/fp16 input and
    cast back to the input dtype."""
    return _softmax_core(x, axis, temperature,
                         length if use_length else None, log=True)


@register("masked_softmax")
def masked_softmax(x, mask, *, axis=-1, temperature=1.0, normalize=True):
    keep = mask.bool()
    xa = x.to(_acc(x)) / temperature
    out = torch.softmax(xa.masked_fill(~keep, -math.inf), dim=axis)
    return out.masked_fill(~keep, 0.0).to(x.dtype)


@register("softmin")
def softmin(x, *, axis=-1, temperature=None, dtype=None):
    return _softmax_core(-x, axis, temperature, None, log=False)


@register("SoftmaxActivation")
def softmax_activation(x, *, mode="instance"):
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; the gradient w.r.t. x is (p - onehot(label)) *
    grad_scale, the incoming gradient ignored (``softmax_output.cc``)."""

    @staticmethod
    def forward(ctx, x, label, attrs):
        axis = 1 if attrs["multi_output"] else -1
        p = torch.softmax(x.float(), dim=axis)
        ctx.save_for_backward(p, label)
        ctx.attrs = attrs
        return p.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        a = ctx.attrs
        axis = 1 if a["multi_output"] else p.dim() - 1
        depth = p.shape[axis]
        oh = one_hot(label, depth=depth).to(p.dtype).movedim(-1, axis)
        if a["smooth_alpha"]:
            oh = oh * (1 - a["smooth_alpha"]) + a["smooth_alpha"] / depth
        dx = p - oh
        ignore = label != a["ignore_label"]
        if a["use_ignore"]:
            keep = ignore.to(p.dtype)
            dx = dx * (keep.unsqueeze(axis) if keep.dim() < p.dim()
                       else keep)
        scale = a["grad_scale"]
        if a["normalization"] == "valid" and a["use_ignore"]:
            scale = scale / torch.clamp(ignore.sum().to(p.dtype), min=1.0)
        elif a["normalization"] == "batch":
            scale = scale / p.shape[0]
        return (dx * scale).to(p.dtype), None, None


@register("SoftmaxOutput")
def softmax_output(x, label, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Legacy softmax + cross-entropy-gradient head."""
    return _SoftmaxOutput.apply(x, label, dict(
        grad_scale=grad_scale, ignore_label=ignore_label,
        multi_output=multi_output, use_ignore=use_ignore,
        normalization=normalization, smooth_alpha=smooth_alpha))


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data.float(), dim=-1)
    oh = one_hot(label, depth=data.shape[-1]).to(logp.dtype)
    return -(oh * logp).sum()


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------
def _bf16_reduce() -> bool:
    return bool(config.get("MXNET_BN_BF16_REDUCE"))


def _bn_onepass_enabled(dtype) -> bool:
    """``MXNET_BN_ONEPASS`` as the JAX package resolves it: "auto" (the
    default) takes the one-pass E[x^2] - E[x]^2 moments for bf16/fp16 input
    only; otherwise the flag's truth value."""
    v = config.get("MXNET_BN_ONEPASS")
    if isinstance(v, bool):
        return v
    v = str(v).strip().lower()
    if v in ("auto", ""):
        return dtype in _HALF
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


@register("BatchNorm")
def batch_norm(x, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False, axis_name=None):
    """BatchNorm (``nn/batch_norm.cc``): ``(out, new_moving_mean,
    new_moving_var)``, the write-back left to the caller as in the
    reference. bf16 input with ``MXNET_BN_BF16_REDUCE`` on (the default):
    out = x * a + b computed in f32 and rounded to bf16. Otherwise the f32
    form (x - mean) * a + beta. The new moving stats keep the moving
    stats' dtype. ``axis_name`` (cross-device moments) waits for the
    multi-GPU slice."""
    if axis_name is not None:
        raise MXNetError("BatchNorm: axis_name (SyncBatchNorm) is not "
                         "ported")
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


@register("BatchNorm_v1")
def batch_norm_v1(x, gamma, beta, moving_mean, moving_var, **attrs):
    """The legacy name: BatchNorm's semantics."""
    return batch_norm(x, gamma, beta, moving_mean, moving_var, **attrs)


@register("LayerNorm")
def layer_norm(x, gamma, beta, *, axis=-1, eps=1e-5, output_mean_var=False):
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
        out = (xa * a + (b - mean * a)).to(x.dtype)
    else:
        var = (xa - mean).square().mean(dim=axis, keepdim=True)
        out = ((xa - mean) * torch.rsqrt(var + eps) * g + b).to(x.dtype)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


def _channel_shape(x, axis=1):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


@register("RMSNorm")
def rms_norm(x, gamma, *, axis=-1, eps=1e-6):
    xa = x.float()
    ms = xa.square().mean(dim=axis, keepdim=True)
    return (xa * torch.rsqrt(ms + eps) *
            gamma.float().reshape(_channel_shape(x, axis))).to(x.dtype)


@register("GroupNorm")
def group_norm(x, gamma, beta, *, num_groups=1, eps=1e-5,
               output_mean_var=False):
    n, c = x.shape[:2]
    xa = x.float().reshape((n, num_groups, c // num_groups) + x.shape[2:])
    red = tuple(range(2, xa.dim()))
    mean = xa.mean(dim=red, keepdim=True)
    var = (xa - mean).square().mean(dim=red, keepdim=True)
    out = ((xa - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = _channel_shape(x)
    return (out * gamma.float().reshape(shape) +
            beta.float().reshape(shape)).to(x.dtype)


@register("InstanceNorm")
def instance_norm(x, gamma, beta, *, eps=1e-3):
    xa = x.float()
    red = tuple(range(2, x.dim()))
    mean = xa.mean(dim=red, keepdim=True)
    var = (xa - mean).square().mean(dim=red, keepdim=True)
    shape = _channel_shape(x)
    return ((xa - mean) * torch.rsqrt(var + eps) *
            gamma.float().reshape(shape) +
            beta.float().reshape(shape)).to(x.dtype)


@register("L2Normalization")
def l2_normalization(x, *, eps=1e-10, mode="instance"):
    if mode == "instance":
        norm = torch.sqrt(x.square().reshape(x.shape[0], -1).sum(1) + eps)
        return x / norm.reshape((-1,) + (1,) * (x.dim() - 1))
    if mode == "channel":
        return x / torch.sqrt(x.square().sum(1, keepdim=True) + eps)
    if mode == "spatial":
        norm = torch.sqrt(x.square().reshape(x.shape[0], x.shape[1], -1)
                          .sum(2) + eps)
        return x / norm.reshape(x.shape[:2] + (1,) * (x.dim() - 2))
    raise ValueError(mode)


@register("LRN")
def lrn(x, *, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels."""
    half = nsize // 2
    padded = F.pad(x.square(), [0, 0] * (x.dim() - 2) + [half, half])
    acc = padded[:, 0:x.shape[1]]
    for i in range(1, nsize):
        acc = acc + padded[:, i:i + x.shape[1]]
    return x / torch.pow(knorm + alpha / nsize * acc, beta)


# ---------------------------------------------------------------------------
# Dropout, Embedding
# ---------------------------------------------------------------------------
@register("Dropout", random=True)
def dropout(x, *, p=0.5, mode="training", axes=(), training=False,
            cudnn_off=False, generator=None, device=None):
    """Inverted dropout: in training mode each element (each slice along
    ``axes``, which share a mask) is kept with probability 1 - p and
    divided by 1 - p; else the identity. The mask is drawn from
    ``generator`` in float32, as the reference's bernoulli is in x's
    dtype: keep where u >= p."""
    if not training or p <= 0:
        return x
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return x * (keep.to(x.dtype) / (1.0 - p))


@register("Embedding")
def embedding(indices, weight, *, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` at ``indices`` (any numeric dtype; negative ones
    count from the end). With ``sparse_grad`` the weight's gradient is
    row-sparse: a sparse COO tensor holding one row per index, in the
    indices' order (a ``RowSparseNDArray`` in a row-sparse buffer)."""
    idx = indices.to(torch.int32).long() if indices.is_floating_point() \
        else indices.long()
    idx = torch.where(idx < 0, idx + weight.shape[0], idx)
    return F.embedding(idx, weight, sparse=bool(sparse_grad))


@register("_contrib_SparseEmbedding")
def sparse_embedding(indices, weight, *, input_dim=0, output_dim=0,
                     dtype="float32", deterministic=False, **legacy_attrs):
    """The deprecated contrib SparseEmbedding: Embedding with
    ``sparse_grad=True`` (legacy attributes such as ``deterministic`` are
    accepted and ignored)."""
    return embedding(indices, weight, input_dim=input_dim,
                     output_dim=output_dim, dtype=dtype, sparse_grad=True)


# ---------------------------------------------------------------------------
# the RNN op (rnn-inl.h): one flat parameter vector, layers in sequence
# ---------------------------------------------------------------------------
_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, num_layers, input_size, hidden, bidirectional):
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden * d
        size += d * (g * hidden * in_sz + g * hidden * hidden + 2 * g * hidden)
    return size


def rnn_unpack_params(params, mode, num_layers, input_size, hidden,
                      bidirectional):
    """Views of the flat vector in the reference's layout: every layer's
    and direction's wx (G*H, in) and wh (G*H, H) first, layer-major and
    direction-minor, then every bx and bh (G*H,). Gate order i, f, g, o
    for LSTM; r, z, n for GRU."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    off = 0

    def take(n, shape):
        nonlocal off
        v = params[off:off + n].reshape(shape)
        off += n
        return v
    weights = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden * d
        for _ in range(d):
            wx = take(g * hidden * in_sz, (g * hidden, in_sz))
            wh = take(g * hidden * hidden, (g * hidden, hidden))
            weights.append((wx, wh))
    biases = [(take(g * hidden, (g * hidden,)), take(g * hidden,
                                                     (g * hidden,)))
              for _ in range(num_layers * d)]
    return [(wx, wh, bx, bh) for (wx, wh), (bx, bh) in zip(weights, biases)]


def _rnn_layer(mode, x, h, c, wx, wh, bx, bh, reverse):
    """One layer in one direction: x (T, N, I) -> (T, N, H), hT, cT."""
    if reverse:
        x = torch.flip(x, dims=(0,))
    gx_all = torch.matmul(x, wx.t()) + bx          # all T steps at once
    ys = []
    for t in range(x.shape[0]):
        gx = gx_all[t]
        gh = torch.matmul(h, wh.t()) + bh
        if mode == "lstm":
            i, f, gg, o = (gx + gh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            rx, zx, nx = gx.chunk(3, dim=-1)
            rh, zh, nh = gh.chunk(3, dim=-1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        elif mode == "rnn_tanh":
            h = torch.tanh(gx + gh)
        else:
            h = torch.relu(gx + gh)
        ys.append(h)
    ys = torch.stack(ys) if ys else x.new_zeros((0,) + h.shape)
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys, h, c


@register("RNN")
def rnn(x, params, state, state_cell=None, *, state_size=0, num_layers=1,
        bidirectional=False, mode="lstm", p=0.0, state_outputs=True,
        projection_size=None, use_sequence_length=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None):
    """The fused RNN op: x (T, N, I), the flat ``params``, ``state``
    (L*D, N, H) and, for LSTM, ``state_cell``; returns (out, hT, cT) for
    LSTM, else (out, hT). As in the reference, ``p`` (inter-layer dropout),
    ``projection_size``, ``use_sequence_length`` and the LSTM state clips
    are accepted and not applied."""
    T, N, I = x.shape
    H = state_size
    d = 2 if bidirectional else 1
    layers = rnn_unpack_params(params, mode, num_layers, I, H, bidirectional)
    hs, cs = [], []
    inp = x
    for layer in range(num_layers):
        outs = []
        for direction in range(d):
            li = layer * d + direction
            h0 = state[li]
            c0 = state_cell[li] if mode == "lstm" and state_cell is not None \
                else torch.zeros_like(h0)
            ys, hT, cT = _rnn_layer(mode, inp, h0, c0, *layers[li],
                                    reverse=direction == 1)
            outs.append(ys)
            hs.append(hT)
            cs.append(cT)
        inp = torch.cat(outs, dim=-1) if d == 2 else outs[0]
    if mode == "lstm":
        return inp, torch.stack(hs), torch.stack(cs)
    return inp, torch.stack(hs)


# ---------------------------------------------------------------------------
# the fork's transformer ops (contrib/transformer.cc)
# ---------------------------------------------------------------------------
def _heads_of(x, L, N, heads, parts, D):
    """(L, N, heads * parts * D) interleaved per head -> per part
    (N, heads, L, D)."""
    y = x.reshape(L, N, heads, parts, D)
    return [y[:, :, :, i].permute(1, 2, 0, 3) for i in range(parts)]


def _scores(q, k, dtype):
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) \
        .to(dtype)


@register("_contrib_interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(qkv, *, heads):
    """(L, N, 3*H*D) interleaved per head -> (N*heads, L, L) scaled QK^T."""
    L, N, E = qkv.shape
    q, k, _ = _heads_of(qkv, L, N, heads, 3, E // (3 * heads))
    return _scores(q, k, qkv.dtype).reshape(N * heads, L, L)


def _att_values(att, v, heads, dtype):
    N, _, Lk, D = v.shape
    a = att.reshape(N, heads, -1, Lk)
    out = torch.matmul(a.float(), v.float()).to(dtype)
    return out.permute(2, 0, 1, 3).reshape(-1, N, heads * D)


@register("_contrib_interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(qkv, att, *, heads):
    """att (N*heads, L, L) -> (L, N, H*D)."""
    L, N, E = qkv.shape
    _, _, v = _heads_of(qkv, L, N, heads, 3, E // (3 * heads))
    return _att_values(att, v, heads, qkv.dtype)


@register("_contrib_interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(q, kv, *, heads):
    Lq, N, HD = q.shape
    D = HD // heads
    qh = q.reshape(Lq, N, heads, D).permute(1, 2, 0, 3)
    kh, _ = _heads_of(kv, kv.shape[0], N, heads, 2, D)
    return _scores(qh, kh, q.dtype).reshape(N * heads, Lq, kv.shape[0])


@register("_contrib_interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(kv, att, *, heads):
    Lk, N, HD2 = kv.shape
    _, vh = _heads_of(kv, Lk, N, heads, 2, HD2 // (2 * heads))
    return _att_values(att, vh, heads, kv.dtype)


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(x):
    """x / sqrt(last dim)."""
    return x / math.sqrt(x.shape[-1])


@register("multi_head_attention")
def multi_head_attention(q, k, v, mask=None, *, heads: int = 1,
                         dropout: float = 0.0, causal: bool = False,
                         use_flash=None):
    """Batched SDPA over q/k/v of shape (N, L, H*D).

    An unmasked call with Lq == Lk goes to :func:`flash_attention` (the
    hand-written kernels, K1 forward and K2 + K3 backward, on a CUDA tensor;
    their plain versions on a CPU one) with the (N, H, L, D) views of q, k
    and v as they are (the split QKV projection, read in place by K1), and
    K1's output is (N, L, H, D) memory, so the result is a view too;
    unmasked Lq != Lk, or ``use_flash=False``, takes the dense path; a
    ``mask`` (broadcastable to (N, H, Lq, Lk), nonzero = attend) takes the
    masked composite. ``dropout`` is accepted and, as in the reference, not
    applied.

    ``causal=True`` is **bottom-right aligned** when Lq != Lk: query row i
    attends keys ``j <= i + (Lk - Lq)``, so the last query row sees every
    key; for Lq == Lk it is plain ``tril``."""
    N, Lq, HD = q.shape
    D = HD // heads
    qh = q.reshape(N, Lq, heads, D).transpose(1, 2)
    kh = k.reshape(N, -1, heads, D).transpose(1, 2)
    vh = v.reshape(N, -1, heads, D).transpose(1, 2)
    Lk = kh.shape[2]
    if mask is None and Lq == Lk and use_flash is not False:
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


@register("flash_attention")
def flash_attention_op(q, k, v, *, causal=False, sm_scale=None, block_q=None,
                       block_k=None, interpret=None):
    """The registry op over (B, H, S, D): :func:`flash_attention`, which
    runs the hand-written K1 forward (K2 + K3 backward) on a CUDA tensor
    and their plain versions on a CPU one; Lq != Lk and head dims other than
    32, 64 and 128 take the dense path on every device. The reference's
    Pallas tiling (``block_q``, ``block_k``) and its ``interpret`` switch
    are accepted and ignored: the kernels choose their own tiles."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


register("single_query_attention")(single_query_attention)


# ---------------------------------------------------------------------------
# spatial transformer family (spatial_transformer.cc, grid_generator.cc,
# bilinear_sampler.cc) and the correlation layer (correlation.cc)
# ---------------------------------------------------------------------------
@register("GridGenerator")
def grid_generator(data, *, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid (N, 2, H, W) of (x, y) in [-1, 1]: "affine" maps the
    identity grid of ``target_shape`` by data's (N, 6) matrices; "warp"
    adds data's (N, 2, H, W) pixel flow, normalized, to the identity."""
    h, w = target_shape
    if transform_type == "affine":
        if h <= 0 or w <= 0:
            raise ValueError("GridGenerator(affine) requires a positive "
                             f"target_shape, got {target_shape}")
        n = data.shape[0]
        theta = data.reshape(n, 2, 3).float()
        gy, gx = torch.meshgrid(
            torch.linspace(-1.0, 1.0, h, device=data.device),
            torch.linspace(-1.0, 1.0, w, device=data.device), indexing="ij")
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)])   # (3, H*W)
        out = torch.einsum("nij,jp->nip", theta, base)
        return out.reshape(n, 2, h, w).to(data.dtype)
    if transform_type == "warp":
        _, _, fh, fw = data.shape
        gy, gx = torch.meshgrid(
            torch.linspace(-1.0, 1.0, fh, device=data.device),
            torch.linspace(-1.0, 1.0, fw, device=data.device), indexing="ij")
        norm = torch.stack([data[:, 0] * 2.0 / max(fw - 1, 1),
                            data[:, 1] * 2.0 / max(fh - 1, 1)], dim=1)
        return (torch.stack([gx, gy])[None] + norm).to(data.dtype)
    raise ValueError(f"GridGenerator: unknown transform_type "
                     f"{transform_type!r}")


@register("BilinearSampler")
def bilinear_sampler(data, grid, *, cudnn_off=False):
    """data (N, C, H, W) sampled at grid (N, 2, OH, OW) of normalized
    (x, y) in [-1, 1], each corner zero outside the image."""
    from .contrib import bilinear_sample_nchw
    n, c, h, w = data.shape
    oh, ow = grid.shape[2], grid.shape[3]
    px = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    py = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    got = bilinear_sample_nchw(data.float(), py.reshape(n, -1).float(),
                               px.reshape(n, -1).float())
    return got.reshape(n, oh, ow, c).permute(0, 3, 1, 2).to(data.dtype)


@register("SpatialTransformer")
def spatial_transformer(data, loc, *, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """The spatial transformer head: a grid from the localization output,
    then bilinear sampling."""
    if sampler_type != "bilinear":
        raise ValueError("SpatialTransformer: only sampler_type='bilinear' "
                         f"is supported (got {sampler_type!r})")
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=tuple(target_shape))
    return bilinear_sampler(data, grid)


@register("Correlation")
def correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation: for each displacement (dy, dx) of a
    (2 max_displacement / stride2 + 1)^2 grid, the product (or absolute
    difference) of the padded maps summed over channels and a
    kernel_size^2 window (stride1), over kernel_size^2 C."""
    b, c, h, w = data1.shape
    md = max_displacement
    p = pad_size
    f1 = F.pad(data1.float(), (p, p, p, p))
    f2 = F.pad(data2.float(), (p + md,) * 4)
    hp, wp = h + 2 * p, w + 2 * p
    maps = []
    for dy in range(-md, md + 1, stride2):
        for dx in range(-md, md + 1, stride2):
            shifted = f2[:, :, md + dy:md + dy + hp, md + dx:md + dx + wp]
            m = f1 * shifted if is_multiply else (f1 - shifted).abs()
            maps.append(m.sum(dim=1))
    core = torch.stack(maps, dim=1)[:, :, md:hp - md, md:wp - md]
    k = kernel_size
    summed = core.unfold(2, k, stride1).unfold(3, k, stride1).sum((-1, -2))
    return (summed / float(k * k * c)).to(data1.dtype)


# ---------------------------------------------------------------------------
# CTC loss (nn/ctc_loss.cc)
# ---------------------------------------------------------------------------
_NEG_INF = -1e30


def _shift(a, n):
    """``a`` shifted right by n along the last axis, -1e30 filled."""
    return torch.cat([a.new_full(a.shape[:-1] + (n,), _NEG_INF),
                      a[..., :-n]], dim=-1)


@register("CTCLoss")
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC's negative log-likelihood per sequence by the log-alpha
    recursion: data (T, N, C) unnormalised, label (N, L) classes, blank 0
    (``blank_label="first"``) or C - 1 ("last"); label entries < 0 or equal
    to the blank are padding unless ``label_lengths`` are used."""
    T, N, C = data.shape
    L = label.shape[1]
    logp = torch.log_softmax(data.float(), dim=-1)
    blank = 0 if blank_label == "first" else C - 1
    lab = label.to(torch.int32).long()
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.long, device=data.device)
    ext[:, 1::2] = lab
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(torch.int32).long()
    else:
        lab_len = ((lab != blank) & (lab >= 0)).sum(1)
    if use_data_lengths and data_lengths is not None:
        dat_len = data_lengths.to(torch.int32).long()
    else:
        dat_len = torch.full((N,), T, dtype=torch.long, device=data.device)
    ext_idx = torch.where(ext < 0, ext + C, ext)     # numpy's negatives
    alpha = data.new_full((N, S), _NEG_INF, dtype=torch.float32)
    alpha = torch.cat([logp[0, :, blank:blank + 1],
                       torch.gather(logp[0], 1, ext_idx[:, 1:2]),
                       alpha[:, 2:]], dim=1)
    same = torch.cat([torch.zeros(N, 2, dtype=torch.bool,
                                  device=data.device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    for t in range(1, T):
        a2 = _shift(alpha, 1)
        a3 = _shift(alpha, 2).masked_fill(same, _NEG_INF)
        m = torch.maximum(torch.maximum(alpha, a2), a3)
        new = m + torch.log(torch.exp(alpha - m) + torch.exp(a2 - m) +
                            torch.exp(a3 - m) + 1e-37)
        new = new + torch.gather(logp[t], 1, ext_idx)
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    last = 2 * lab_len
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, (last - 1).clamp_min(0)[:, None])[:, 0]
    m = torch.maximum(a_last, a_prev)
    ll = m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))
    return (-ll).to(data.dtype)


# ---------------------------------------------------------------------------
# the legacy output heads: forward an activation of the data, the gradient
# w.r.t. data defined by the head (the incoming gradient is ignored)
# ---------------------------------------------------------------------------
class _Regression(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        lb = label.reshape(out.shape).to(out.dtype)
        num_output = out.numel() // out.shape[0] if out.dim() > 0 else 1
        res = torch.sign(out - lb) if ctx.kind == "mae" else out - lb
        return (res * (ctx.grad_scale / num_output)).to(out.dtype), None, \
            None, None


@register("LinearRegressionOutput")
def linear_regression_output(data, label, *, grad_scale=1.0):
    return _Regression.apply(data, label, "linear", grad_scale)


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, *, grad_scale=1.0):
    return _Regression.apply(data, label, "logistic", grad_scale)


@register("MAERegressionOutput")
def mae_regression_output(data, label, *, grad_scale=1.0):
    return _Regression.apply(data, label, "mae", grad_scale)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(x)
        ctx.attrs = (grad_scale, valid_thresh, normalization)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.attrs
        scale = torch.tensor(grad_scale, dtype=torch.float32,
                             device=x.device)
        if normalization == "batch":
            scale = scale / x.shape[0]
        elif normalization == "valid":
            scale = scale / torch.clamp(
                (x > valid_thresh).sum().float(), min=1.0)
        return scale.to(x.dtype).expand(x.shape).clone(), None, None, None


@register("MakeLoss")
def make_loss(data, *, grad_scale=1.0, valid_thresh=0.0,
              normalization="null", **legacy_attrs):
    """Any expression as a loss head: forward identity; the gradient is
    ``grad_scale``, divided by the batch size ("batch") or by
    count(data > valid_thresh) ("valid")."""
    return _MakeLoss.apply(data, grad_scale, valid_thresh, normalization)


@register("make_loss")
def make_loss_alias(data, **attrs):
    return make_loss(data, **attrs)


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, label, margin, reg, use_linear):
        ctx.save_for_backward(x, label)
        ctx.attrs = (margin, reg, use_linear)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        xa = x.float()
        oh = one_hot(label, depth=x.shape[-1])
        if use_linear:
            d_true = -reg * (margin > xa).float()
            d_other = reg * (margin > -xa).float()
        else:
            d_true = -2.0 * reg * torch.clamp(margin - xa, min=0.0)
            d_other = 2.0 * reg * torch.clamp(margin + xa, min=0.0)
        dx = oh * d_true + (1.0 - oh) * d_other
        return dx.to(x.dtype), None, None, None, None


@register("SVMOutput")
def svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """One-vs-all hinge-loss head: forward identity, the gradient the
    L2-SVM (default) or L1-SVM subgradient (``svm_output.cc``)."""
    return _SVMOutput.apply(data, label, margin,
                            float(regularization_coefficient), use_linear)
