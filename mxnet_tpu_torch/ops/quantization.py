"""Quantization ops of the port: the counterparts of
``mxnet_tpu/ops/quantization.py`` (MXNet's ``quantize_v2.cc``,
``dequantize.cc``, ``requantize.cc``, ``quantized_fully_connected.cc``,
``quantized_conv.cc``, ``calibrate.cc`` and the quantized data-movement
ops), registered under the reference's names with
``differentiable=False``.

int8 is zero-centred (scale = 127 / max(|min|, |max|)), uint8 affine over
[min, max]. Ranges travel as 0-d float32 tensors on the data's device, and
every constant an op divides by or multiplies with is a 0-d tensor on that
device too (:func:`_const`, made once per value and device): PyTorch's
CUDA division by a host scalar multiplies by its reciprocal, which rounds
differently from the reference's division. Each op keeps the reference's
float32 operation order (``127 / amax``, then ``x * scale``; round half to
even; clip; cast; the 1e-12 floors), so its codes, int32 accumulators and
ranges are the reference's bit for bit on the same float32 inputs.

The int8 products are library calls, as the reference's are
(``lax.dot_general`` / ``lax.conv_general_dilated`` with an int32 result):
on the card ``torch._int_mm`` (cuBLASLt's int8 GEMM with int32
accumulation) over operands padded with zeros to the shapes it takes (more
than 16 rows, K and N multiples of 8: zeros add nothing, so the result is
exact); on the CPU an int32 ``torch.mm``, exact too. A convolution is
im2col of the int8 codes (a strided view of the padded channels-last
codes, copied once) and that product, one product per group; its int32
result keeps channels-last memory. Nothing accumulates in float: codes up
to 127 * 127 * K pass 2^24 for K > 1,040.

``calibrate_entropy`` is host numpy code, the reference's own algorithm;
the registered op returns its threshold and divergence as 0-d float32
arrays.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as onp
import torch
import torch.nn.functional as F

from .nn import pooling
from .registry import register

__all__ = ["INT8_QMAX", "INT32_QMAX", "INT32_SPAN_RATIO", "quantize_v2",
           "dequantize", "requantize", "quantized_fully_connected",
           "quantized_conv", "dequantize_accum", "calibrate_entropy",
           "quantized_pooling", "quantized_act", "quantized_flatten",
           "quantized_concat", "quantized_elemwise_add", "quantize",
           "quantized_batch_norm", "quantized_elemwise_mul",
           "quantized_embedding", "int8_matmul", "int8_conv"]

INT8_QMAX = 127.0
INT32_QMAX = 2147483647.0
# int32 accumulator convention (quantization_utils.h): a tensor of int32
# codes carries a range spanning the full int32 grid, real = acc * amax /
# INT32_QMAX; producers whose codes live on a 127 * 127 grid scale their
# carried range by INT32_SPAN_RATIO.
INT32_SPAN_RATIO = INT32_QMAX / (INT8_QMAX * INT8_QMAX)

_F32 = torch.float32
_CONSTS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _const(v: float, device) -> torch.Tensor:
    """``v`` rounded to a 0-d float32 tensor on ``device`` (cached: one
    fill per value and device, none per call)."""
    key = (float(v), torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.full((), float(v), dtype=_F32, device=device)
        _CONSTS[key] = t
    return t


def _f32(v, device) -> torch.Tensor:
    """A range (tensor, NDArray data or number) as float32 on ``device``
    (the reference's ``jnp.asarray(v, float32)``; shape kept)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=_F32)
    return _const(v, device)


def _amax(mn, mx):
    return torch.maximum(mn.abs(), mx.abs())


def _codes(x, scale, lo, hi, dtype):
    """clip(round(x * scale), lo, hi) cast to ``dtype``."""
    return torch.clamp(torch.round(x * scale), lo, hi).to(dtype)


# ---------------------------------------------------------------------------
# quantize / dequantize / requantize
# ---------------------------------------------------------------------------
@register("_contrib_quantize_v2", differentiable=False)
def quantize_v2(data, *, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """float32 -> int8 (zero-centred) or uint8 (affine) codes with
    ``(q, min_range, max_range)``; without calibrated ranges the data's
    own min and max are used."""
    x = data.to(_F32)
    dev = x.device
    if min_calib_range is None or max_calib_range is None:
        mn, mx = torch.amin(x), torch.amax(x)
    else:
        mn, mx = _f32(min_calib_range, dev), _f32(max_calib_range, dev)
    if out_type == "int8":
        amax = torch.clamp_min(_amax(mn, mx), 1e-12)
        scale = torch.div(_const(INT8_QMAX, dev), amax)
        return (_codes(x, scale, -INT8_QMAX, INT8_QMAX, torch.int8),
                -amax, amax)
    if out_type == "uint8":
        rng = torch.clamp_min(mx - mn, 1e-12)
        scale = torch.div(_const(255.0, dev), rng)
        return _codes(x - mn, scale, 0, 255, torch.uint8), mn.clone(), \
            mx.clone()
    raise ValueError(f"unsupported out_type {out_type}")


@register("_contrib_dequantize", differentiable=False)
def dequantize(data, min_range, max_range, *, out_type="float32"):
    """int8 / uint8 codes or an int32 accumulator -> float32 by the
    carried range."""
    dev = data.device
    mn, mx = _f32(min_range, dev), _f32(max_range, dev)
    if data.dtype == torch.int8:
        return data.to(_F32) * torch.div(_amax(mn, mx),
                                         _const(INT8_QMAX, dev))
    if data.dtype == torch.uint8:
        return data.to(_F32) * torch.div(mx - mn, _const(255.0, dev)) + mn
    if data.dtype == torch.int32:
        return data.to(_F32) * torch.div(_amax(mn, mx),
                                         _const(INT32_QMAX, dev))
    raise ValueError(f"dequantize: unsupported input dtype {data.dtype}")


@register("_contrib_requantize", differentiable=False)
def requantize(data, min_range, max_range, *, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8: calibrated ranges fix the output scale,
    else the dequantized values' own extrema do."""
    real = dequantize(data, min_range, max_range)
    return quantize_v2(real, out_type="int8",
                       min_calib_range=min_calib_range,
                       max_calib_range=max_calib_range)


# ---------------------------------------------------------------------------
# the int8 products
# ---------------------------------------------------------------------------
def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (M, K) int8 times ``w`` (N, K) int8 transposed, as (M, N)
    int32: ``torch._int_mm`` on the card over zero-padded operands, an
    int32 ``torch.mm`` on the CPU. Exact either way."""
    M, K = a.shape
    N = w.shape[0]
    if a.device.type != "cuda":
        return torch.mm(a.to(torch.int32), w.to(torch.int32).t())
    Mp, Kp, Np = (M if M > 16 else 32), _up8(K), _up8(N)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w = F.pad(w, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out if (Mp, Np) == (M, N) else out[:M, :N]


def _im2col(xcl, kernel, stride, dilate):
    """(N * out..., prod(kernel) * C) int8 rows of the channels-last
    padded codes ``xcl`` (N, *spatial, C): a strided view, copied once.
    Returns (rows, out spatial shape)."""
    nd = len(kernel)
    sizes = xcl.shape[1:1 + nd]
    out = tuple((sizes[i] - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
                for i in range(nd))
    st = xcl.stride()
    view = xcl.as_strided(
        (xcl.shape[0],) + out + tuple(kernel) + (xcl.shape[-1],),
        (st[0],) + tuple(st[1 + i] * stride[i] for i in range(nd))
        + tuple(st[1 + i] * dilate[i] for i in range(nd)) + (st[-1],),
        xcl.storage_offset())
    rows = xcl.shape[0] * math.prod(out)
    return view.reshape(rows, math.prod(kernel) * xcl.shape[-1]), out


def int8_conv(x, weight, stride, pad, dilate, groups=1):
    """N-d convolution of int8 codes ``x`` (N, C, *spatial) by int8
    ``weight`` (O, C / groups, *kernel) with an int32 result (N, O,
    *out) in channels-last memory: im2col, then :func:`int8_matmul` per
    group."""
    nd = x.dim() - 2
    kernel = tuple(weight.shape[2:])
    N, C = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xcl = x.permute(0, *range(2, 2 + nd), 1)
    if any(pad):
        padded = x.new_zeros((N,) + tuple(s + 2 * p for s, p in
                                          zip(spatial, pad)) + (C,))
        padded[(slice(None),) + tuple(slice(p, p + s) for p, s in
                                      zip(pad, spatial))] = xcl
        xcl = padded
    # without padding the codes are read in place: a 1x1 convolution at
    # stride 1 over channels-last codes is their (N * H * W, C) view
    # weight rows in the patches' (kernel..., channel) order
    wrows = weight.permute(0, *range(2, 2 + nd), 1).reshape(
        weight.shape[0], -1)
    cg, og = C // groups, weight.shape[0] // groups
    outs, out_sp = [], None
    for g in range(groups):
        rows, out_sp = _im2col(xcl[..., g * cg:(g + 1) * cg], kernel,
                               stride, dilate)
        outs.append(int8_matmul(rows, wrows[g * og:(g + 1) * og]))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    acc = acc.reshape((N,) + out_sp + (weight.shape[0],))
    return acc.permute(0, nd + 1, *range(1, nd + 1))


def _out_range(min_x, max_x, min_w, max_w, dev):
    amax_x = _amax(_f32(min_x, dev), _f32(max_x, dev))
    amax_w = _amax(_f32(min_w, dev), _f32(max_w, dev))
    out = amax_x * amax_w * _const(INT32_SPAN_RATIO, dev)
    return -out, out


@register("_contrib_quantized_fully_connected", differentiable=False)
def quantized_fully_connected(x, weight, min_x, max_x, min_w, max_w, *,
                              num_hidden=0, flatten=True):
    """int8 x (..., K) times int8 w (M, K) -> int32 (..., M), and the
    output's int32-span range. The bias is added at the dequantized
    boundary (the Gluon layer)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    lead = x.shape[:-1]
    acc = int8_matmul(x.reshape(-1, x.shape[-1]), weight)
    return (acc.reshape(lead + (weight.shape[0],)),
            *_out_range(min_x, max_x, min_w, max_w, x.device))


def _tup(v, n, default):
    if v is None:
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t * n


@register("_contrib_quantized_conv", differentiable=False)
def quantized_conv(x, weight, min_x, max_x, min_w, max_w, *, kernel=None,
                   stride=None, dilate=None, pad=None, num_filter=0,
                   num_group=1, layout=None):
    """int8 NC... convolution -> int32 accumulator and its range."""
    nd = x.dim() - 2
    acc = int8_conv(x, weight, _tup(stride, nd, 1), _tup(pad, nd, 0),
                    _tup(dilate, nd, 1), int(num_group))
    return (acc, *_out_range(min_x, max_x, min_w, max_w, x.device))


def dequantize_accum(acc, min_x, max_x, min_w, max_w):
    """int32 accumulator -> float32: acc * (amax_x / 127) * (amax_w /
    127)."""
    dev = acc.device
    q = _const(INT8_QMAX, dev)
    amax_x = _amax(_f32(min_x, dev), _f32(max_x, dev))
    amax_w = _amax(_f32(min_w, dev), _f32(max_w, dev))
    inv = torch.div(amax_x, q) * torch.div(amax_w, q)
    # int32 times a float32 0-d tensor: the product in float32 after the
    # same int -> float32 conversion, in one pass
    return torch.mul(acc, inv)


# ---------------------------------------------------------------------------
# entropy calibration (calibrate.cc CalibrateEntropy): host numpy
# ---------------------------------------------------------------------------
def calibrate_entropy(hist, hist_edges, *, num_quantized_bins=255):
    """The KL-divergence-optimal threshold of an activation histogram
    (calibrate.cc, the TensorRT algorithm): ``(threshold, divergence)`` as
    Python floats."""
    hist = onp.asarray(hist, onp.float32)
    hist_edges = onp.asarray(hist_edges, onp.float32)
    num_bins = hist.size
    zero_bin = num_bins // 2
    num_half_quantized_bins = num_quantized_bins // 2

    best_div = onp.inf
    best_thresh = float(hist_edges[-1])
    for i in range(num_half_quantized_bins, zero_bin + 1):
        p_start, p_stop = zero_bin - i, zero_bin + i + 1
        thresh = float(hist_edges[p_stop]) if p_stop < hist_edges.size \
            else float(hist_edges[-1])
        sliced = hist[p_start:p_stop].copy()
        p = sliced.copy()
        # outliers clip into the edge bins
        p[0] += hist[:p_start].sum()
        p[-1] += hist[p_stop:].sum()
        is_nonzero = (p != 0).astype(onp.float32)

        # quantize p's support into num_quantized_bins, then expand back:
        # bin j spans [round(j f), round((j + 1) f)); each non-zero of it
        # gets the bin's sum over its non-zero count
        q = is_nonzero * _merged_bins(sliced, is_nonzero, num_quantized_bins)
        p = _smooth_distribution(p)
        q_sum = q.sum()
        if q_sum == 0:
            continue
        q = _smooth_distribution(q)
        p = p / p.sum()
        q = q / q.sum()
        div = float((p * onp.log(p / q)).sum())
        if div < best_div:
            best_div = div
            best_thresh = thresh
    return best_thresh, best_div


def _merged_bins(sliced, is_nonzero, num_quantized_bins):
    """Per element of ``sliced``: its quantized bin's sum / the bin's
    non-zero count (0 where the count is 0), float32 as the reference's
    loop computes it. The sums add whole counts, exact in float32 below
    2^24 in any order."""
    factor = sliced.size / num_quantized_bins
    edges = onp.round(onp.arange(num_quantized_bins + 1) * factor).astype(
        onp.int64)
    lo, hi = edges[:-1], edges[1:]
    full = hi > lo
    starts = lo[full]
    sums = onp.add.reduceat(sliced, starts).astype(onp.float32)
    norms = onp.add.reduceat(is_nonzero, starts).astype(onp.float32)
    vals = onp.zeros_like(sums)
    keep = norms != 0
    vals[keep] = sums[keep] / norms[keep]
    return onp.repeat(vals, (hi - lo)[full])


def _smooth_distribution(p, eps=0.0001):
    """Zeros become ``eps``, the mass taken from the non-zeros."""
    is_zeros = (p == 0).astype(onp.float32)
    is_nonzeros = (p != 0).astype(onp.float32)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        raise ValueError("all-zero distribution")
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    return p.astype(onp.float32) + eps * is_zeros - eps1 * is_nonzeros


@register("_contrib_calibrate_entropy", differentiable=False)
def _calibrate_entropy_op(hist, hist_edges, *, num_quantized_bins=255):
    """The registry op: :func:`calibrate_entropy` on the host, its two
    results as 0-d float32 tensors on the histogram's device."""
    th, div = calibrate_entropy(hist.detach().cpu().numpy(),
                                hist_edges.detach().cpu().numpy(),
                                num_quantized_bins=num_quantized_bins)
    return (torch.tensor(th, dtype=_F32, device=hist.device),
            torch.tensor(div, dtype=_F32, device=hist.device))


# ---------------------------------------------------------------------------
# quantized data movement and activation
# ---------------------------------------------------------------------------
_QRANGE = {torch.int8: (-128, 127), torch.uint8: (0, 255),
           torch.int32: (-2 ** 31, 2 ** 31 - 1)}


@register("_contrib_quantized_pooling", differentiable=False)
def quantized_pooling(x, min_x, max_x, **attrs):
    """Pooling of the codes, ranges passed through: max pools the codes
    as float32 (exact: the codes are, and max is monotone), avg pools in
    float32, then rounds and clips to the code type."""
    if attrs.get("pool_type", "max") == "max":
        out = pooling(x.to(_F32), **attrs).to(x.dtype)
    else:
        lo, hi = _QRANGE[x.dtype]
        out = torch.clamp(torch.round(pooling(x.to(_F32), **attrs)),
                          lo, hi).to(x.dtype)
    return out, min_x, max_x


@register("_contrib_quantized_act", differentiable=False)
def quantized_act(x, min_x, max_x, *, act_type="relu"):
    """ReLU in code space: int8 max(q, 0) with the ranges passed through;
    uint8 decoded, ReLU'd and re-encoded on [0, max(max, 0)]."""
    if act_type != "relu":
        raise ValueError("quantized_act supports act_type='relu' only "
                         f"(got {act_type!r})")
    if x.dtype == torch.int8:
        return torch.clamp_min(x, 0), min_x, max_x
    if x.dtype == torch.uint8:
        dev = x.device
        mn = _f32(min_x, dev).reshape(())
        mx = _f32(max_x, dev).reshape(())
        c255 = _const(255.0, dev)
        scale_old = torch.div(torch.clamp_min(mx - mn, 1e-12), c255)
        real = torch.clamp_min(x.to(_F32) * scale_old + mn, 0.0)
        new_max = torch.clamp_min(mx, 0.0)
        scale_new = torch.div(torch.clamp_min(new_max, 1e-12), c255)
        rq = torch.clamp(torch.round(torch.div(real, scale_new)), 0, 255)
        return rq.to(torch.uint8), _const(0.0, dev).clone(), new_max
    raise ValueError(f"quantized_act: unsupported code dtype {x.dtype}")


@register("_contrib_quantized_flatten", differentiable=False)
def quantized_flatten(x, min_x, max_x):
    return x.reshape(x.shape[0], -1), min_x, max_x


@register("_contrib_quantized_concat", differentiable=False)
def quantized_concat(*arrays, dim=1, num_args=0):
    """Concatenate int8 codes of different scales: each rescaled to the
    widest range first. Inputs (x0..xn-1, min0..minn-1, max0..maxn-1)."""
    n = len(arrays) // 3
    xs, mins, maxs = arrays[:n], arrays[n:2 * n], arrays[2 * n:]
    if any(x.dtype != torch.int8 for x in xs):
        raise ValueError("quantized_concat expects zero-centered int8 codes")
    dev = xs[0].device
    amaxs = [_amax(_f32(mn, dev), _f32(mx, dev))
             for mn, mx in zip(mins, maxs)]
    out_amax = amaxs[0]
    for a in amaxs[1:]:
        out_amax = torch.maximum(out_amax, a)
    scaled = [_codes(x.to(_F32), torch.div(a, out_amax), -INT8_QMAX,
                     INT8_QMAX, x.dtype) for x, a in zip(xs, amaxs)]
    return torch.cat(scaled, dim=dim), -out_amax, out_amax


@register("_contrib_quantized_elemwise_add", differentiable=False)
def quantized_elemwise_add(a, b, min_a, max_a, min_b, max_b):
    """int8 + int8 of independent scales onto one int32 grid, with the
    combined range (the sum of the two)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError("quantized_elemwise_add expects zero-centered int8")
    dev = a.device
    amax_a = _amax(_f32(min_a, dev), _f32(max_a, dev))
    amax_b = _amax(_f32(min_b, dev), _f32(max_b, dev))
    real_amax = amax_a + amax_b
    q = _const(INT8_QMAX, dev)
    ca = torch.round(torch.div(a.to(_F32) * amax_a * q, real_amax))
    cb = torch.round(torch.div(b.to(_F32) * amax_b * q, real_amax))
    out_amax = real_amax * _const(INT32_SPAN_RATIO, dev)
    return (ca + cb).to(torch.int32), -out_amax, out_amax


# ---------------------------------------------------------------------------
# quantize (v1): the range given as arrays
# ---------------------------------------------------------------------------
@register("_contrib_quantize", differentiable=False)
def quantize(data, min_range, max_range, *, out_type="uint8"):
    """float32 -> uint8 (affine over [min, max]) or int8 (zero-centred)
    with the range supplied as inputs."""
    x = data.to(_F32)
    dev = x.device
    mn = _f32(min_range, dev).reshape(())
    mx = _f32(max_range, dev).reshape(())
    if out_type == "uint8":
        scale = torch.div(_const(255.0, dev), torch.clamp_min(mx - mn, 1e-12))
        return _codes(x - mn, scale, 0, 255, torch.uint8), mn.clone(), \
            mx.clone()
    if out_type == "int8":
        amax = torch.clamp_min(_amax(mn, mx), 1e-12)
        scale = torch.div(_const(INT8_QMAX, dev), amax)
        return (_codes(x, scale, -INT8_QMAX, INT8_QMAX, torch.int8),
                -amax, amax)
    raise ValueError(f"unsupported out_type {out_type}")


# ---------------------------------------------------------------------------
# quantized batch norm: BN folded into a per-channel int8 -> int8 affine
# ---------------------------------------------------------------------------
@register("_contrib_quantized_batch_norm", differentiable=False)
def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         min_data, max_data, *, eps=1e-3,
                         min_calib_range=None, max_calib_range=None, axis=1):
    """out_q = q * [gamma invstd amax_in / amax_out] + [(beta - mean gamma
    invstd) 127 / amax_out], rounded and clipped; the output range is the
    calibrated one (required)."""
    if min_calib_range is None or max_calib_range is None:
        raise ValueError("quantized_batch_norm requires calibrated output "
                         "ranges (min_calib_range/max_calib_range) — the "
                         "output scale is static (quantized_batch_norm.cc)")
    dev = data.device
    amax_in = _amax(_f32(min_data, dev), _f32(max_data, dev))
    amax_out = max(abs(float(min_calib_range)), abs(float(max_calib_range)),
                   1e-12)
    invstd = torch.div(_const(1.0, dev),
                       torch.sqrt(moving_var.to(_F32) + eps))
    g = gamma.to(_F32)
    w = g * invstd * torch.div(amax_in, _const(amax_out, dev))
    # the reference divides two Python floats here (float64), then rounds
    b = (beta.to(_F32) - moving_mean.to(_F32) * g * invstd) \
        * _const(INT8_QMAX / amax_out, dev)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = data.to(_F32) * w.reshape(shape) + b.reshape(shape)
    q = torch.clamp(torch.round(out), -INT8_QMAX, INT8_QMAX).to(torch.int8)
    return q, _const(-amax_out, dev).clone(), _const(amax_out, dev).clone()


# ---------------------------------------------------------------------------
# quantized elementwise mul, quantized embedding
# ---------------------------------------------------------------------------
@register("_contrib_quantized_elemwise_mul", differentiable=False)
def quantized_elemwise_mul(lhs, rhs, min_lhs, max_lhs, min_rhs, max_rhs, *,
                           min_calib_range=None, max_calib_range=None,
                           enable_float_output=False):
    """int8 * int8: int32 codes with the int32-span range; requantized
    int8 with calibrated ranges; float32 with ``enable_float_output``."""
    dev = lhs.device
    amax_l = _amax(_f32(min_lhs, dev), _f32(max_lhs, dev))
    amax_r = _amax(_f32(min_rhs, dev), _f32(max_rhs, dev))
    acc = lhs.to(torch.int32) * rhs.to(torch.int32)
    if enable_float_output:
        q = _const(INT8_QMAX, dev)
        real = acc.to(_F32) * (torch.div(amax_l, q) * torch.div(amax_r, q))
        return real, -amax_l * amax_r, amax_l * amax_r
    out_amax = amax_l * amax_r * _const(INT32_SPAN_RATIO, dev)
    if min_calib_range is not None and max_calib_range is not None:
        return requantize(acc, -out_amax, out_amax,
                          min_calib_range=min_calib_range,
                          max_calib_range=max_calib_range)
    return acc, -out_amax, out_amax


@register("_contrib_quantized_embedding", differentiable=False)
def quantized_embedding(data, weight, min_weight, max_weight, *, input_dim=0,
                        output_dim=0, dtype="int8"):
    """Rows of the int8 codes ``weight`` at ``data``; the weight's range is
    the output's."""
    if input_dim and int(input_dim) != weight.shape[0]:
        raise ValueError(
            f"quantized_embedding: input_dim={input_dim} does not match "
            f"weight rows {weight.shape[0]}")
    idx = data.to(torch.int32).long()
    idx = torch.where(idx < 0, idx + weight.shape[0], idx)
    dev = weight.device
    return (F.embedding(idx, weight),
            _f32(min_weight, dev).reshape(()).clone(),
            _f32(max_weight, dev).reshape(()).clone())
