"""Image operators of the port (the counterpart of
``mxnet_tpu/ops/image_ops.py``): ``_image_to_tensor``, ``_image_normalize``,
``_image_resize``, ``_image_crop``, the flips and the colour ops, each a
plain PyTorch function over HWC or NHWC tensors, run on the tensor's
device (``nd.image`` on a card array runs on the card).

:func:`resize` is the one resize of the port: ``image.imresize``, this
module's ``_image_resize`` and the vision transforms all go through it. It
computes ``jax.image.resize``'s function: half-pixel centres; "linear"
weights of the triangle kernel, widened by the scale when shrinking
(antialiasing) and normalised per output pixel, applied as one product
per resized axis; "nearest" takes the input pixel at floor((i + 0.5) *
in / out) (torch's ``nearest-exact``, not ``nearest``), with in / out
rounded as XLA compiles it, so the indices are the JAX package's.

The random forms (``random=True``) draw their parameters with
``torch.rand``/``randn`` on the data's device from the generator
``invoke`` hands them (``random.generator(ctx)``). Each records what it
drew: :func:`last_draw` returns the calling thread's last draws as
tensors (a flip's uniform ``u``, flipped where ``u < 0.5``; a colour op's
``alpha``; the jitter's four; lighting's three), so the draw can be read
back and the deterministic function of it checked.
"""
from __future__ import annotations

import functools
import math
import threading

import torch

from .registry import register

__all__ = ["resize", "last_draw", "adjust_brightness", "adjust_contrast",
           "adjust_saturation", "adjust_hue", "adjust_lighting"]

# ITU-R BT.601 luma coefficients
_GRAY = (0.299, 0.587, 0.114)
# the YIQ pair of the hue rotation
_TYIQ = ((0.299, 0.587, 0.114),
         (0.596, -0.274, -0.321),
         (0.211, -0.523, 0.311))
_ITYIQ = ((1.0, 0.956, 0.621),
          (1.0, -0.272, -0.647),
          (1.0, -1.107, 1.705))
# AlexNet's PCA lighting tables
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))

_draws = threading.local()


def last_draw() -> dict:
    """The calling thread's last random image op's draws (tensors on the
    data's device)."""
    return dict(getattr(_draws, "last", {}))


def _note(**draws):
    _draws.last = draws


def _hwc_axes(x):
    """(h_axis, w_axis, c_axis) of 3-D HWC or 4-D NHWC input."""
    if x.dim() == 3:
        return 0, 1, 2
    if x.dim() == 4:
        return 1, 2, 3
    raise ValueError("image ops expect HWC or NHWC input, got ndim=%d"
                     % x.dim())


def _const(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the one resize
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1024)
def _linear_weights(m: int, n: int, device) -> torch.Tensor:
    """(m, n) f32 weights taking m input pixels to n outputs, as
    ``jax.image``'s ``compute_weight_mat`` builds them for the triangle
    kernel with antialiasing: sample positions, distances scaled by
    max(in/out, 1), each column normalised, columns sampling outside the
    input zeroed. Kept per (m, n, device): a random crop's sizes recur."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(n, dtype=f32, device=device) + 0.5) * inv_scale \
        - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32, device=device)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """The input pixel of each of n outputs: floor((i + 0.5) * m / n) as
    XLA compiles ``jax.image``'s nearest resize, with m / n folded into
    one float32 constant, m * (1 / n)."""
    f32 = torch.float32
    step = torch.tensor(m, dtype=f32) * (torch.tensor(1.0, dtype=f32)
                                         / torch.tensor(n, dtype=f32))
    offsets = (torch.arange(n, dtype=f32) + 0.5) * step
    return offsets.floor().long().to(device)


def resize(x: torch.Tensor, size, axes, method: str = "linear"):
    """``x`` with its axes ``axes`` (two of them, in order) resized to
    ``size`` = (h, w), in float32 (the caller casts back): the function of
    ``jax.image.resize(x.astype(f32), shape, method)``, ``method``
    "linear" (antialiased when shrinking) or "nearest". An axis whose
    size does not change is left as it is, as there."""
    x = x.to(torch.float32)
    for axis, n in zip(axes, size):
        m = x.shape[axis]
        n = int(n)
        if m == n:
            continue
        if method == "nearest":
            x = x.index_select(axis, _nearest_index(m, n, x.device))
            continue
        w = _linear_weights(m, n, x.device)
        x = torch.tensordot(x.movedim(axis, -1), w, dims=([x.dim() - 1],
                                                          [0]))
        x = x.movedim(-1, axis)
    return x


# ---------------------------------------------------------------------------
# the deterministic ops
# ---------------------------------------------------------------------------
@register("_image_to_tensor")
def to_tensor(data):
    """HWC [0, 255] -> CHW float32 [0, 1]; NHWC -> NCHW. The scaling is a
    product with float32(1 / 255), as XLA compiles the JAX package's
    division by the constant."""
    out = data.to(torch.float32) * torch.tensor(1.0 / 255.0,
                                                dtype=torch.float32)
    if data.dim() == 3:
        return out.permute(2, 0, 1)
    return out.permute(0, 3, 1, 2)


@register("_image_normalize")
def normalize(data, *, mean=(0.0,), std=(1.0,)):
    """(x - mean) / std over CHW or NCHW float input, per channel."""
    c = data.shape[0] if data.dim() == 3 else data.shape[1]
    m = torch.tensor(mean, dtype=data.dtype, device=data.device).expand(c)
    s = torch.tensor(std, dtype=data.dtype, device=data.device).expand(c)
    shape = (c, 1, 1) if data.dim() == 3 else (1, c, 1, 1)
    return (data - m.reshape(shape)) / s.reshape(shape)


def _target_hw(shape, ha, wa, size, keep_ratio):
    """(h, w) of ``_image_resize``: size (w, h), or one int for both, or
    with ``keep_ratio`` one int for the shorter edge."""
    single = isinstance(size, int) or len(size) == 1
    s0 = int(size) if isinstance(size, int) else int(size[0])
    if not single:
        return int(size[1]), s0
    if not keep_ratio:
        return s0, s0
    H, W = shape[ha], shape[wa]
    if H > W:
        return H * s0 // W, s0
    return s0, W * s0 // H


@register("_image_resize")
def resize_op(data, *, size=(0, 0), keep_ratio=False, interp=1):
    """Resize HWC/NHWC to size (w, h); interp 0 is nearest, any other
    bilinear; the result in the input's dtype (float to integer
    truncates)."""
    ha, wa, _ = _hwc_axes(data)
    h, w = _target_hw(data.shape, ha, wa, size, keep_ratio)
    out = resize(data, (h, w), (ha, wa),
                 "nearest" if interp == 0 else "linear")
    return out.to(data.dtype)


@register("_image_crop")
def crop(data, *, x=0, y=0, width=1, height=1):
    """The region (x, y, width, height) of HWC/NHWC input; a region past
    the image raises."""
    ha, wa, _ = _hwc_axes(data)
    H, W = data.shape[ha], data.shape[wa]
    if x < 0 or y < 0 or x + width > W or y + height > H:
        raise ValueError(
            f"crop region (x={x}, y={y}, w={width}, h={height}) out of "
            f"bounds for {H}x{W} image")
    return data.narrow(ha, y, height).narrow(wa, x, width)


@register("_image_flip_left_right")
def flip_left_right(data):
    return data.flip(_hwc_axes(data)[1])


@register("_image_flip_top_bottom")
def flip_top_bottom(data):
    return data.flip(_hwc_axes(data)[0])


def _uniform(lo, hi, generator, device):
    u = torch.rand((), generator=generator, device=device)
    return lo + u * (hi - lo)


def _maybe_flip(fn, data, generator, device):
    u = torch.rand((), generator=generator, device=device)
    _note(u=u)
    return torch.where(u < 0.5, fn(data), data)


@register("_image_random_flip_left_right", differentiable=False, random=True)
def random_flip_left_right(data, *, generator=None, device=None):
    return _maybe_flip(flip_left_right, data, generator, device)


@register("_image_random_flip_top_bottom", differentiable=False, random=True)
def random_flip_top_bottom(data, *, generator=None, device=None):
    return _maybe_flip(flip_top_bottom, data, generator, device)


# ---------------------------------------------------------------------------
# colour: the deterministic function of each draw
# ---------------------------------------------------------------------------
def adjust_brightness(data, alpha):
    return data.to(torch.float32) * alpha


def adjust_contrast(data, alpha):
    """Blend with each image's scalar gray mean (per image of a batch)."""
    ha, wa, ca = _hwc_axes(data)
    x = data.to(torch.float32)
    if data.shape[ca] >= 3:
        gray = (x[..., :3] * _const(_GRAY, x.device)).sum(-1)
        dims = (ha, wa)
    else:
        gray = x
        dims = (ha, wa, ca)
    if data.dim() == 4:
        mean = gray.mean(dim=dims, keepdim=True)
        if data.shape[ca] >= 3:
            mean = mean[..., None]
    else:
        mean = gray.mean()
    return x * alpha + (1.0 - alpha) * mean


def adjust_saturation(data, alpha):
    """Blend with each pixel's gray."""
    x = data.to(torch.float32)
    gray = (x * _const(_GRAY, x.device)).sum(-1, keepdim=True)
    return x * alpha + (1.0 - alpha) * gray


def adjust_hue(data, alpha):
    """Rotate the chroma by alpha * pi in YIQ space."""
    x = data.to(torch.float32)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    u = torch.cos(alpha * math.pi)
    w = torch.sin(alpha * math.pi)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    bt = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, u, -w]),
                      torch.stack([zero, w, u])])
    t = (_const(_ITYIQ, x.device) @ bt @ _const(_TYIQ, x.device)).T
    return x @ t


def _lighting_rgb(alpha, device):
    return (_const(_EIGVEC, device) * alpha) @ _const(_EIGVAL, device)


def adjust_lighting_fn(data, alpha):
    return data.to(torch.float32) + _lighting_rgb(alpha, data.device)


def _random_colour(fn, data, min_factor, max_factor, generator, device):
    alpha = _uniform(float(min_factor), float(max_factor), generator, device)
    _note(alpha=alpha)
    return fn(data, alpha)


@register("_image_random_brightness", differentiable=False, random=True)
def random_brightness(data, *, min_factor=0.0, max_factor=0.0,
                      generator=None, device=None):
    return _random_colour(adjust_brightness, data, min_factor, max_factor,
                          generator, device)


@register("_image_random_contrast", differentiable=False, random=True)
def random_contrast(data, *, min_factor=0.0, max_factor=0.0, generator=None,
                    device=None):
    return _random_colour(adjust_contrast, data, min_factor, max_factor,
                          generator, device)


@register("_image_random_saturation", differentiable=False, random=True)
def random_saturation(data, *, min_factor=0.0, max_factor=0.0,
                      generator=None, device=None):
    return _random_colour(adjust_saturation, data, min_factor, max_factor,
                          generator, device)


@register("_image_random_hue", differentiable=False, random=True)
def random_hue(data, *, min_factor=0.0, max_factor=0.0, generator=None,
               device=None):
    return _random_colour(adjust_hue, data, min_factor, max_factor,
                          generator, device)


@register("_image_random_color_jitter", differentiable=False, random=True)
def random_color_jitter(data, *, brightness=0.0, contrast=0.0,
                        saturation=0.0, hue=0.0, generator=None, device=None):
    """Brightness, contrast, saturation and hue jitter, each factor drawn
    1 + U(-p, p) (hue's U(-p, p)), in that fixed order, each only where
    its p > 0."""
    x = data.to(torch.float32)
    draws = {}
    for name, p, fn, base in (("brightness", brightness, adjust_brightness,
                               1.0),
                              ("contrast", contrast, adjust_contrast, 1.0),
                              ("saturation", saturation, adjust_saturation,
                               1.0),
                              ("hue", hue, adjust_hue, 0.0)):
        if p > 0:
            alpha = base + _uniform(-float(p), float(p), generator, device)
            draws[name] = alpha
            x = fn(x, alpha)
    _note(**draws)
    return x


@register("_image_adjust_lighting")
def adjust_lighting(data, *, alpha=(0.0, 0.0, 0.0)):
    """AlexNet's PCA lighting with a given alpha (3 values)."""
    return adjust_lighting_fn(data, _const(tuple(alpha), data.device))


@register("_image_random_lighting", differentiable=False, random=True)
def random_lighting(data, *, alpha_std=0.05, generator=None, device=None):
    alpha = torch.randn(3, generator=generator, device=device) \
        * float(alpha_std)
    _note(alpha=alpha)
    return adjust_lighting_fn(data, alpha)
