"""Vision transforms of the port (the counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``): ``Compose``, ``Cast``,
``ToTensor``, ``Normalize``, ``Resize``, ``CenterCrop``,
``RandomResizedCrop``, the flips, the colour jitters, ``RandomLighting``,
``Rotate``/``RandomRotation``, ``CropResize`` and ``RandomApply``, each a
``Block``.

A transform takes an NDArray or a numpy array and computes with PyTorch on
the input's context (a numpy input, or a decoded image, on ``cpu()``), so
in a DataLoader's workers it runs on the host. Resizes go through
``ops.image_ops.resize``. Random draws come from ``random.python_rng()``
and ``random.numpy_rng()`` (the sample stream of the batch a DataLoader
fetches), where the JAX package draws from Python's and numpy's global
generators.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .... import random as _random
from ....image import _like as _out, _tensor
from ....ndarray.ndarray import NDArray
from ....ops import image_ops as _image_ops
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting", "Rotate",
           "RandomRotation", "CropResize", "RandomApply"]


def _nd(x) -> NDArray:
    return x if isinstance(x, NDArray) else _out(x, _tensor(x))


def _resize_hwc(t, size, interp=1):
    """HWC ``t`` resized to ``size`` (h, w), float32."""
    h, w = size if isinstance(size, (list, tuple)) else (size, size)
    return _image_ops.resize(t, (h, w), (0, 1),
                             "nearest" if interp == 0 else "linear")


class _Transform(Block):
    """A transform: its forward takes NDArrays or numpy arrays."""

    _io = None


class Compose(Sequential):
    """Transforms applied in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _nd(x).astype(self._dtype)


class ToTensor(_Transform):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""

    def forward(self, x):
        t = _tensor(x).to(torch.float32) / 255.0
        if t.dim() == 3:
            t = t.permute(2, 0, 1)
        elif t.dim() == 4:
            t = t.permute(0, 3, 1, 2)
        return _out(x, t)


class Normalize(_Transform):
    """(x - mean) / std per channel of CHW input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        t = _tensor(x).to(torch.float32)
        mean = torch.as_tensor(self._mean, device=t.device)
        std = torch.as_tensor(self._std, device=t.device)
        if self._mean.ndim:
            mean = mean.reshape(-1, 1, 1)
        if self._std.ndim:
            std = std.reshape(-1, 1, 1)
        return _out(x, (t - mean) / std)


class Resize(_Transform):
    """Resize to ``size`` (an int for both edges, or (h, w)); with
    ``keep_ratio`` the shorter edge to ``size``. uint8 input gives
    float32."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        t = _tensor(x)
        if t.dim() == 2:
            t = t[:, :, None]
        if self._keep:
            h, w = t.shape[:2]
            short = self._size
            if h < w:
                size = (short, int(w * short / h))
            else:
                size = (int(h * short / w), short)
        else:
            size = self._size if isinstance(self._size, (list, tuple)) \
                else (self._size, self._size)
        dtype = torch.float32 if t.dtype == torch.uint8 else t.dtype
        return _out(x, _resize_hwc(t, size, self._interpolation).to(dtype))


def _center_crop(t, size):
    h, w = t.shape[:2]
    th, tw = size
    if h < th or w < tw:
        t = _resize_hwc(t, (max(h, th), max(w, tw)))
        h, w = t.shape[:2]
    y0 = (h - th) // 2
    x0 = (w - tw) // 2
    return t[y0:y0 + th, x0:x0 + tw]


class CenterCrop(_Transform):
    """The centre (h, w) crop; a smaller image is first resized up."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)

    def forward(self, x):
        return _out(x, _center_crop(_tensor(x), self._size))


class RandomResizedCrop(_Transform):
    """A crop of random area (``scale`` of the image) and aspect ratio
    (``ratio``) resized to ``size``; after 10 misses, the centre crop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        t = _tensor(x)
        h, w = t.shape[:2]
        area = h * w
        rng = _random.python_rng()
        for _ in range(10):
            target_area = rng.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            new_w = int(round(math.sqrt(target_area * aspect)))
            new_h = int(round(math.sqrt(target_area / aspect)))
            if new_w <= w and new_h <= h:
                x0 = rng.randint(0, w - new_w)
                y0 = rng.randint(0, h - new_h)
                crop = t[y0:y0 + new_h, x0:x0 + new_w]
                return _out(x, _resize_hwc(crop, self._size))
        return _out(x, _center_crop(t, self._size))


class RandomFlipLeftRight(_Transform):
    def forward(self, x):
        if _random.python_rng().random() < 0.5:
            return _out(x, _tensor(x).flip(1))
        return _nd(x)


class RandomFlipTopBottom(_Transform):
    def forward(self, x):
        if _random.python_rng().random() < 0.5:
            return _out(x, _tensor(x).flip(0))
        return _nd(x)


class RandomBrightness(_Transform):
    def __init__(self, brightness):
        super().__init__()
        self._brightness = brightness

    def forward(self, x):
        alpha = 1.0 + _random.python_rng().uniform(-self._brightness,
                                                   self._brightness)
        return _out(x, _tensor(x).to(torch.float32) * alpha)


class RandomContrast(_Transform):
    """Blend with the image's mean."""

    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def forward(self, x):
        alpha = 1.0 + _random.python_rng().uniform(-self._contrast,
                                                   self._contrast)
        t = _tensor(x).to(torch.float32)
        return _out(x, t * alpha + t.mean() * (1 - alpha))


class RandomSaturation(_Transform):
    """Blend with each pixel's channel mean."""

    def __init__(self, saturation):
        super().__init__()
        self._saturation = saturation

    def forward(self, x):
        alpha = 1.0 + _random.python_rng().uniform(-self._saturation,
                                                   self._saturation)
        t = _tensor(x).to(torch.float32)
        return _out(x, t * alpha + t.mean(dim=2, keepdim=True) * (1 - alpha))


class RandomHue(_Transform):
    """Rotate the chroma in YIQ space (``image.HueJitterAug``)."""

    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        from ....image import HueJitterAug
        return HueJitterAug(self._hue)(_nd(x))


class RandomColorJitter(_Transform):
    """Brightness, contrast, saturation and hue jitter in a random
    order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        ts = []
        if brightness > 0:
            ts.append(RandomBrightness(brightness))
        if contrast > 0:
            ts.append(RandomContrast(contrast))
        if saturation > 0:
            ts.append(RandomSaturation(saturation))
        if hue > 0:
            ts.append(RandomHue(hue))
        self._ts = ts

    def forward(self, x):
        order = list(self._ts)
        _random.python_rng().shuffle(order)
        for t in order:
            x = t(x)
        return x


class RandomLighting(_Transform):
    """AlexNet's PCA lighting noise (``image.LightingAug``)."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        from ....image import LightingAug, _PCA_EIGVAL, _PCA_EIGVEC
        return LightingAug(self._alpha, _PCA_EIGVAL, _PCA_EIGVEC)(_nd(x))


class Rotate(_Transform):
    """Rotate HWC by a fixed angle (degrees, counterclockwise);
    ``zoom_in``/``zoom_out`` scale the frame to hide the corners or to
    keep the whole image."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        self._deg = rotation_degrees
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out

    def forward(self, x):
        return _rotate_hwc(x, self._deg, self._zoom_in, self._zoom_out)


class RandomRotation(_Transform):
    """Rotate by U(angle_limits) with probability ``rotate_with_proba``."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        self._limits = angle_limits
        self._zoom_in = zoom_in
        self._zoom_out = zoom_out
        self._proba = rotate_with_proba

    def forward(self, x):
        rng = _random.python_rng()
        if rng.random() >= self._proba:
            return _nd(x)
        deg = rng.uniform(*self._limits)
        return _rotate_hwc(x, deg, self._zoom_in, self._zoom_out)


def _rotate_hwc(x, deg, zoom_in=False, zoom_out=False):
    """Bilinear rotation about the image centre; coordinates and weights
    in float64, the result float32."""
    arr = _tensor(x).to(torch.float32)
    H, W = arr.shape[:2]
    theta = math.radians(deg)
    c, s = math.cos(theta), math.sin(theta)
    scale = 1.0
    if zoom_out:
        # the rotated frame holds the whole image
        scale = max(abs(c) + abs(s) * W / H, abs(c) + abs(s) * H / W)
    elif zoom_in:
        # no black corners: the worse aspect direction, between pixel
        # centres
        ratio = max((W - 1) / max(H - 1, 1), (H - 1) / max(W - 1, 1))
        scale = 1.0 / (abs(c) + abs(s) * ratio)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    f64 = torch.float64
    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=arr.device),
                            torch.arange(W, dtype=f64, device=arr.device),
                            indexing="ij")
    yr = (ys - cy) * scale
    xr = (xs - cx) * scale
    src_y = c * yr + s * xr + cy
    src_x = -s * yr + c * xr + cx
    y0 = src_y.floor()
    x0 = src_x.floor()
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    valid = ((src_y >= 0) & (src_y <= H - 1) & (src_x >= 0)
             & (src_x <= W - 1))[..., None]
    y0, x0 = y0.long(), x0.long()
    y0c, x0c = y0.clamp(0, H - 1), x0.clamp(0, W - 1)
    y1c, x1c = (y0 + 1).clamp(0, H - 1), (x0 + 1).clamp(0, W - 1)
    a = arr.to(f64)
    out = (a[y0c, x0c] * ((1 - wy) * (1 - wx)) + a[y0c, x1c] * ((1 - wy) * wx)
           + a[y1c, x0c] * (wy * (1 - wx)) + a[y1c, x1c] * (wy * wx))
    return _out(x, (out * valid).to(torch.float32))


class CropResize(_Transform):
    """The crop (x, y, width, height), resized to ``size`` if given."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._box = (x, y, width, height)
        self._size = size
        self._interp = interpolation

    def forward(self, data):
        from ....image import fixed_crop, imresize
        x, y, w, h = self._box
        out = fixed_crop(_nd(data), x, y, w, h)
        if self._size is not None:
            sw, sh = (self._size, self._size) if isinstance(self._size, int) \
                else self._size
            out = imresize(out, sw, sh, self._interp)
        return out


class RandomApply(_Transform):
    """Apply ``transform`` with probability p."""

    def __init__(self, transform, p=0.5):
        super().__init__()
        self._transform = transform
        self._p = p

    def forward(self, x):
        if _random.python_rng().random() < self._p:
            return self._transform(x)
        return _nd(x)
