"""Image functions of the port (the counterpart of ``mxnet_tpu/image.py``):
``imdecode``/``imread``, ``imresize``, the crops, ``color_normalize``, the
augmenters and ``CreateAugmenter``, ``ImageIter``, and the detection
augmenters with ``CreateDetAugmenter`` and ``ImageDetIter``.

Where the data stages run: decoding makes a ``cpu()`` NDArray, and an
augmenter computes on its input's context, so the data path stays on the
host; a batch reaches the card when the training loop moves it
(``as_in_context(gpu(0))``). Decoding needs PIL, else OpenCV (cv2), each
imported when called; with neither, ``imdecode`` raises MXNetError. Every
resize goes through ``ops.image_ops.resize`` (``jax.image.resize``'s
function). Random draws come from ``random.python_rng()`` and
``random.numpy_rng()``, where the JAX package draws from Python's and
numpy's global generators: under equal seeds the two packages draw the
same numbers.
"""
from __future__ import annotations

import io as _io
import math
import os
import random as _pyrandom

import numpy as onp
import torch

from . import random as _random
from .base import MXNetError, cpu
from .ndarray.ndarray import NDArray, _wrap
from .ops import image_ops as _image_ops

__all__ = ["imdecode", "imresize", "imread", "fixed_crop", "center_crop",
           "random_crop", "random_size_crop", "resize_short", "color_normalize",
           "ImageIter", "CreateAugmenter", "Augmenter", "SequentialAug",
           "RandomOrderAug", "ResizeAug", "ForceResizeAug", "CenterCropAug",
           "RandomCropAug", "RandomSizedCropAug", "HorizontalFlipAug",
           "CastAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "DetRandomSelectAug",
           "CreateDetAugmenter", "ImageDetIter"]


def _host(arr) -> NDArray:
    """A ``cpu()`` NDArray over a numpy array (copied)."""
    return NDArray(onp.ascontiguousarray(arr), ctx=cpu())


def _like(src, t: torch.Tensor) -> NDArray:
    """``t`` as an NDArray on ``src``'s context (``cpu()`` for a numpy
    ``src``)."""
    return _wrap(t, src.context if isinstance(src, NDArray) else cpu())


def _tensor(src) -> torch.Tensor:
    return src.data if isinstance(src, NDArray) else torch.as_tensor(
        onp.asarray(src))


def _f64(src, t64: torch.Tensor) -> NDArray:
    """A float64 result as float32 on ``src``'s context (the JAX package
    computes these in numpy float64 and stores float32)."""
    return _like(src, t64.to(torch.float32))


def imdecode(buf, flag=1, to_rgb=True):
    """Decode an encoded image (bytes or a uint8 NDArray) to an HWC uint8
    ``cpu()`` NDArray: RGB (BGR with ``to_rgb=False``), or one channel for
    ``flag=0``."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        img = Image.open(_io.BytesIO(bytes(buf)))
        if flag == 0:
            arr = onp.asarray(img.convert("L"))[:, :, None]
        else:
            arr = onp.asarray(img.convert("RGB"))
            if not to_rgb:
                arr = arr[:, :, ::-1]
        return _host(arr)
    try:
        import cv2
    except ImportError as e:
        raise MXNetError("imdecode requires PIL or cv2") from e
    raw = onp.frombuffer(bytes(buf), dtype=onp.uint8)
    arr = cv2.imdecode(raw, cv2.IMREAD_GRAYSCALE if flag == 0
                       else cv2.IMREAD_COLOR)
    if flag == 0:
        arr = arr[:, :, None]
    elif to_rgb:
        arr = arr[:, :, ::-1]
    return _host(arr)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    """Resize HWC ``src`` to (h, w): nearest for ``interp=0``, else
    bilinear (antialiased when shrinking), in ``src``'s dtype."""
    t = _tensor(src)
    out = _image_ops.resize(t, (h, w), (0, 1),
                            "nearest" if interp == 0 else "linear")
    return _like(src, out.to(t.dtype))


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _like(src, _tensor(src)[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    rng = _random.python_rng()
    x0 = rng.randint(0, max(w - new_w, 0))
    y0 = rng.randint(0, max(h - new_h, 0))
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    """Resize the shorter edge to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.python_rng().random() < self.p:
            return _like(src, _tensor(src).flip(1))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class SequentialAug(Augmenter):
    """Apply augmenters in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply augmenters in a random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        ts = list(self.ts)
        _random.python_rng().shuffle(ts)
        for aug in ts:
            src = aug(src)
        return src


class ForceResizeAug(Augmenter):
    """Resize to exactly (w, h), ignoring the aspect ratio."""

    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


def random_size_crop(src, size, area, ratio, interp=2):
    """A random crop of random area and aspect ratio, resized to
    ``size``; after 10 misses, the centre crop."""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    rng = _random.python_rng()
    for _ in range(10):
        target_area = rng.uniform(area[0], area[1]) * src_area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        new_ratio = math.exp(rng.uniform(*log_ratio))
        new_w = int(round(math.sqrt(target_area * new_ratio)))
        new_h = int(round(math.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w)
            y0 = rng.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


class RandomSizedCropAug(Augmenter):
    """Inception's random sized crop."""

    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size, self.area, self.ratio, self.interp = size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


_GRAY_COEF = (0.299, 0.587, 0.114)


def _gray64(src):
    """Each pixel's gray, float64 (H, W, 1)."""
    x = _tensor(src).to(torch.float64)
    return (x * torch.tensor(_GRAY_COEF, dtype=torch.float64,
                             device=x.device)).sum(dim=2, keepdim=True)


class BrightnessJitterAug(Augmenter):
    """src * (1 + U(-brightness, brightness))."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _random.python_rng().uniform(-self.brightness,
                                                   self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    """Blend with the image's gray mean."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _random.python_rng().uniform(-self.contrast,
                                                   self.contrast)
        x = _tensor(src).to(torch.float32)
        mean = _gray64(src).mean() * (3.0 / x.shape[2])
        return _f64(src, (x * alpha).double() + mean * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    """Blend with each pixel's gray."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _random.python_rng().uniform(-self.saturation,
                                                   self.saturation)
        x = _tensor(src).to(torch.float32)
        return _f64(src, (x * alpha).double() + _gray64(src) * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """Rotate the colour channels in YIQ space by U(-hue, hue) * pi."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = onp.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]])
        self.ityiq = onp.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = _random.python_rng().uniform(-self.hue, self.hue)
        u, w = math.cos(alpha * math.pi), math.sin(alpha * math.pi)
        bt = onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        t = onp.dot(onp.dot(self.ityiq, bt), self.tyiq).T
        x = _tensor(src).to(torch.float32).double()
        return _f64(src, x @ torch.as_tensor(t, device=x.device))


def ColorJitterAug(brightness, contrast, saturation):
    """Brightness, contrast and saturation jitter in a random order."""
    ts = []
    if brightness > 0:
        ts.append(BrightnessJitterAug(brightness))
    if contrast > 0:
        ts.append(ContrastJitterAug(contrast))
    if saturation > 0:
        ts.append(SaturationJitterAug(saturation))
    return RandomOrderAug(ts)


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise, alpha ~ N(0, alphastd) per
    eigenvector."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval)
        self.eigvec = onp.asarray(eigvec)

    def __call__(self, src):
        alpha = _random.numpy_rng().normal(0, self.alphastd, size=(3,))
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        x = _tensor(src).to(torch.float32).double()
        return _f64(src, x + torch.as_tensor(rgb, device=x.device))


class ColorNormalizeAug(Augmenter):
    """Subtract the mean and divide by the std."""

    def __init__(self, mean, std):
        super().__init__()
        self.mean = None if mean is None else onp.asarray(mean)
        self.std = None if std is None else onp.asarray(std)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    """Convert to 3-channel gray with probability p."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = onp.array([[0.21, 0.21, 0.21],
                              [0.72, 0.72, 0.72],
                              [0.07, 0.07, 0.07]])

    def __call__(self, src):
        if _random.python_rng().random() < self.p:
            x = _tensor(src).to(torch.float32).double()
            return _f64(src, x @ torch.as_tensor(self.mat, device=x.device))
        return src


_PCA_EIGVAL = onp.array([55.46, 4.794, 1.148])
_PCA_EIGVEC = onp.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])


def _default_mean_std(mean, std):
    if isinstance(mean, bool) and mean:
        mean = onp.array([123.68, 116.28, 103.53])
    if isinstance(std, bool) and std:
        std = onp.array([58.395, 57.12, 57.375])
    return mean, std


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The standard augmenter list (``mx.image.CreateAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(*_default_mean_std(mean, std)))
    return auglist


def _stack(arrays, dtype=onp.float32) -> NDArray:
    return _host(onp.asarray(arrays, dtype=dtype))


class ImageIter:
    """Batches of augmented images from a RecordIO file (``path_imgrec``
    with its ``.idx``) or an image list, as ``cpu()`` NDArrays (N, C, H,
    W) float32 with float32 labels. ``seed`` gives the shuffle a stream of
    its own; without it the shuffle draws from ``random.python_rng()``."""

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False, aug_list=None,
                 seed=None, **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._seeded = _pyrandom.Random(seed) if seed is not None else None
        self.auglist = aug_list if aug_list is not None else []
        self._records = []
        if path_imgrec:
            from .recordio import MXIndexedRecordIO
            rec = MXIndexedRecordIO(os.path.splitext(path_imgrec)[0] + ".idx",
                                    path_imgrec, "r")
            self._rec = rec
            self._keys = list(rec.keys)
        elif path_imglist:
            self._rec = None
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    self._records.append((float(parts[1]),
                                          os.path.join(path_root or "", parts[-1])))
            self._keys = list(range(len(self._records)))
        else:
            raise MXNetError("either path_imgrec or path_imglist is required")
        self._cursor = 0
        self.reset()

    def _rng(self):
        return self._seeded if self._seeded is not None \
            else _random.python_rng()

    def reset(self):
        self._cursor = 0
        if self._shuffle:
            self._rng().shuffle(self._keys)

    def _next_sample(self):
        if self._cursor >= len(self._keys):
            raise StopIteration
        key = self._keys[self._cursor]
        self._cursor += 1
        if self._rec is not None:
            from .recordio import unpack
            header, img = unpack(self._rec.read_idx(key))
            return header.label, imdecode(img)
        label, path = self._records[key]
        return label, imread(path)

    def __iter__(self):
        return self

    def __next__(self):
        from .io import DataBatch
        batch_data = []
        batch_label = []
        for _ in range(self.batch_size):
            label, img = self._next_sample()
            for aug in self.auglist:
                img = aug(img)
            arr = img.asnumpy()
            if arr.ndim == 3:
                arr = arr.transpose(2, 0, 1)
            batch_data.append(arr)
            batch_label.append(label)
        return DataBatch(data=[_stack(batch_data)],
                         label=[_stack(batch_label)])

    next = __next__


# ---------------------------------------------------------------------------
# detection augmenters: labels are (N, 5+) rows of [cls, x1, y1, x2, y2] in
# normalized [0, 1] corner coordinates; each augmenter transforms the image
# and its label together
# ---------------------------------------------------------------------------
class DetAugmenter:
    """Base detection augmenter."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """An image augmenter in the detection chain; the label passes
    through."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and the boxes' x coordinates with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _random.python_rng().random() < self.p:
            src = _like(src, _tensor(src).flip(1))
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A crop whose cover of some ground-truth box reaches
    ``min_object_covered`` (SSD's augmentation); boxes are clipped into
    the crop and re-normalized, boxes cropped out get class -1."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), max_attempts=25):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        rng = _random.python_rng()
        for _ in range(self.max_attempts):
            area = rng.uniform(*self.area_range) * h * w
            ratio = rng.uniform(*self.aspect_ratio_range)
            ch = int(round((area / ratio) ** 0.5))
            cw = int(round((area * ratio) ** 0.5))
            if ch > h or cw > w or ch <= 0 or cw <= 0:
                continue
            y0 = rng.randint(0, h - ch)
            x0 = rng.randint(0, w - cw)
            nx0, ny0 = x0 / w, y0 / h
            nx1, ny1 = (x0 + cw) / w, (y0 + ch) / h
            valid = label[:, 0] >= 0
            if valid.any():
                bx1, by1 = label[valid, 1], label[valid, 2]
                bx2, by2 = label[valid, 3], label[valid, 4]
                ix = onp.maximum(0, onp.minimum(bx2, nx1) - onp.maximum(bx1, nx0))
                iy = onp.maximum(0, onp.minimum(by2, ny1) - onp.maximum(by1, ny0))
                barea = onp.maximum((bx2 - bx1) * (by2 - by1), 1e-12)
                cover = (ix * iy) / barea
                if cover.max() < self.min_object_covered:
                    continue
            out = fixed_crop(src, x0, y0, cw, ch)
            new = label.copy()
            for c, (lo, span) in ((1, (nx0, nx1 - nx0)), (2, (ny0, ny1 - ny0)),
                                  (3, (nx0, nx1 - nx0)), (4, (ny0, ny1 - ny0))):
                new[:, c] = onp.clip((new[:, c] - lo) / max(span, 1e-12), 0, 1)
            gone = ((new[:, 3] - new[:, 1]) <= 1e-3) | \
                   ((new[:, 4] - new[:, 2]) <= 1e-3)
            new[gone, 0] = -1
            return out, new
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Zoom out: place the image on a larger canvas filled with
    ``pad_val`` and shrink the boxes to match."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=25, pad_val=(127, 127, 127)):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        rng = _random.python_rng()
        for _ in range(self.max_attempts):
            scale = rng.uniform(*self.area_range)
            ratio = rng.uniform(*self.aspect_ratio_range)
            if scale <= 1.0:
                return src, label
            nh = int(round((scale * h * w / ratio) ** 0.5))
            nw = int(round((scale * h * w * ratio) ** 0.5))
            if nh >= h and nw >= w:
                break
        else:
            return src, label
        y0 = rng.randint(0, nh - h)
        x0 = rng.randint(0, nw - w)
        # a float canvas: jittered pixels would wrap through uint8
        t = _tensor(src)
        canvas = torch.empty((nh, nw, t.shape[2]), dtype=torch.float32,
                             device=t.device)
        canvas[...] = torch.tensor(self.pad_val, dtype=torch.float32,
                                   device=t.device)
        canvas[y0:y0 + h, x0:x0 + w] = t.to(torch.float32)
        new = label.copy()
        new[:, 1] = (new[:, 1] * w + x0) / nw
        new[:, 3] = (new[:, 3] * w + x0) / nw
        new[:, 2] = (new[:, 2] * h + y0) / nh
        new[:, 4] = (new[:, 4] * h + y0) / nh
        return _like(src, canvas), new


class DetRandomSelectAug(DetAugmenter):
    """Apply one augmenter picked at random, or none with probability
    ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        rng = _random.python_rng()
        if rng.random() < self.skip_prob or not self.aug_list:
            return src, label
        return rng.choice(self.aug_list)(src, label)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0., rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       inter_method=2, min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33), area_range=(0.3, 3.0),
                       max_attempts=25, pad_val=(127, 127, 127)):
    """SSD's augmenter chain."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(area_range[1], 1.0)),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2], data_shape[1]),
                                               inter_method)))
    for jitter, cls in ((brightness, BrightnessJitterAug),
                        (contrast, ContrastJitterAug),
                        (saturation, SaturationJitterAug)):
        if jitter > 0:
            auglist.append(DetBorrowAug(cls(jitter)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            *_default_mean_std(mean, std))))
    return auglist


class ImageDetIter(ImageIter):
    """Detection batches: images with (B, label_pad, 5) labels, rows
    [cls, x1, y1, x2, y2], padded with -1."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, label_pad=8,
                 aug_list=None, **kwargs):
        self.det_auglist = aug_list if aug_list is not None else []
        self.label_pad = label_pad
        super().__init__(batch_size, data_shape, path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         aug_list=[], **kwargs)
        if path_imglist:
            # a detection .lst line carries the whole label vector
            self._records = []
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if not parts or len(parts) < 3:
                        continue
                    vec = onp.asarray([float(v) for v in parts[1:-1]],
                                      onp.float32)
                    self._records.append(
                        (vec, os.path.join(path_root or "", parts[-1])))
            self._keys = list(range(len(self._records)))
            self.reset()

    def _parse_label(self, raw):
        """The flat detection label [A, B, ...A-2 extras..., rows x B]
        (A the header length, B >= 5 the object width) as (rows, 5); a
        plain multiple-of-5 array is taken as rows."""
        arr = onp.asarray(raw, onp.float32).reshape(-1)
        if arr.size >= 2:
            a, b = int(arr[0]), int(arr[1])
            if a >= 2 and b >= 5 and arr.size >= a \
                    and (arr.size - a) % b == 0:
                return arr[a:].reshape(-1, b)[:, :5]
        if arr.size % 5:
            raise MXNetError(
                f"ImageDetIter: cannot parse detection label of size "
                f"{arr.size} (expected [A, B, ...header..., rows x B] or a "
                "multiple-of-5 flat array)")
        return arr.reshape(-1, 5)

    def __next__(self):
        from .io import DataBatch
        batch_data, batch_label = [], []
        for _ in range(self.batch_size):
            label, img = self._next_sample()
            rows = self._parse_label(label)
            for aug in self.det_auglist:
                img, rows = aug(img, rows)
            arr = img.asnumpy()
            if arr.ndim == 3:
                arr = arr.transpose(2, 0, 1)
            batch_data.append(arr)
            if len(rows) > self.label_pad:
                raise MXNetError(
                    f"ImageDetIter: {len(rows)} objects exceed "
                    f"label_pad={self.label_pad}; raise label_pad (silent "
                    "truncation would train those regions as background)")
            padded = onp.full((self.label_pad, 5), -1.0, onp.float32)
            padded[:len(rows)] = rows
            batch_label.append(padded)
        return DataBatch(data=[_stack(batch_data)],
                         label=[_stack(batch_label)])

    next = __next__
