"""The ``nd.image`` namespace of the port (the counterpart of
``mxnet_tpu/ndarray/image.py``): the image ops of ``ops/image_ops.py``
through the registry. An op runs on its array's context: on a card array
it runs on the card, on a ``cpu()`` array (what the data path makes) on
the CPU. The random forms draw from ``random.generator(ctx)``, which
``invoke`` hands them; ``ops.image_ops.last_draw()`` returns the draws."""
from __future__ import annotations

from ..ops.registry import apply_op as _apply_op

__all__ = ["to_tensor", "normalize", "imresize", "resize", "crop",
           "fixed_crop", "flip_left_right", "flip_top_bottom",
           "random_flip_left_right", "random_flip_top_bottom",
           "random_brightness", "random_contrast", "random_saturation",
           "random_hue", "random_color_jitter", "adjust_lighting",
           "random_lighting"]


def to_tensor(data):
    return _apply_op("_image_to_tensor", data)


def normalize(data, mean=0.0, std=1.0):
    mean = (mean,) if isinstance(mean, (int, float)) else tuple(mean)
    std = (std,) if isinstance(std, (int, float)) else tuple(std)
    return _apply_op("_image_normalize", data, mean=mean, std=std)


def imresize(data, w, h, interp=1):
    return _apply_op("_image_resize", data, size=(int(w), int(h)),
                     interp=interp)


def resize(data, size=0, keep_ratio=False, interp=1):
    # a single int stays one element, so keep_ratio can apply
    size = (int(size),) if isinstance(size, int) else tuple(size)
    return _apply_op("_image_resize", data, size=size, keep_ratio=keep_ratio,
                     interp=interp)


def crop(data, x, y, width, height):
    return _apply_op("_image_crop", data, x=int(x), y=int(y),
                     width=int(width), height=int(height))


def fixed_crop(data, x0, y0, w, h):
    return crop(data, x0, y0, w, h)


def flip_left_right(data):
    return _apply_op("_image_flip_left_right", data)


def flip_top_bottom(data):
    return _apply_op("_image_flip_top_bottom", data)


def random_flip_left_right(data):
    return _apply_op("_image_random_flip_left_right", data)


def random_flip_top_bottom(data):
    return _apply_op("_image_random_flip_top_bottom", data)


def random_brightness(data, min_factor, max_factor):
    return _apply_op("_image_random_brightness", data,
                     min_factor=float(min_factor), max_factor=float(max_factor))


def random_contrast(data, min_factor, max_factor):
    return _apply_op("_image_random_contrast", data,
                     min_factor=float(min_factor), max_factor=float(max_factor))


def random_saturation(data, min_factor, max_factor):
    return _apply_op("_image_random_saturation", data,
                     min_factor=float(min_factor), max_factor=float(max_factor))


def random_hue(data, min_factor, max_factor):
    return _apply_op("_image_random_hue", data,
                     min_factor=float(min_factor), max_factor=float(max_factor))


def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0):
    return _apply_op("_image_random_color_jitter", data,
                     brightness=float(brightness), contrast=float(contrast),
                     saturation=float(saturation), hue=float(hue))


def adjust_lighting(data, alpha):
    return _apply_op("_image_adjust_lighting", data, alpha=tuple(alpha))


def random_lighting(data, alpha_std=0.05):
    return _apply_op("_image_random_lighting", data,
                     alpha_std=float(alpha_std))
