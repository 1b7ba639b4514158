"""Convolution and pooling layers of the port as ``torch.nn.Module``s: the
counterparts of ``Conv2D``, ``MaxPool2D`` and ``GlobalAvgPool2D`` in
``mxnet_tpu/gluon/nn/conv_layers.py``, NCHW activations and OIHW weights as
the JAX package stores them (the only layout ported), so ``state_dict()``
keys and shapes match its ``_collect_params_with_prefix()``. Shapes are
given at construction (no deferred initialization).
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...ops import nn as ops
from ...ops.nn import _pair

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


class Conv2D(nn.Module):
    """2-D convolution: weight (channels, in_channels // groups, kh, kw)
    drawn N(0, 1/fan_in), bias (channels,) zeros when ``use_bias`` (the
    default, as the reference)."""

    def __init__(self, channels: int, kernel_size, strides=1, padding=0,
                 dilation=1, groups: int = 1, use_bias: bool = True,
                 in_channels: int = 0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("Conv2D needs in_channels > 0 (the port has no "
                             "deferred shape inference)")
        kernel = _pair(kernel_size)
        self._kwargs = {"stride": _pair(strides), "pad": _pair(padding),
                        "dilate": _pair(dilation), "num_group": groups}
        fan_in = in_channels // groups * kernel[0] * kernel[1]
        self.weight = nn.Parameter(torch.empty(
            (channels, in_channels // groups) + kernel, device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, fan_in ** -0.5)
        self.bias = nn.Parameter(torch.zeros(channels, device=device)) \
            if use_bias else None

    def forward(self, x):
        return ops.convolution(x, self.weight, self.bias, **self._kwargs)


class MaxPool2D(nn.Module):
    """Max pooling with ``pool_size`` windows at ``strides`` (default the
    pool size) and ``padding``."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0):
        super().__init__()
        self._kwargs = {"kernel": _pair(pool_size),
                        "stride": None if strides is None else _pair(strides),
                        "pad": _pair(padding)}

    def forward(self, x):
        return ops.pooling(x, pool_type="max", **self._kwargs)


class GlobalAvgPool2D(nn.Module):
    """Average over H and W, keeping them: (N, C, H, W) -> (N, C, 1, 1)."""

    def forward(self, x):
        return ops.pooling(x, pool_type="avg", global_pool=True)
