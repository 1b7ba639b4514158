"""Convolution and pooling layers of the port as Gluon blocks: the
counterparts of ``Conv2D``, ``MaxPool2D`` and ``GlobalAvgPool2D`` in
``mxnet_tpu/gluon/nn/conv_layers.py``, NCHW activations and OIHW weights as
the JAX package stores them (the only layout ported), with its constructor
arguments and parameter names. ``in_channels=0`` is inferred from the first
input.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import nn as ops
from ...ops.nn import _pair
from ..block import HybridBlock
from .basic_layers import _init_by_name

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


class Conv2D(HybridBlock):
    """2-D convolution: weight (channels, in_channels // groups, kh, kw),
    bias (channels,) when ``use_bias`` (the default), then ``activation``
    if given."""

    _io = "tensor"

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        if layout != "NCHW":
            raise MXNetError(f"Conv2D: layout {layout!r} is not ported; "
                             "NCHW only")
        self._channels = channels
        self._kernel = _pair(kernel_size)
        self._kwargs = {"stride": _pair(strides), "pad": _pair(padding),
                        "dilate": _pair(dilation), "num_group": groups}
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups
                                 if in_channels else 0) + self._kernel,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,),
                    init=_init_by_name(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        self.weight.shape = (self._channels,
                             x.shape[1] // self._kwargs["num_group"]) + \
            self._kernel

    def forward(self, x):
        out = ops.convolution(x, self._t("weight"), self._t("bias"),
                              **self._kwargs)
        return ops.activation(out, act_type=self._act_type) \
            if self._act_type else out


class MaxPool2D(HybridBlock):
    """Max pooling with ``pool_size`` windows at ``strides`` (default the
    pool size) and ``padding``; the output size rounds down
    (``ceil_mode=True`` is not ported)."""

    _io = "tensor"

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(**kwargs)
        if ceil_mode or layout != "NCHW":
            raise MXNetError("MaxPool2D: only ceil_mode=False over NCHW is "
                             "ported")
        self._kwargs = {"kernel": _pair(pool_size),
                        "stride": None if strides is None else _pair(strides),
                        "pad": _pair(padding)}

    def forward(self, x):
        return ops.pooling(x, pool_type="max", **self._kwargs)


class GlobalAvgPool2D(HybridBlock):
    """Average over H and W, keeping them: (N, C, H, W) -> (N, C, 1, 1)."""

    _io = "tensor"

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        if layout != "NCHW":
            raise MXNetError("GlobalAvgPool2D: NCHW only")

    def forward(self, x):
        return ops.pooling(x, pool_type="avg", global_pool=True)
