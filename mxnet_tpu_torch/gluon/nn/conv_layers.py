"""Convolution and pooling layers of the port as Gluon blocks: the
counterparts of ``mxnet_tpu/gluon/nn/conv_layers.py`` (``Conv1D``/``2D``/
``3D``, their ``Transpose`` forms, max and average pooling in 1, 2 and 3
dimensions and their global forms, ``ReflectionPad2D``), with its
constructor arguments and parameter names, over NC... activations (the
only layout ported). Convolution weights are (channels, in_channels //
groups, *kernel), transposed-convolution weights (in_channels, channels //
groups, *kernel), as the reference stores them; ``in_channels=0`` is
inferred from the first input.
"""
from __future__ import annotations

from ... import amp as _amp
from ...base import MXNetError
from ..block import HybridBlock
from .basic_layers import _init_by_name

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _check_layout(layout, n, what):
    if layout != _LAYOUTS[n]:
        raise MXNetError(f"{what}: layout {layout!r} is not ported; "
                         f"{_LAYOUTS[n]} only")


class _Conv(HybridBlock):
    """Convolution (``transpose=False``) or transposed convolution in
    len(kernel) dimensions, then ``activation`` if given."""

    _io = "tensor"

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", adj=None, transpose=False,
                 **kwargs):
        super().__init__(**kwargs)
        n = len(kernel_size)
        _check_layout(layout, n, type(self).__name__)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._transpose = transpose
        self._kwargs = {"stride": strides, "pad": padding, "dilate": dilation,
                        "num_group": groups}
        if transpose:
            self._kwargs["adj"] = adj
        self._act_type = activation
        with self.name_scope():
            if transpose:
                wshape = (in_channels, channels // groups) + self._kernel
            else:
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + self._kernel
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,),
                    init=_init_by_name(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        g = self._kwargs["num_group"]
        if self._transpose:
            self.weight.shape = (x.shape[1], self._channels // g) + \
                self._kernel
        else:
            self.weight.shape = (self._channels, x.shape[1] // g) + \
                self._kernel

    def forward(self, x):
        out = _amp.call("Deconvolution" if self._transpose else
                        "Convolution", x, self._t("weight"), self._t("bias"),
                        **self._kwargs)
        return _amp.call("Activation", out, act_type=self._act_type) \
            if self._act_type else out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """2-D convolution: weight (channels, in_channels // groups, kh, kw),
    bias (channels,) when ``use_bias`` (the default), then ``activation``
    if given."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         adj=_tup(output_padding, 1), transpose=True,
                         **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         adj=_tup(output_padding, 2), transpose=True,
                         **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         adj=_tup(output_padding, 3), transpose=True,
                         **kwargs)


class _Pooling(HybridBlock):
    """Pooling by ``ops.nn.pooling``: ``strides`` default to the pool
    size, ``ceil_mode`` is the "full" convention."""

    _io = "tensor"

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        _check_layout(layout, len(pool_size), type(self).__name__)
        self._kwargs = {
            "kernel": pool_size, "stride": pool_size if strides is None
            else strides, "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return _amp.call("Pooling", x, **self._kwargs)


def _pool_class(name, n, pool_type, avg):
    """The reference's windowed pooling layer ``name`` in n dimensions."""
    default = 2 if n == 1 else (2,) * n

    def __init__(self, pool_size=default, strides=None, padding=0,
                 layout=_LAYOUTS[n], ceil_mode=False, count_include_pad=True,
                 **kwargs):
        _Pooling.__init__(self, _tup(pool_size, n),
                          strides and _tup(strides, n), _tup(padding, n),
                          ceil_mode, False, pool_type, layout,
                          count_include_pad if avg else None, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__,
                                    "__doc__": f"{pool_type} pooling in {n}-D."})


def _global_class(name, n, pool_type):
    def __init__(self, layout=_LAYOUTS[n], **kwargs):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, True, True,
                          pool_type, layout, **kwargs)
    return type(name, (_Pooling,), {
        "__init__": __init__,
        "__doc__": f"{pool_type} over every spatial axis ({n}-D), kept as "
                   "size 1."})


MaxPool1D = _pool_class("MaxPool1D", 1, "max", False)
MaxPool2D = _pool_class("MaxPool2D", 2, "max", False)
MaxPool3D = _pool_class("MaxPool3D", 3, "max", False)
AvgPool1D = _pool_class("AvgPool1D", 1, "avg", True)
AvgPool2D = _pool_class("AvgPool2D", 2, "avg", True)
AvgPool3D = _pool_class("AvgPool3D", 3, "avg", True)
GlobalMaxPool1D = _global_class("GlobalMaxPool1D", 1, "max")
GlobalMaxPool2D = _global_class("GlobalMaxPool2D", 2, "max")
GlobalMaxPool3D = _global_class("GlobalMaxPool3D", 3, "max")
GlobalAvgPool1D = _global_class("GlobalAvgPool1D", 1, "avg")
GlobalAvgPool2D = _global_class("GlobalAvgPool2D", 2, "avg")
GlobalAvgPool3D = _global_class("GlobalAvgPool3D", 3, "avg")


class ReflectionPad2D(HybridBlock):
    """Reflection padding of H and W by ``padding`` (an int, or the flat
    (before, after) pairs of all four axes)."""

    _io = "tensor"

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def forward(self, x):
        return _amp.call("pad", x, mode="reflect", pad_width=self._padding)
