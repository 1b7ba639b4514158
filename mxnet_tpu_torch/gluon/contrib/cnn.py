"""gluon.contrib.cnn of the port (the counterpart of
``mxnet_tpu/gluon/contrib/cnn.py``): ``DeformableConvolution``, a learned
offset branch (a plain convolution) feeding the ``DeformableConvolution``
op. The offsets' weight and bias start at zero, so at initialization the
layer is a plain convolution."""
from __future__ import annotations

from ... import amp as _amp
from ...base import MXNetError
from ..block import HybridBlock
from ..nn.basic_layers import _init_by_name
from ..nn.conv_layers import _tup

__all__ = ["DeformableConvolution"]


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1: ``DeformableConvolution(x,
    offset_conv(x), weight, bias)``, then ``activation`` if given."""

    _io = "tensor"

    def __init__(self, channels, kernel_size=(3, 3), strides=(1, 1),
                 padding=(1, 1), dilation=(1, 1), groups=1,
                 num_deformable_group=1, use_bias=True, in_channels=0,
                 activation=None, layout="NCHW", weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        if layout != "NCHW":
            raise MXNetError("DeformableConvolution supports layout='NCHW'")
        self._channels = channels
        self._kernel = _tup(kernel_size, 2)
        self._strides = _tup(strides, 2)
        self._padding = _tup(padding, 2)
        self._dilation = _tup(dilation, 2)
        self._groups = groups
        self._act = activation
        self._ndg = num_deformable_group
        self._use_bias = use_bias
        self._koff = 2 * self._kernel[0] * self._kernel[1] * \
            num_deformable_group
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups
                                 if in_channels else 0) + self._kernel,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,),
                init=_init_by_name(bias_initializer),
                allow_deferred_init=True) if use_bias else None
            self.offset_weight = self.params.get(
                "offset_weight", shape=(self._koff, in_channels)
                + self._kernel,
                init=_init_by_name(offset_weight_initializer),
                allow_deferred_init=True)
            self.offset_bias = self.params.get(
                "offset_bias", shape=(self._koff,),
                init=_init_by_name(offset_bias_initializer),
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[1]
        if self._groups and c % self._groups:
            raise MXNetError(f"in_channels {c} not divisible by groups")
        if self._ndg and c % self._ndg:
            raise MXNetError(f"in_channels {c} not divisible by "
                             f"num_deformable_group={self._ndg}")
        self.weight.shape = (self._channels, c // self._groups) + \
            self._kernel
        self.offset_weight.shape = (self._koff, c) + self._kernel

    def forward(self, x):
        conv = dict(kernel=self._kernel, stride=self._strides,
                    dilate=self._dilation, pad=self._padding)
        offset = _amp.call("Convolution", x, self._t("offset_weight"),
                           self._t("offset_bias"), num_filter=self._koff,
                           no_bias=False, **conv)
        out = _amp.call("DeformableConvolution", x, offset,
                        self._t("weight"), self._t("bias"),
                        num_filter=self._channels, num_group=self._groups,
                        num_deformable_group=self._ndg,
                        no_bias=not self._use_bias, **conv)
        if self._act is not None:
            out = _amp.call("Activation", out, act_type=self._act)
        return out

    def __repr__(self):
        return (f"DeformableConvolution({self._channels}, "
                f"kernel_size={self._kernel}, "
                f"num_deformable_group={self._ndg})")
