"""AlexNet, VGG and SqueezeNet of the port: the counterpart of
``mxnet_tpu/gluon/model_zoo/vision/simple_nets.py``, built under the
reference's name scopes and with its deferred shapes (a layer's input
channels and a Dense layer's input units are known at the first forward),
so ``collect_params()`` names and, after a forward, the shapes equal the
JAX package's. The layers compute on tensors (cuDNN convolutions;
SqueezeNet's ``MaxPool2D(ceil_mode=True)`` is the "full" pooling
convention, as the reference's)."""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ...contrib.nn import concat_outputs
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Dropout, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from .resnet import _ZooNet

__all__ = ["AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "get_vgg"]


def _no_pretrained(pretrained):
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; load "
                         "parameters with load_jax_params()")


class AlexNet(_ZooNet):
    """Five convolutions (ReLU) with three max pools, two Dense(4096) with
    dropout 0.5, then ``output``."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(
                    Conv2D(64, kernel_size=11, strides=4, padding=2,
                           activation="relu"),
                    MaxPool2D(pool_size=3, strides=2),
                    Conv2D(192, kernel_size=5, padding=2, activation="relu"),
                    MaxPool2D(pool_size=3, strides=2),
                    Conv2D(384, kernel_size=3, padding=1, activation="relu"),
                    Conv2D(256, kernel_size=3, padding=1, activation="relu"),
                    Conv2D(256, kernel_size=3, padding=1, activation="relu"),
                    MaxPool2D(pool_size=3, strides=2),
                    Flatten(),
                    Dense(4096, activation="relu"),
                    Dropout(0.5),
                    Dense(4096, activation="relu"),
                    Dropout(0.5))
            self.output = Dense(classes)


def alexnet(pretrained=False, ctx=None, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(_ZooNet):
    """3x3 convolutions (with BatchNorm when ``batch_norm``) and ReLU in
    five groups, each closed by a max pool, two Dense(4096) with dropout
    0.5, then ``output``; the Dense weights initialize from N(0, 0.01)."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise MXNetError(f"VGG: {len(layers)} groups, {len(filters)} "
                             "filter counts")
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(
                Dense(4096, activation="relu", weight_initializer="normal"),
                Dropout(rate=0.5),
                Dense(4096, activation="relu", weight_initializer="normal"),
                Dropout(rate=0.5))
            self.output = Dense(classes, weight_initializer="normal")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(Conv2D(filters[i], kernel_size=3, padding=1))
                if batch_norm:
                    featurizer.add(BatchNorm())
                featurizer.add(Activation("relu"))
            featurizer.add(MaxPool2D(strides=2))
        return featurizer


def get_vgg(num_layers, pretrained=False, ctx=None, **kwargs):
    _no_pretrained(pretrained)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)


class _Fire(HybridBlock):
    """SqueezeNet's fire module: a 1x1 squeeze, then 1x1 and 3x3 expands
    (each with ReLU) joined on channels."""

    _io = "tensor"

    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = Conv2D(squeeze_channels, kernel_size=1,
                              activation="relu")
        self.expand1x1 = Conv2D(expand1x1_channels, kernel_size=1,
                                activation="relu")
        self.expand3x3 = Conv2D(expand3x3_channels, kernel_size=3, padding=1,
                                activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return concat_outputs([self.expand1x1(x), self.expand3x3(x)], 1)


class SqueezeNet(_ZooNet):
    """SqueezeNet 1.0 or 1.1: a stem convolution, fire modules between
    ceil-mode max pools, dropout, and a 1x1 convolution to ``classes``
    (ReLU) averaged over the image."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise MXNetError(f"SqueezeNet version {version!r}: 1.0 or 1.1")
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            f = self.features
            if version == "1.0":
                f.add(Conv2D(96, kernel_size=7, strides=2, activation="relu"))
                f.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                f.add(_Fire(16, 64, 64), _Fire(16, 64, 64),
                      _Fire(32, 128, 128))
                f.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                f.add(_Fire(32, 128, 128), _Fire(48, 192, 192),
                      _Fire(48, 192, 192), _Fire(64, 256, 256))
                f.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                f.add(_Fire(64, 256, 256))
            else:
                f.add(Conv2D(64, kernel_size=3, strides=2, activation="relu"))
                f.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                f.add(_Fire(16, 64, 64), _Fire(16, 64, 64))
                f.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                f.add(_Fire(32, 128, 128), _Fire(32, 128, 128))
                f.add(MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                f.add(_Fire(48, 192, 192), _Fire(48, 192, 192),
                      _Fire(64, 256, 256), _Fire(64, 256, 256))
            f.add(Dropout(0.5))
            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1,
                                   activation="relu"),
                            GlobalAvgPool2D(), Flatten())


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
