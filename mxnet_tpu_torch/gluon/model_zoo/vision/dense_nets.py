"""DenseNet, Inception-v3 and MobileNet v1/v2 of the port: the counterpart
of ``mxnet_tpu/gluon/model_zoo/vision/dense_nets.py``, built under the
reference's name scopes and with its deferred shapes, so
``collect_params()`` names and, after a forward, the shapes equal the JAX
package's. The layers compute on tensors; MobileNet's depthwise
convolutions are grouped cuDNN convolutions (TF32 off, as everywhere in
the port), and ``_RELU6`` is a clip to [0, 6]."""
from __future__ import annotations

from ....base import MXNetError
from .... import amp as _amp
from ...block import HybridBlock
from ...contrib.nn import concat_outputs
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   Flatten, GlobalAvgPool2D, HybridSequential, MaxPool2D)
from .resnet import _ZooNet

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "Inception3", "inception_v3", "MobileNet",
           "MobileNetV2", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "mobilenet_v2_1_0", "mobilenet_v2_0_75",
           "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _no_pretrained(pretrained):
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; load "
                         "parameters with load_jax_params()")


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------
def _make_dense_block(num_layers, bn_size, growth_rate, dropout, stage_index):
    out = HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


class _DenseLayer(HybridBlock):
    """BN, ReLU, 1x1 conv (bn_size * growth), BN, ReLU, 3x3 conv (growth),
    optional dropout; the output is the input with the new channels
    appended."""

    _io = "tensor"

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential(prefix="")
        self.body.add(BatchNorm(), Activation("relu"),
                      Conv2D(bn_size * growth_rate, kernel_size=1,
                             use_bias=False),
                      BatchNorm(), Activation("relu"),
                      Conv2D(growth_rate, kernel_size=3, padding=1,
                             use_bias=False))
        if dropout:
            self.body.add(Dropout(dropout))

    def forward(self, x):
        return concat_outputs([x, self.body(x)], 1)


def _make_transition(num_output_features):
    out = HybridSequential(prefix="")
    out.add(BatchNorm(), Activation("relu"),
            Conv2D(num_output_features, kernel_size=1, use_bias=False),
            AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(_ZooNet):
    """Stem, dense blocks joined by transitions (halving channels and
    resolution), BN, ReLU, a 7x7 average pool, then ``output``."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, kernel_size=7,
                                     strides=2, padding=3, use_bias=False),
                              BatchNorm(), Activation("relu"),
                              MaxPool2D(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2))
                    num_features = num_features // 2
            self.features.add(BatchNorm(), Activation("relu"),
                              AvgPool2D(pool_size=7), Flatten())
            self.output = Dense(classes)


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)


# ---------------------------------------------------------------------------
# Inception v3
# ---------------------------------------------------------------------------
def _make_basic_conv(**kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(use_bias=False, **kwargs), BatchNorm(epsilon=0.001),
            Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    for channels, kernel, stride, pad in conv_settings:
        kwargs = {"channels": channels, "kernel_size": kernel}
        if stride is not None:
            kwargs["strides"] = stride
        if pad is not None:
            kwargs["padding"] = pad
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Children run on the same input, their outputs joined on
    ``axis``."""

    _io = "tensor"

    def __init__(self, axis=1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def add(self, block):
        self.register_child(block)

    def forward(self, x):
        return concat_outputs([block(x) for block in self._modules.values()],
                              self._axis)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    c7 = channels_7x7
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (c7, 1, None, None), (c7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (c7, 1, None, None), (c7, (7, 1), None, (3, 0)),
                         (c7, (1, 7), None, (0, 3)), (c7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


class _InceptionE(HybridBlock):
    """Inception-v3's E block: a 1x1 branch, two branches that split into
    1x3 and 3x1 convolutions, and an average-pool branch."""

    _io = "tensor"

    def __init__(self, prefix=None, **kwargs):
        super().__init__(prefix=prefix, **kwargs)
        self.branch1 = _make_branch(None, (320, 1, None, None))
        self.branch2_stem = _make_basic_conv(channels=384, kernel_size=1)
        self.branch2_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch2_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch3_stem = HybridSequential(prefix="")
        self.branch3_stem.add(_make_basic_conv(channels=448, kernel_size=1))
        self.branch3_stem.add(_make_basic_conv(channels=384, kernel_size=3,
                                               padding=1))
        self.branch3_a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                          padding=(0, 1))
        self.branch3_b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                          padding=(1, 0))
        self.branch4 = _make_branch("avg", (192, 1, None, None))

    def forward(self, x):
        b1 = self.branch1(x)
        s2 = self.branch2_stem(x)
        b2 = concat_outputs([self.branch2_a(s2), self.branch2_b(s2)], 1)
        s3 = self.branch3_stem(x)
        b3 = concat_outputs([self.branch3_a(s3), self.branch3_b(s3)], 1)
        return concat_outputs([b1, b2, b3, self.branch4(x)], 1)


class Inception3(_ZooNet):
    """Inception-v3 (299 x 299 images): the stem, blocks A1-A3, B, C1-C4,
    D, E1, E2, an 8x8 average pool and dropout, then ``output``."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            f = self.features
            f.add(_make_basic_conv(channels=32, kernel_size=3, strides=2))
            f.add(_make_basic_conv(channels=32, kernel_size=3))
            f.add(_make_basic_conv(channels=64, kernel_size=3, padding=1))
            f.add(MaxPool2D(pool_size=3, strides=2))
            f.add(_make_basic_conv(channels=80, kernel_size=1))
            f.add(_make_basic_conv(channels=192, kernel_size=3))
            f.add(MaxPool2D(pool_size=3, strides=2))
            f.add(_make_A(32, "A1_"))
            f.add(_make_A(64, "A2_"))
            f.add(_make_A(64, "A3_"))
            f.add(_make_B("B_"))
            f.add(_make_C(128, "C1_"))
            f.add(_make_C(160, "C2_"))
            f.add(_make_C(160, "C3_"))
            f.add(_make_C(192, "C4_"))
            f.add(_make_D("D_"))
            f.add(_InceptionE("E1_"))
            f.add(_InceptionE("E2_"))
            f.add(AvgPool2D(pool_size=8))
            f.add(Dropout(0.5))
            self.output = Dense(classes)


def inception_v3(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return Inception3(**kwargs)


# ---------------------------------------------------------------------------
# MobileNet v1/v2
# ---------------------------------------------------------------------------
class _RELU6(HybridBlock):
    """min(max(x, 0), 6)."""

    _io = "tensor"

    def forward(self, x):
        return _amp.call("clip", x, a_min=0.0, a_max=6.0)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    out.add(BatchNorm())
    if active:
        out.add(_RELU6() if relu6 else Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class _LinearBottleneck(HybridBlock):
    """MobileNetV2's inverted residual: a 1x1 expansion by ``t``, a 3x3
    depthwise convolution with the stride (both ReLU6), a linear 1x1
    projection, plus the input when the shapes allow."""

    _io = "tensor"

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNet(_ZooNet):
    """MobileNet v1 at width ``multiplier``: a stem convolution, 13
    depthwise-separable pairs, global average pool, then ``output``."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                           + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6
                        + [1024] * 2]
            strides = [1, 2] * 3 + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _add_conv_dw(self.features, dwc, c, s)
            self.features.add(GlobalAvgPool2D(), Flatten())
            self.output = Dense(classes)


class MobileNetV2(_ZooNet):
    """MobileNet v2 at width ``multiplier``: a stem convolution, 17 linear
    bottlenecks, a 1x1 convolution to 1280 (ReLU6), global average pool,
    then a 1x1 convolution to ``classes`` as ``output``."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="features_")
            _add_conv(self.features, int(32 * multiplier), kernel=3,
                      stride=2, pad=1, relu6=True)
            in_channels_group = [int(x * multiplier) for x in
                                 [32] + [16] + [24] * 2 + [32] * 3
                                 + [64] * 4 + [96] * 3 + [160] * 3]
            channels_group = [int(x * multiplier) for x in
                              [16] + [24] * 2 + [32] * 3 + [64] * 4
                              + [96] * 3 + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
            for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                     strides):
                self.features.add(_LinearBottleneck(in_c, c, t, s))
            last_channels = int(1280 * multiplier) if multiplier > 1.0 \
                else 1280
            _add_conv(self.features, last_channels, relu6=True)
            self.features.add(GlobalAvgPool2D())
            self.output = HybridSequential(prefix="output_")
            self.output.add(Conv2D(classes, 1, use_bias=False,
                                   prefix="pred_"),
                            Flatten())


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
