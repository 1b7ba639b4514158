"""ResNet v1 and v2 of the port: the counterpart of ``BasicBlockV1``,
``BottleneckV1``, ``ResNetV1``, their v2 forms, ``get_resnet`` and
``resnet{18,34,50,101,152}_v{1,2}`` in
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``.

The blocks are Gluon ``HybridBlock``s built under the reference's name
scopes, so ``_collect_params_with_prefix()`` names (the ``state_dict()``
keys, for example ``features.4.0.body.0.weight``) and ``collect_params()``
names (``resnetv10_stage1_conv2d0_weight``) equal the JAX package's, and
:meth:`ResNetV1.jax_names` maps the one to the other: 299 parameters and
running stats for ``resnet50_v1``. The bottleneck's 1x1 convolutions carry
a bias, as the reference's.

The convolutions are library convolutions (cuDNN), as they are XLA's in the
JAX package; the net is not fused. ``ops.cuda.fused_conv1x1`` (K4) computes
its conv -> BatchNorm -> ReLU chain at a bottleneck's last 1x1 conv as a
separate op. Images have 3 channels: the port gives every layer its input
channels (the reference infers the stem's and the bottleneck's first
convolution's from the data), so all shapes are known at construction. V2
is not ported yet.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ....base import MXNetError
from ....ops import nn as ops
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ..carrier import check_against, rename_from_jax, to_tensor

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "BasicBlockV2",
           "BottleneckV2", "ResNetV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2", "state_from_jax"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels)


def _downsample(channels, stride, in_channels):
    ds = HybridSequential(prefix="")
    ds.add(Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                  in_channels=in_channels),
           BatchNorm(in_channels=channels))
    return ds


class BasicBlockV1(HybridBlock):
    """Two 3x3 convolutions with BatchNorm and a residual (ResNet-18/34)."""

    _io = "tensor"

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels),
                      BatchNorm(in_channels=channels),
                      Activation("relu"),
                      _conv3x3(channels, 1, channels),
                      BatchNorm(in_channels=channels))
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def forward(self, x):
        residual = self.downsample(x) if self.downsample is not None else x
        return ops.activation(residual + self.body(x), act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 (stride here, as v1) -> 3x3 -> 1x1 with BatchNorms and ReLUs,
    plus a residual: ResNet-50/101/152's block. ``body[3]`` is the 3x3
    convolution, ``body[4]`` its BatchNorm, ``body[6]`` the last 1x1
    convolution and ``body[7]`` its BatchNorm."""

    _io = "tensor"

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = HybridSequential(prefix="")
        self.body.add(Conv2D(mid, kernel_size=1, strides=stride,
                             in_channels=in_channels),
                      BatchNorm(in_channels=mid),
                      Activation("relu"),
                      _conv3x3(mid, 1, mid),
                      BatchNorm(in_channels=mid),
                      Activation("relu"),
                      Conv2D(channels, kernel_size=1, strides=1,
                             in_channels=mid),
                      BatchNorm(in_channels=channels))
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def forward(self, x):
        residual = self.downsample(x) if self.downsample is not None else x
        return ops.activation(self.body(x) + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation basic block: BN, ReLU, 3x3 conv, BN, ReLU, 3x3 conv,
    plus the residual (a 1x1 conv of the activated input when
    downsampling)."""

    _io = "tensor"

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = BatchNorm(in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = BatchNorm(in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = ops.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = ops.activation(self.bn2(self.conv1(x)), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """Pre-activation bottleneck: (BN, ReLU, conv) three times (1x1, 3x3
    with the stride, 1x1), plus the residual."""

    _io = "tensor"

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = BatchNorm(in_channels=in_channels)
        self.conv1 = Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                            in_channels=in_channels)
        self.bn2 = BatchNorm(in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = BatchNorm(in_channels=mid)
        self.conv3 = Conv2D(channels, kernel_size=1, strides=1,
                            use_bias=False, in_channels=mid)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = ops.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = ops.activation(self.bn2(self.conv1(x)), act_type="relu")
        x = ops.activation(self.bn3(self.conv2(x)), act_type="relu")
        return self.conv3(x) + residual


def _stage(block, num_layer, channels, stride, index, in_channels):
    stage = HybridSequential(prefix=f"stage{index}_")
    with stage.name_scope():
        stage.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(num_layer - 1):
            stage.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return stage


class _ZooNet(HybridBlock):
    """A zoo net: ``output(features(x))``, and its parameter names."""

    _io = "tensor"

    def forward(self, x):
        return self.output(self.features(x))

    def jax_names(self) -> Dict[str, str]:
        """{state-dict key: the ``collect_params()`` name without the net's
        prefix}, running stats included."""
        n = len(self.prefix)
        return {k: p.name[n:]
                for k, p in self._collect_params_with_prefix().items()}


class ResNetV2(_ZooNet):
    """Input BatchNorm (no scale, no center), stem, four pre-activation
    stages, BN, ReLU, global average pool and flatten, then ``output``."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV2: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{channels}")
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(BatchNorm(scale=False, center=False,
                                        in_channels=_IMAGE_CHANNELS))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, _IMAGE_CHANNELS))
            else:
                self.features.add(
                    Conv2D(channels[0], 7, 2, 3, use_bias=False,
                           in_channels=_IMAGE_CHANNELS),
                    BatchNorm(in_channels=channels[0]),
                    Activation("relu"), MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                self.features.add(_stage(block, num_layer, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         in_channels))
                in_channels = channels[i + 1]
            self.features.add(BatchNorm(in_channels=in_channels),
                              Activation("relu"), GlobalAvgPool2D(),
                              Flatten())
            self.output = Dense(classes, in_units=in_channels)


class ResNetV1(_ZooNet):
    """``features`` (stem, four stages, global average pool) then the
    ``output`` Dense layer over the flattened pool."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV1: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{channels}")
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, _IMAGE_CHANNELS))
            else:
                self.features.add(
                    Conv2D(channels[0], 7, 2, 3, use_bias=False,
                           in_channels=_IMAGE_CHANNELS),
                    BatchNorm(in_channels=channels[0]),
                    Activation("relu"), MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                self.features.add(_stage(block, num_layer, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         channels[i]))
            self.features.add(GlobalAvgPool2D())
            self.output = Dense(classes, in_units=channels[-1])


_SPEC = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
         34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
         50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
         101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
         152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}
_NETS = {1: ResNetV1, 2: ResNetV2}
_BLOCKS = {1: {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
           2: {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """A ResNet v1 or v2 of depth 18, 34, 50, 101 or 152 with random
    weights (load yours with ``carrier.load_jax_params``)."""
    if num_layers not in _SPEC:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    if version not in (1, 2):
        raise MXNetError("version must be 1 or 2")
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; load "
                         "parameters with load_jax_params()")
    block_type, layers, channels = _SPEC[num_layers]
    return _NETS[version](_BLOCKS[version][block_type], layers, channels,
                          **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)


# ---------------------------------------------------------------------------
# weight carrier: the ResNetV1 a ``collect_params()`` dict implies
# ---------------------------------------------------------------------------
def _spec_from_names(shapes: Dict[str, tuple]):
    """(block, layers, channels, classes, thumbnail) of the ResNetV1 whose
    ``collect_params()`` names (prefix stripped) and shapes these are."""
    try:
        stem = shapes["conv2d0_weight"]
        classes = shapes["dense0_weight"][0]
    except KeyError as e:
        raise MXNetError(f"not a ResNetV1 parameter set: {e!r}") from None
    stages = sorted({int(m.group(1)) for m in
                     (re.match(r"stage(\d+)_", k) for k in shapes) if m})
    if stages != list(range(1, len(stages) + 1)) or not stages:
        raise MXNetError(f"not a ResNetV1 parameter set: stages {stages}")
    block, layers, channels = None, [], [stem[0]]
    for s in stages:
        convs = {int(m.group(1)): v for k, v in shapes.items()
                 for m in [re.fullmatch(rf"stage{s}_conv2d(\d+)_weight", k)]
                 if m}
        if 0 not in convs:
            raise MXNetError(f"not a ResNetV1 parameter set: stage {s} has "
                             "no conv2d0")
        kind = BottleneckV1 if convs[0][2] == 1 else BasicBlockV1
        if block not in (None, kind):
            raise MXNetError("not a ResNetV1 parameter set: stages of two "
                             "block kinds")
        block = kind
        per = 3 if kind is BottleneckV1 else 2
        layers.append(len(convs) // per)
        channels.append(convs[per - 1][0] if per - 1 in convs else 0)
    return block, layers, channels, classes, stem[2] == 3


def state_from_jax(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``carrier.params_from_jax`` for a ResNetV1's ``collect_params()``
    names: the state dict of the ResNetV1 the names and shapes imply,
    running stats included. Raises MXNetError unless they are exactly
    that net's."""
    shapes = {re.sub(r"^resnetv1\d*_", "", k): tuple(np.shape(v))
              for k, v in named.items()}
    block, layers, channels, classes, thumbnail = _spec_from_names(shapes)
    ref = ResNetV1(block, layers, channels, classes=classes,
                   thumbnail=thumbnail)
    keyed = rename_from_jax(ref.jax_names(), named, "a ResNetV1")
    check_against({k: p.shape for k, p in
                   ref._collect_params_with_prefix().items()},
                  {k: tuple(np.shape(v)) for k, v in keyed.items()},
                  "a ResNetV1")
    return {k: to_tensor(v) for k, v in keyed.items()}
