"""ResNet v1 of the port: the counterpart of ``BasicBlockV1``,
``BottleneckV1``, ``ResNetV1``, ``get_resnet`` and ``resnet50_v1`` in
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``.

The module tree mirrors the JAX block tree, so ``state_dict()`` keys equal
the JAX package's ``_collect_params_with_prefix()`` names (for example
``features.4.0.body.0.weight``), and :meth:`ResNetV1.jax_names` gives each
key's ``collect_params()`` name (``resnetv10_stage1_conv2d0_weight`` without
the net's prefix): 299 parameters and running stats for ``resnet50_v1``.
The bottleneck's 1x1 convolutions carry a bias, as the reference's.

The convolutions are library convolutions (cuDNN), as they are XLA's in the
JAX package; the net is not fused. ``ops.cuda.fused_conv1x1`` (K4) computes
its conv -> BatchNorm -> ReLU chain at a bottleneck's last 1x1 conv as a
separate op. Images have 3 channels (the reference infers the first conv's
input channels from the data). V2 is not ported yet.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from ....base import MXNetError
from ....ops import nn as ops
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)
from ..carrier import check_against, rename_from_jax, to_tensor

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "state_from_jax"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, device):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, device=device)


def _downsample(channels, stride, in_channels, device):
    ds = HybridSequential()
    ds.add(Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                  in_channels=in_channels, device=device),
           BatchNorm(in_channels=channels, device=device))
    return ds


class BasicBlockV1(nn.Module):
    """Two 3x3 convolutions with BatchNorm and a residual (ResNet-18/34)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None):
        super().__init__()
        self.body = HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, device),
                      BatchNorm(in_channels=channels, device=device),
                      Activation("relu"),
                      _conv3x3(channels, 1, channels, device),
                      BatchNorm(in_channels=channels, device=device))
        self.downsample = _downsample(channels, stride, in_channels, device) \
            if downsample else None

    def forward(self, x):
        residual = self.downsample(x) if self.downsample is not None else x
        return ops.activation(residual + self.body(x), act_type="relu")


class BottleneckV1(nn.Module):
    """1x1 (stride here, as v1) -> 3x3 -> 1x1 with BatchNorms and ReLUs,
    plus a residual: ResNet-50/101/152's block. ``body[3]`` is the 3x3
    convolution, ``body[4]`` its BatchNorm, ``body[6]`` the last 1x1
    convolution and ``body[7]`` its BatchNorm."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None):
        super().__init__()
        mid = channels // 4
        self.body = HybridSequential()
        self.body.add(Conv2D(mid, kernel_size=1, strides=stride,
                             in_channels=in_channels, device=device),
                      BatchNorm(in_channels=mid, device=device),
                      Activation("relu"),
                      _conv3x3(mid, 1, mid, device),
                      BatchNorm(in_channels=mid, device=device),
                      Activation("relu"),
                      Conv2D(channels, kernel_size=1, strides=1,
                             in_channels=mid, device=device),
                      BatchNorm(in_channels=channels, device=device))
        self.downsample = _downsample(channels, stride, in_channels, device) \
            if downsample else None

    def forward(self, x):
        residual = self.downsample(x) if self.downsample is not None else x
        return ops.activation(self.body(x) + residual, act_type="relu")


class ResNetV1(nn.Module):
    """``features`` (stem, four stages, global average pool) then the
    ``output`` Dense layer over the flattened pool."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError(f"ResNetV1: {len(layers)} stages need "
                             f"{len(layers) + 1} channel counts, got "
                             f"{channels}")
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, _IMAGE_CHANNELS,
                                       device))
        else:
            self.features.add(
                Conv2D(channels[0], 7, 2, 3, use_bias=False,
                       in_channels=_IMAGE_CHANNELS, device=device),
                BatchNorm(in_channels=channels[0], device=device),
                Activation("relu"), MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stage = HybridSequential(prefix=f"stage{i + 1}_")
            stride = 1 if i == 0 else 2
            stage.add(block(channels[i + 1], stride,
                            channels[i + 1] != channels[i],
                            in_channels=channels[i], device=device))
            for _ in range(num_layer - 1):
                stage.add(block(channels[i + 1], 1, False,
                                in_channels=channels[i + 1], device=device))
            self.features.add(stage)
        self.features.add(GlobalAvgPool2D())
        self.output = Dense(classes, in_units=channels[-1], device=device)

    def forward(self, x):
        return self.output(self.features(x))

    def jax_names(self) -> Dict[str, str]:
        """{state-dict key: the JAX package's ``collect_params()`` name
        without the net's ``resnetv1N_`` prefix}. Names follow the
        reference's name scopes: one counter per layer kind (conv2d,
        batchnorm, dense) at the top and one per stage (``stage1_``...),
        counted in the order the layers were created."""
        kinds = ((Conv2D, "conv2d"), (BatchNorm, "batchnorm"),
                 (Dense, "dense"))
        names = {}

        def visit(mod, path, scope, counts):
            for name, child in mod.named_children():
                key = f"{path}{name}"
                kind = next((k for t, k in kinds if isinstance(child, t)),
                            None)
                if kind is not None:
                    i = counts.get(kind, 0)
                    counts[kind] = i + 1
                    for p in child.state_dict():
                        names[f"{key}.{p}"] = f"{scope}{kind}{i}_{p}"
                elif isinstance(child, HybridSequential) and child.prefix:
                    visit(child, key + ".", scope + child.prefix, {})
                else:
                    visit(child, key + ".", scope, counts)

        visit(self, "", "", {})
        return names


_SPEC = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
         34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
         50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
         101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
         152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """A ResNet v1 of depth 18, 34, 50, 101 or 152 with random weights
    (load yours with ``carrier.load_jax_params``)."""
    if num_layers not in _SPEC:
        raise MXNetError(f"invalid resnet depth {num_layers}")
    if version != 1:
        raise MXNetError("ResNet v2 is not ported yet; version must be 1")
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; load "
                         "parameters with load_jax_params()")
    block_type, layers, channels = _SPEC[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


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
                   thumbnail=thumbnail, device="meta")
    keyed = rename_from_jax(ref.jax_names(), named, "a ResNetV1")
    check_against({k: tuple(v.shape) for k, v in ref.state_dict().items()},
                  {k: tuple(np.shape(v)) for k, v in keyed.items()},
                  "a ResNetV1")
    return {k: to_tensor(v) for k, v in keyed.items()}
