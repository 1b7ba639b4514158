"""Basic layers of the port as ``torch.nn.Module``s: the counterparts of
``Dense``, ``Dropout``, ``LayerNorm`` and ``Embedding`` in
``mxnet_tpu/gluon/nn/basic_layers.py``, with the JAX package's parameter
names and layouts (Dense weight is (out, in); LayerNorm has gamma/beta), so
``state_dict()`` keys match its ``_collect_params_with_prefix()`` names.

Shapes are given at construction (no deferred initialization). Initial
weights are random; served models load theirs (see
``model_zoo.bert.load_jax_params``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...ops import nn as ops

__all__ = ["Dense", "Dropout", "LayerNorm", "Embedding"]

_ACTIVATIONS = {"tanh": torch.tanh}


class Dense(nn.Module):
    """Fully-connected layer: y = act(x W^T + b), weight (units, in_units)."""

    def __init__(self, units: int, activation=None, flatten: bool = True,
                 in_units: int = 0, device=None):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense needs in_units > 0 (the port has no "
                             "deferred shape inference)")
        if activation is not None and activation not in _ACTIVATIONS:
            raise MXNetError(f"activation {activation!r} is not ported; "
                             f"expected one of {sorted(_ACTIVATIONS)}")
        self._flatten = flatten
        self._act = activation
        self.weight = nn.Parameter(torch.empty(units, in_units, device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, in_units ** -0.5)
        self.bias = nn.Parameter(torch.zeros(units, device=device))

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        return _ACTIVATIONS[self._act](out) if self._act else out


class Dropout(nn.Module):
    """Dropout with rate ``rate``; the identity in eval mode (serving)."""

    def __init__(self, rate: float):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        if not self.training or self._rate <= 0:
            return x
        return torch.nn.functional.dropout(x, self._rate, training=True)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with parameters ``gamma`` (ones) and
    ``beta`` (zeros), eps 1e-5."""

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(in_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=device))

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta)


class Embedding(nn.Module):
    """Lookup table with weight (input_dim, output_dim)."""

    def __init__(self, input_dim: int, output_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim,
                                               device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02)

    def forward(self, x):
        return ops.embedding(x, self.weight)
