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
    """Dropout with rate ``rate``: in training mode each element is kept
    with probability 1 - rate and divided by 1 - rate; the identity in
    eval mode (serving) and at rate 0.

    The mask is drawn from ``self.generator``, a ``torch.Generator`` on the
    input's device that the caller sets (``ParallelTrainStep`` gives every
    Dropout of its block the one it owns), never from PyTorch's global RNG;
    training mode at a nonzero rate without one raises."""

    def __init__(self, rate: float):
        super().__init__()
        self._rate = float(rate)
        #: the ``torch.Generator`` masks are drawn from (set by the caller)
        self.generator = None

    def forward(self, x):
        if not self.training or self._rate <= 0:
            return x
        if self.generator is None:
            raise MXNetError("Dropout in training mode needs a torch.Generator "
                             "(set .generator); it never draws from the "
                             "global RNG")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self._rate
        # the reference's mask: bernoulli in x's dtype, divided by 1 - rate
        return x * (keep.to(x.dtype) / (1.0 - self._rate))


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
