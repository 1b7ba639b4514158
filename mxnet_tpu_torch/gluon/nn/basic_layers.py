"""Basic layers of the port as ``torch.nn.Module``s: the counterparts of
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``, ``LayerNorm``,
``Embedding``, ``Flatten`` and ``Activation`` in
``mxnet_tpu/gluon/nn/basic_layers.py``, with the JAX package's parameter
names and layouts (Dense weight is (out, in); LayerNorm has gamma/beta;
BatchNorm gamma/beta/running_mean/running_var), so ``state_dict()`` keys
match its ``_collect_params_with_prefix()`` names.

Shapes are given at construction (no deferred initialization). Initial
weights are random; served models load theirs (see
``model_zoo.bert.load_jax_params``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...ops import nn as ops

__all__ = ["HybridSequential", "Dense", "Dropout", "BatchNorm", "LayerNorm",
           "Embedding", "Flatten", "Activation"]


class HybridSequential(nn.Sequential):
    """Blocks run in order; children are named "0", "1", ... as the
    reference's. ``prefix`` is the reference's name scope (``"stage1_"``),
    kept for the names of the weight carrier."""

    def __init__(self, prefix: str = ""):
        super().__init__()
        self.prefix = prefix

    def add(self, *blocks):
        for b in blocks:
            self.append(b)


class Dense(nn.Module):
    """Fully-connected layer: y = act(x W^T + b), weight (units, in_units);
    ``activation`` is a name ``ops.nn.activation`` takes."""

    def __init__(self, units: int, activation=None, flatten: bool = True,
                 in_units: int = 0, device=None):
        super().__init__()
        if in_units <= 0:
            raise MXNetError("Dense needs in_units > 0 (the port has no "
                             "deferred shape inference)")
        self._flatten = flatten
        self._act = activation
        self.weight = nn.Parameter(torch.empty(units, in_units, device=device))
        with torch.no_grad():
            self.weight.normal_(0.0, in_units ** -0.5)
        self.bias = nn.Parameter(torch.zeros(units, device=device))

    def forward(self, x):
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        return ops.activation(out, act_type=self._act) if self._act else out


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


class BatchNorm(nn.Module):
    """Batch normalization over ``axis`` (channels of NCHW by default).

    ``gamma`` and ``beta`` are parameters (``scale=False`` means fix_gamma:
    gamma is taken as 1 and not trained; ``center=False`` leaves beta
    untrained). ``running_mean`` and ``running_var`` are float32 buffers:
    in training mode every forward writes the updated moving stats back into
    them, in place and without gradient (the reference's aux states). As
    ``BatchNorm.cast`` in the reference, a cast of the model to a half type
    leaves all four in float32."""

    def __init__(self, axis: int = 1, momentum: float = 0.9,
                 epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, use_global_stats: bool = False,
                 in_channels: int = 0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise MXNetError("BatchNorm needs in_channels > 0 (the port has "
                             "no deferred shape inference)")
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self.gamma = nn.Parameter(torch.ones(in_channels, device=device),
                                  requires_grad=scale)
        self.beta = nn.Parameter(torch.zeros(in_channels, device=device),
                                 requires_grad=center)
        self.register_buffer("running_mean",
                             torch.zeros(in_channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(in_channels, device=device))

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for t in list(self._parameters.values()):
            if t.dtype in (torch.bfloat16, torch.float16):
                t.data = t.data.float()
        for k, t in list(self._buffers.items()):
            if t.dtype in (torch.bfloat16, torch.float16):
                self._buffers[k] = t.float()
        return self

    def forward(self, x):
        out, new_mean, new_var = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            training=self.training, **self._kwargs)
        if self.training and not self._kwargs["use_global_stats"]:
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return out


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


class Flatten(nn.Module):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(nn.Module):
    """Elementwise activation by name (``ops.nn.activation``)."""

    def __init__(self, activation: str):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return ops.activation(x, act_type=self._act_type)
