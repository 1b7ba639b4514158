"""Fused recurrent layers of the port (the counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and ``GRU`` over
the RNN op (``ops.nn.rnn``), every layer's weights in one flat
``parameters`` vector in the reference's layout, so the structural name is
``<layer>.parameters`` and the JAX package's vector loads as it is.

Called with an input alone the layer starts from zero states and returns
the output; called with states (a list, or the states as further
arguments) it returns ``(output, new_states)``, the truncated-BPTT form.
``layout`` is "TNC" (the default) or "NTC". ``dropout`` is passed to the
op, which, as in the reference, does not apply it between layers (ROADMAP
Queue 3); put ``nn.Dropout`` blocks around the layer instead.
"""
from __future__ import annotations

import torch

from ... import amp as _amp
from ...base import DTypes, MXNetError
from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    _io = "tensor"

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"invalid layout {layout}; must be TNC or NTC")
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        with self.name_scope():
            size = ops.rnn_param_size(mode, num_layers, input_size,
                                      hidden_size, bidirectional) \
                if input_size else 0
            # registered as the reference's ``parameters`` but held as
            # ``_flat``: the attribute would hide ``Module.parameters()``
            self._register_param("parameters", self.params.get(
                "parameters", shape=(size,), init=i2h_weight_initializer,
                dtype=dtype, allow_deferred_init=True), attr="_flat")

    def infer_shape(self, x, *states):
        self._input_size = x.shape[2]
        self._flat.shape = (ops.rnn_param_size(
            self._mode, self._num_layers, self._input_size,
            self._hidden_size, self._dir == 2),)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"}] * n

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states as NDArrays on ``ctx`` (default the current
        context)."""
        from ... import ndarray as nd
        return [nd.zeros(info["shape"], ctx=ctx, dtype=self._dtype)
                for info in self.state_info(batch_size)]

    def forward(self, x, *states):
        if len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = tuple(states[0])
        skip_states = not states
        if skip_states:
            batch = x.shape[0] if self._layout == "NTC" else x.shape[1]
            states = [torch.zeros(info["shape"],
                                  dtype=DTypes.torch(self._dtype),
                                  device=x.device)
                      for info in self.state_info(batch)]
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        out = _amp.call("RNN", x, self._t("parameters"), states[0],
                        states[1] if self._mode == "lstm" else None,
                        state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2, mode=self._mode,
                        p=self._dropout, state_outputs=True)
        output, new_states = out[0], list(out[1:])
        if self._layout == "NTC":
            output = output.transpose(0, 1)
        return output if skip_states else (output, new_states)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._input_size} -> " \
               f"{self._hidden_size}, {self._layout}, layers=" \
               f"{self._num_layers}{', bidirectional' if self._dir == 2 else ''})"


class RNN(_RNNLayer):
    """Elman RNN layer, relu (default) or tanh activation."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, f"rnn_{activation}",
                         **kwargs)


class LSTM(_RNNLayer):
    """LSTM layer (gates i, f, g, o)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """GRU layer (gates r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
