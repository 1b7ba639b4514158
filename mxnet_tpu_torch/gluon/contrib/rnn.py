"""gluon.contrib.rnn of the port (the counterpart of
``mxnet_tpu/gluon/contrib/rnn.py``): ``VariationalDropoutCell`` and
``LSTMPCell``, over ``gluon.rnn``'s ``ModifierCell`` and
``RecurrentCell``."""
from __future__ import annotations

import torch

from ... import amp as _amp
from ...ops import nn as ops
from ..nn.basic_layers import mask_generator
from ..rnn.rnn_cell import ModifierCell, RecurrentCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout: one mask per sequence for the inputs,
    the first state and the outputs, drawn at the sequence's first step
    and reused at every later one until :meth:`reset` (``unroll`` resets).
    Outside training the masks are ones.

    Masks draw from ``self.generator`` when a caller set one, else, in a
    Gluon (NDArray) call, from ``random.generator`` of the input's context;
    never from PyTorch's global generator."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        #: the ``torch.Generator`` masks are drawn from (set by the caller)
        self.generator = None
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _mask(self, p, like):
        """A dropout of ones shaped like ``like``: the scaled Bernoulli
        mask (ones outside training)."""
        ones = torch.ones_like(like)
        if not self.training:
            return ones
        return _amp.call("Dropout", ones, p=p, training=True,
                         generator=mask_generator(self.generator, like))

    def forward(self, inputs, states):
        if self.drop_inputs > 0.0:
            if self._input_mask is None:
                self._input_mask = self._mask(self.drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self.drop_states > 0.0:
            if self._state_mask is None:
                self._state_mask = self._mask(self.drop_states, states[0])
            states = [states[0] * self._state_mask] + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs > 0.0:
            if self._output_mask is None:
                self._output_mask = self._mask(self.drop_outputs, output)
            output = output * self._output_mask
        return output, next_states

    def __repr__(self):
        return (f"VariationalDropoutCell(in={self.drop_inputs}, "
                f"state={self.drop_states}, out={self.drop_outputs})")


class LSTMPCell(RecurrentCell):
    """LSTM with a projected hidden state (Sak et al.'s LSTMP): the cell
    state has ``hidden_size``, the recurrent output is projected to
    ``projection_size`` by ``h2r_weight``; states [r, c]."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        g = 4 * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, projection_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get("i2h_bias", shape=(g,),
                                            allow_deferred_init=True)
            self.h2h_bias = self.params.get("h2h_bias", shape=(g,),
                                            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def forward(self, inputs, states):
        gates = ops.fully_connected(inputs, self._t("i2h_weight"),
                                    self._t("i2h_bias")) + \
            ops.fully_connected(states[0], self._t("h2h_weight"),
                                self._t("h2h_bias"))
        i, f, g, o = gates.chunk(4, dim=1)
        next_c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * \
            torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(next_c)
        next_r = ops.fully_connected(hidden, self._t("h2r_weight"), None,
                                     no_bias=True)
        return next_r, [next_r, next_c]

    def __repr__(self):
        return f"LSTMPCell({self._hidden_size} -> {self._projection_size})"
