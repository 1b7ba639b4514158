"""Recurrent cells of the port (the counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``): ``RNNCell``, ``LSTMCell`` and
``GRUCell`` (one step: ``cell(x, states) -> (output, new_states)``, the
gates in the reference's order and arithmetic), the containers
``SequentialRNNCell``/``HybridSequentialRNNCell`` and
``BidirectionalCell``, and the modifiers ``DropoutCell``, ``ZoneoutCell``
and ``ResidualCell``.

Cells compute on tensors and take NDArrays as every block does
(``block.py``); ``begin_state`` gives NDArrays and ``unroll`` steps a cell
over NDArray inputs (a (N, T, C) or (T, N, C) array, or a list of (N, C)
steps), as the reference's. Masks (dropout, zoneout) draw from
``random.generator`` of the input's context in a Gluon call.
"""
from __future__ import annotations

import torch

from ...ops import nn as ops
from ..block import HybridBlock
from ..nn.basic_layers import mask_generator

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _steps(inputs, length, axis):
    """The per-step (N, C) NDArrays of ``inputs`` along ``axis``."""
    from ... import ndarray as nd
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    return [nd.squeeze(nd.take(inputs, nd.array([i], dtype="int32"),
                               axis=axis), axis=axis)
            for i in range(length)]


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state`` and ``unroll``."""

    _io = "tensor"

    def reset(self):
        """Clear per-sequence state (the zoneout cell's last output) in
        this cell and its children."""
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """Zero states as NDArrays on ``ctx``."""
        from ... import ndarray as nd
        return [nd.zeros(info["shape"], ctx=ctx)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of NDArray ``inputs``:
        (outputs, states), outputs a list of steps or, with
        ``merge_outputs``, stacked along ``layout``'s T; ``valid_length``
        zeroes each sequence's outputs past its length."""
        from ... import ndarray as nd
        self.reset()
        axis = layout.find("T")
        seq = _steps(inputs, length, axis)
        batch_size = seq[0].shape[0]
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=seq[0].context)
        states = begin_state
        outputs = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
        if valid_length is not None:
            outputs = nd.SequenceMask(nd.stack(*outputs, axis=axis),
                                      valid_length, use_sequence_length=True,
                                      axis=axis)
            if merge_outputs is False:
                outputs = [nd.squeeze(o, axis=axis) for o in
                           nd.split(outputs, length, axis=axis)]
        elif merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states


HybridRecurrentCell = RecurrentCell


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


class _GatedCell(RecurrentCell):
    """A cell with i2h and h2h weights of ``gates * hidden_size`` rows and
    their biases (zeros by the global initializer's bias rule)."""

    def __init__(self, hidden_size, gates, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._gates = gates
        self._input_size = input_size
        g = gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get("i2h_bias", shape=(g,),
                                            allow_deferred_init=True)
            self.h2h_bias = self.params.get("h2h_bias", shape=(g,),
                                            allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _projections(self, inputs, h):
        return (ops.fully_connected(inputs, self._t("i2h_weight"),
                                    self._t("i2h_bias")),
                ops.fully_connected(h, self._t("h2h_weight"),
                                    self._t("h2h_bias")))


class RNNCell(_GatedCell):
    """h' = act(x W_i2h^T + b_i2h + h W_h2h^T + b_h2h)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, 1, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, prefix, params)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        output = ops.activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """One LSTM step, gates i, f, g, o; states [h, c]."""

    def __init__(self, hidden_size, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None,
                 activation="tanh", recurrent_activation="sigmoid"):
        super().__init__(hidden_size, 4, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, dim=1)
        next_c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * \
            torch.tanh(g)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """One GRU step, gates r, z, n; states [h]."""

    def __init__(self, hidden_size, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None):
        super().__init__(hidden_size, 3, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, prefix, params)

    def forward(self, inputs, states):
        prev_h = states[0]
        i2h, h2h = self._projections(inputs, prev_h)
        i2h_r, i2h_z, i2h_n = i2h.chunk(3, dim=1)
        h2h_r, h2h_z, h2h_n = h2h.chunk(3, dim=1)
        reset_gate = torch.sigmoid(i2h_r + h2h_r)
        update_gate = torch.sigmoid(i2h_z + h2h_z)
        next_h_tmp = torch.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own
    states."""

    _io = None

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def forward(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, list(states[pos:pos + n]))
            pos += n
            next_states.extend(state)
        return inputs, next_states


class HybridSequentialRNNCell(SequentialRNNCell):
    """The hybrid name of ``SequentialRNNCell`` (same machinery)."""


class DropoutCell(RecurrentCell):
    """Dropout on the step's input in training mode; no states."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self.training and self._rate > 0:
            inputs = ops.dropout(inputs, p=self._rate, axes=self._axes,
                                 training=True,
                                 generator=mask_generator(None, inputs))
        return inputs, states


class ModifierCell(RecurrentCell):
    """A cell around ``base_cell``, whose states it keeps."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        return self.base_cell.begin_state(batch_size, func, ctx=ctx,
                                          **kwargs)


class ZoneoutCell(ModifierCell):
    """Zoneout: in training mode each output (state) element keeps its
    previous value with probability ``zoneout_outputs``
    (``zoneout_states``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def _keep_new(self, p, like):
        """Nonzero where the new value is kept (a dropout mask of ones;
        all ones outside training)."""
        if not self.training:
            return torch.ones_like(like)
        return ops.dropout(torch.ones_like(like), p=p, training=True,
                           generator=mask_generator(None, like))

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        prev_output = self._prev_output if self._prev_output is not None \
            else torch.zeros_like(next_output)
        output = next_output
        if self.zoneout_outputs > 0.0:
            m = self._keep_new(self.zoneout_outputs, next_output)
            output = torch.where(m != 0, next_output, prev_output)
        if self.zoneout_states > 0.0:
            next_states = [
                torch.where(self._keep_new(self.zoneout_states, ns) != 0, ns,
                            s) for ns, s in zip(next_states, states)]
        self._prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """Two cells over a sequence, ``l_cell`` forward and ``r_cell``
    backward, their outputs concatenated per step (``unroll`` only)."""

    _io = None

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._modules.values(), batch_size)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        self.reset()
        axis = layout.find("T")
        seq = _steps(inputs, length, axis)
        l_cell, r_cell = self._modules.values()
        if begin_state is None:
            begin_state = self.begin_state(seq[0].shape[0],
                                           ctx=seq[0].context)
        n_l = len(l_cell.state_info())
        sub_layout = "NTC" if axis == 1 else layout
        l_out, l_states = l_cell.unroll(length, seq, begin_state[:n_l],
                                        layout=sub_layout,
                                        merge_outputs=False)
        r_out, r_states = r_cell.unroll(length, list(reversed(seq)),
                                        begin_state[n_l:], layout=sub_layout,
                                        merge_outputs=False)
        outputs = [nd.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
