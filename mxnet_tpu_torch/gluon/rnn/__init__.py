"""Recurrent layers and cells of the port (the counterpart of
``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, HybridSequentialRNNCell,
                       LSTMCell, ModifierCell, RecurrentCell, ResidualCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "HybridRecurrentCell",
           "ModifierCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]
