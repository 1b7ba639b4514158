"""The LSTM word language model of ``examples/rnn/lstm_lm.py``
(``LSTMLanguageModel``: ``Embedding`` -> ``rnn.LSTM(layout="NTC")`` ->
``Dense(flatten=False)``), written with the port's layers, with dropout on
the embedding's and the LSTM's outputs as ``nn.Dropout`` blocks and the
states carried between calls (truncated BPTT).

``ptb_medium()`` is the "medium" configuration of Zaremba, Sutskever and
Vinyals (2014), "Recurrent Neural Network Regularization", on the Penn
Treebank: 2 layers, embedding and hidden width 650, a 10,000-word
vocabulary, dropout 0.5 (trained there with BPTT length 35, batch 20,
SGD at learning rate 1, gradients clipped at norm 5, weights uniform in
[-0.05, 0.05]).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...base import MXNetError
from ...ops.nn import rnn_param_size
from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding
from ..rnn import LSTM

__all__ = ["LSTMLanguageModel", "ptb_medium", "PTB_MEDIUM",
           "state_from_jax"]

PTB_MEDIUM = dict(vocab=10000, embed=650, hidden=650, layers=2, dropout=0.5)


class LSTMLanguageModel(HybridBlock):
    """tokens (N, T) -> logits (N, T, vocab); with ``states`` (the LSTM's
    [h, c], each (layers, N, hidden)) also the new states."""

    _io = "tensor"

    def __init__(self, vocab, embed=64, hidden=128, layers=2, dropout=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.embedding = Embedding(vocab, embed)
            self.drop_in = Dropout(dropout)
            self.lstm = LSTM(hidden, num_layers=layers, layout="NTC")
            self.drop_out = Dropout(dropout)
            self.decoder = Dense(vocab, flatten=False)

    def begin_state(self, batch_size, ctx=None):
        """Zero [h, c] as NDArrays on ``ctx``."""
        return self.lstm.begin_state(batch_size, ctx=ctx)

    def forward(self, tokens, states=None):
        h = self.drop_in(self.embedding(tokens))
        if states is None:
            return self.decoder(self.drop_out(self.lstm(h)))
        h, states = self.lstm(h, states)
        return self.decoder(self.drop_out(h)), states


def ptb_medium(**kwargs) -> LSTMLanguageModel:
    """``LSTMLanguageModel`` at the PTB "medium" width (``PTB_MEDIUM``)."""
    return LSTMLanguageModel(**{**PTB_MEDIUM, **kwargs})


_NAMES = {"embedding.weight", "lstm.parameters", "decoder.weight",
          "decoder.bias"}


def state_from_jax(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``carrier.params_from_jax`` for an LSTMLanguageModel's names: the
    widths from the embedding and decoder, the depth from the length of
    the flat LSTM vector; raises MXNetError unless the names and shapes
    are exactly one such model's."""
    from .carrier import check_against, to_tensor
    shapes = {k: tuple(np.shape(v)) for k, v in named.items()}
    if set(shapes) != _NAMES:
        raise MXNetError(f"parameters do not match an LSTMLanguageModel: "
                         f"names {sorted(shapes)}")
    vocab, embed = shapes["embedding.weight"]
    hidden = shapes["decoder.weight"][1]
    size = shapes["lstm.parameters"][0]
    layers = next((n for n in range(1, 17) if rnn_param_size(
        "lstm", n, embed, hidden, False) == size), 0)
    want = {"embedding.weight": (vocab, embed),
            "lstm.parameters": (rnn_param_size("lstm", max(layers, 1), embed,
                                               hidden, False),),
            "decoder.weight": (vocab, hidden), "decoder.bias": (vocab,)}
    check_against(want, shapes, "an LSTMLanguageModel")
    return {k: to_tensor(v) for k, v in named.items()}
