"""DLRM, the deep-learning recommendation model (Naumov et al.), as a Gluon
block (the counterpart of ``mxnet_tpu/gluon/model_zoo/dlrm.py``).

The serving twin of ``mxnet_tpu_torch.embedding.workload``: bottom MLP over
the dense features, pairwise dot interactions of the embedding rows with
the bottom MLP's output, top MLP over their concatenation. It agrees with
``workload.dlrm_forward`` on the factorization (the same tower widths, the
same lower-triangular interaction set), so a table and towers trained
through the sharded step serve through this block unchanged (each Dense's
weight is the step's (in, out) weight transposed).

The embedding is a plain ``nn.Embedding`` (``sparse_grad=True`` gives it
row-sparse gradients for the Trainer's sparse path).
"""
from __future__ import annotations

import numpy as onp
import torch

from ..block import HybridBlock
from ..nn import Dense, Embedding

__all__ = ["DLRM", "dlrm_tiny"]


class DLRM(HybridBlock):
    """``forward(dense, indices) -> (B, 1)`` click logits.

    Parameters
    ----------
    vocab_size : int
        Sparse id space (one table shared by the fields).
    num_fields : int
        Sparse fields per example; interactions run over the F+1 vectors
        (F embeddings and the bottom MLP's output).
    dense_in : int
        Dense feature width.
    embed_dim, bot_hidden, top_hidden : int
        Tower widths; the bottom MLP projects the dense features to
        ``embed_dim`` so they join the interactions.
    sparse_grad : bool
        Row-sparse gradients for the table.
    """

    _io = "tensor"

    def __init__(self, vocab_size, num_fields, dense_in, embed_dim=16,
                 bot_hidden=64, top_hidden=64, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._vocab = int(vocab_size)
        self._fields = int(num_fields)
        self._dim = int(embed_dim)
        k = self._fields + 1
        self._li, self._lj = onp.tril_indices(k, k=-1)
        with self.name_scope():
            self.embedding = Embedding(vocab_size, embed_dim,
                                       sparse_grad=sparse_grad)
            self.bot1 = Dense(bot_hidden, activation="relu",
                              in_units=dense_in)
            self.bot2 = Dense(embed_dim, activation="relu",
                              in_units=bot_hidden)
            self.top1 = Dense(top_hidden, activation="relu",
                              in_units=embed_dim + len(self._li))
            self.top2 = Dense(1, in_units=top_hidden)

    def forward(self, dense, indices):
        bot = self.bot2(self.bot1(dense))                    # (B, D)
        emb = self.embedding(indices)                        # (B, F, D)
        z = torch.cat([bot.reshape(-1, 1, self._dim), emb], dim=1)
        zz = torch.bmm(z, z.transpose(1, 2))                 # (B, F+1, F+1)
        li, lj = (torch.as_tensor(a, device=z.device)
                  for a in (self._li, self._lj))
        top = torch.cat([bot, zz[:, li, lj]], dim=1)
        return self.top2(self.top1(top))

    def __repr__(self):
        return (f"DLRM(vocab={self._vocab}, fields={self._fields}, "
                f"dim={self._dim})")


def dlrm_tiny(**kwargs):
    """The reference's bench and load-generator configuration: small enough
    to step on one CPU device, interaction-heavy enough to exercise the
    real profile."""
    cfg = dict(vocab_size=1 << 14, num_fields=8, dense_in=13, embed_dim=16,
               bot_hidden=64, top_hidden=64)
    cfg.update(kwargs)
    return DLRM(**cfg)
