"""Losses of the port: ``SoftmaxCrossEntropyLoss`` of
``mxnet_tpu/gluon/loss.py`` as far as ``bench.py``'s ResNet training uses
it."""
from __future__ import annotations

from torch import nn

from ..base import MXNetError
from ..ops import nn as ops

__all__ = ["SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class SoftmaxCrossEntropyLoss(nn.Module):
    """Softmax cross-entropy over sparse labels: -log_softmax(pred)[label]
    along the last axis, the log-softmax computed in f32 and cast back to
    pred's dtype (``ops.nn.log_softmax``), then the mean over every axis but
    the batch axis. Labels may be any numeric dtype (class indices). Dense
    labels, ``from_logits``, another axis and weights are not ported."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__()
        if axis != -1 or not sparse_label or from_logits or \
                weight is not None:
            raise MXNetError("SoftmaxCrossEntropyLoss: only axis=-1 with "
                             "sparse labels, from_logits=False and no "
                             "weight are ported")
        self._batch_axis = batch_axis

    def forward(self, pred, label):
        loss = -ops.pick(ops.log_softmax(pred, axis=-1), label, axis=-1)
        rest = [d for d in range(loss.dim()) if d != self._batch_axis]
        return loss.mean(dim=rest) if rest else loss


SoftmaxCELoss = SoftmaxCrossEntropyLoss
