"""Losses of the port as Gluon blocks (the counterpart of
``mxnet_tpu/gluon/loss.py``): the ``Loss`` base with its weighting
(``weight``, ``sample_weight``, ``batch_axis``), ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss``,
``KLDivLoss``, ``HuberLoss``, ``HingeLoss``, ``SquaredHingeLoss``,
``LogisticLoss``, ``TripletLoss``, ``PoissonNLLLoss``,
``CosineEmbeddingLoss``, ``CTCLoss`` and ``SDMLLoss``. Each returns one
loss per sample (the mean over every axis but ``batch_axis``, or the
sequence's or the pair's loss), as the reference; ``PoissonNLLLoss``
returns the mean. They compute on tensors and take NDArrays as every
block does.
"""
from __future__ import annotations

import math

import torch

from .. import amp as _amp
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "CTCLoss", "SDMLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_but(loss, axis):
    """The mean over every axis but ``axis`` (``mean(exclude=True)``)."""
    rest = [d for d in range(loss.dim()) if d != axis % max(loss.dim(), 1)]
    return loss.mean(dim=rest) if rest else loss


def _sum_but(loss, axis):
    rest = [d for d in range(loss.dim()) if d != axis % max(loss.dim(), 1)]
    return loss.sum(dim=rest) if rest else loss


def _softrelu(x):
    return torch.nn.functional.softplus(x)


class Loss(HybridBlock):
    """Base of the losses: ``weight`` scales every loss, ``batch_axis``
    is the axis kept by the per-sample mean."""

    _io = "tensor"

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{self.__class__.__name__}(batch_axis={self._batch_axis}, " \
               f"w={self._weight})"


class L2Loss(Loss):
    """weight / 2 * (label - pred)^2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _mean_but(loss, self._batch_axis)


class L1Loss(Loss):
    """|label - pred|."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (stable form), or on probabilities
    with ``from_sigmoid``; ``pos_weight`` weighs the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = pred.relu() - pred * label + _softrelu(-pred.abs())
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-pred.abs()) + (-pred).relu())
        else:
            eps = 1e-12
            pos = (pred + eps).log() * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + (1. - pred + eps).log() * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy: -log_softmax(pred)[label] along ``axis``
    (sparse labels: class indices of any numeric dtype) or -sum(log_softmax
    * label) (dense labels), the log-softmax in f32 and cast back to pred's
    dtype (``ops.nn.log_softmax``); ``from_logits`` takes pred as
    log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _amp.call("log_softmax", pred, axis=self._axis)
        if self._sparse_label:
            loss = -_amp.call("pick", pred, label, axis=self._axis)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log(label + 1e-12) - pred), pred log-probabilities
    (``from_logits``, the default) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _amp.call("log_softmax", pred, axis=self._axis)
        loss = label * ((label + 1e-12).log() - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


class HuberLoss(Loss):
    """|d| - rho/2 beyond ``rho``, d^2 / (2 rho) within."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = (label.reshape(pred.shape) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


class HingeLoss(Loss):
    """max(0, margin - pred * label), labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = (self._margin - pred * label.reshape(pred.shape)).relu()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred * label)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = (self._margin - pred * label.reshape(pred.shape)).relu() \
            .square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)) for ``signed`` labels in {-1, 1}, or
    binary labels in {0, 1}."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = pred.relu() - pred * label + _softrelu(-pred.abs())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


class TripletLoss(Loss):
    """max(0, ||pos - pred||^2 - ||neg - pred||^2 + margin) per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = _sum_but((positive - pred).square() -
                        (negative - pred).square(), self._batch_axis)
        loss = (loss + self._margin).relu()
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood (pred the log-rate with
    ``from_logits``), with Stirling's term for ``compute_full``; the mean
    over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = pred.exp() - target * pred
        else:
            loss = pred - target * (pred + epsilon).log()
        if self._compute_full:
            stirling = target * (target + epsilon).log() - target + \
                0.5 * (2 * target * math.pi + epsilon).log()
            loss = loss + torch.where(target <= 1,
                                      torch.zeros_like(stirling), stirling)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """1 - cos(x1, x2) for label 1, max(0, cos - margin) otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input1.shape[0], -1)
        input2 = input2.reshape(input2.shape[0], -1)
        cos = (input1 * input2).sum(dim=-1) / (
            input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos, (cos - self._margin).relu())
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification loss per sequence
    (``ops.nn.ctc_loss`` with the blank the last class): pred (N, T, C)
    unnormalised (``layout="TNC"``: (T, N, C)), label (N, L) classes
    padded with -1 (``label_layout="TN"``: (L, N)); ``pred_lengths`` and
    ``label_lengths`` give each sequence's lengths when passed."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, label_layout.find("N"), **kwargs)
        self._layout = layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = _amp.call("CTCLoss", pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss: paired batches (x1[i] matches
    x2[i]) scored by a softmax over negative squared euclidean distances,
    against smoothed identity targets (``smoothing_parameter`` spread over
    the in-batch negatives)."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter

    def forward(self, x1, x2):
        n = x1.shape[0]
        x1 = x1.reshape(n, -1)
        x2 = x2.reshape(n, -1)
        sq1 = (x1 * x1).sum(1).reshape(n, 1)
        sq2 = (x2 * x2).sum(1).reshape(1, n)
        dist = sq1 + sq2 - 2.0 * torch.matmul(x1, x2.t())
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        labels = (1 - self._smoothing) * eye + \
            self._smoothing / max(n - 1, 1) * (1.0 - eye)
        logp = _amp.call("log_softmax", -dist, axis=1)
        return _apply_weighting(-(labels * logp).sum(1), self._weight)
