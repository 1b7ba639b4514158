"""Evaluation metrics of the port (the counterpart of
``mxnet_tpu/metric.py``): ``EvalMetric``, ``create`` and the registry with
the reference's names and aliases, ``CompositeEvalMetric`` and the metrics
themselves.

The arithmetic is the reference's, on the host: every update takes its
arrays to numpy (:func:`_as_numpy`) and computes there, so equal inputs
give bitwise-equal values in both packages (``TopKAccuracy`` orders ties
as ``numpy.argsort`` does). For an array on the card ``_as_numpy`` is a
device-to-host copy, and so a synchronization, per metric and update.
"""
from __future__ import annotations

import math

import numpy as onp

from .base import MXNetError, Registry

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MAE", "MSE", "RMSE", "CrossEntropy", "Perplexity",
           "PearsonCorrelation", "CustomMetric", "np_metric",
           "NegativeLogLikelihood", "MCC", "PCC", "Loss", "Torch", "Caffe",
           "create", "register", "check_label_shapes"]

_REG = Registry("metric")
register = _REG.register


def _as_numpy(x):
    """``x`` as a numpy array (a bf16 array as float32)."""
    from .ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    return onp.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if len(labels) != len(preds):
        raise MXNetError(f"Shape mismatch: {len(labels)} labels vs "
                         f"{len(preds)} preds")


class EvalMetric:
    """Base of the metrics: ``sum_metric / num_inst`` after ``update``s."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def create(metric, *args, **kwargs):
    """A metric by registered name, a list of them (a composite), an
    ``EvalMetric`` as it is, or a callable ``feval(label, pred)``."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REG.get(metric)(*args, **kwargs)


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives lists."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _listify(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register("acc")
@register("accuracy")
class Accuracy(EvalMetric):
    """The share of predictions (argmax over ``axis``) equal to the
    label."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label)
            if pred.ndim > label.ndim:
                pred = onp.argmax(pred, axis=self.axis)
            pred = pred.astype(onp.int64).ravel()
            label = label.astype(onp.int64).ravel()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register("top_k_accuracy")
@register("top_k_acc")
class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` highest scores (ties in
    ``numpy.argsort``'s order)."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(onp.int64).ravel()
            idx = onp.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += float((idx == label[:, None]).any(axis=1)
                                     .sum())
            self.num_inst += len(label)


@register("f1")
class F1(EvalMetric):
    """Binary F1 over the counts of every update."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            pred = _as_numpy(pred)
            label = _as_numpy(label).ravel()
            if pred.ndim > 1:
                pred = onp.argmax(pred, axis=-1)
            pred = pred.ravel()
            self.tp += float(((pred == 1) & (label == 1)).sum())
            self.fp += float(((pred == 1) & (label == 0)).sum())
            self.fn += float(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        precision = self.tp / max(self.tp + self.fp, 1e-12)
        recall = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return self.name, f1


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_numpy(label), _as_numpy(pred)
            self.sum_metric += float(onp.abs(label.reshape(pred.shape)
                                             - pred).mean())
            self.num_inst += 1


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_numpy(label), _as_numpy(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred)
                                      ** 2).mean())
            self.num_inst += 1


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@register("ce")
@register("cross-entropy")
class CrossEntropy(EvalMetric):
    """-log of the probability at the label (``pred`` holds
    probabilities)."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).ravel().astype(onp.int64)
            pred = _as_numpy(pred)
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += float((-onp.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register("perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.ignore_label = ignore_label
        self.eps = 1e-12

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _as_numpy(label).ravel().astype(onp.int64)
            pred = _as_numpy(pred).reshape(-1, _as_numpy(pred).shape[-1])
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = prob[~ignore]
            self.sum_metric += float(-onp.log(prob + self.eps).sum())
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_numpy(label).ravel(), _as_numpy(pred).ravel()
            self.sum_metric += float(onp.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays: a value, or (sum, count)."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            val = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


def np_metric(name=None, allow_extra_outputs=False):
    """Decorator: a numpy function ``f(label, pred)`` as a
    ``CustomMetric``."""
    def deco(f):
        return CustomMetric(f, name or f.__name__, allow_extra_outputs)
    return deco


@register("loss")
class Loss(EvalMetric):
    """The mean of the values of ``preds`` (losses); labels are
    ignored."""

    def __init__(self, name="loss", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def update(self, _, preds):
        # two fetches of each prediction, the sum's and the size's, as the
        # reference makes them (the copies a step phase 14 counts)
        for p in _listify(preds):
            self.sum_metric = self.sum_metric + float(_as_numpy(p).sum())
            self.num_inst = self.num_inst + _as_numpy(p).size


@register("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """-mean(log p[label]) over predicted class probabilities."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            l = _as_numpy(label).astype(int).ravel()
            p = _as_numpy(pred).reshape(l.size, -1)
            picked = p[onp.arange(l.size), l]
            self.sum_metric += float(-onp.log(picked + self.eps).sum())
            self.num_inst += l.size


def _binary_predictions(p, n):
    """Class ids from scores (argmax) or from one probability column
    (> 0.5)."""
    return p.reshape(n, -1).argmax(-1) if p.ndim > 1 and p.shape[-1] > 1 \
        else (p.ravel() > 0.5).astype(int)


@register("mcc")
class MCC(EvalMetric):
    """Matthews correlation coefficient for binary classification:
    ``average="macro"`` averages the per-update MCC, ``"micro"`` computes
    one MCC over the counts of every update."""

    def __init__(self, name="mcc", average="macro", **kwargs):
        if average not in ("macro", "micro"):
            raise ValueError(f"average must be 'macro' or 'micro', got "
                             f"{average!r}")
        super().__init__(name, **kwargs)
        self._average = average
        self._tp = self._tn = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self._tp = self._tn = self._fp = self._fn = 0.0

    @staticmethod
    def _mcc(tp, tn, fp, fn):
        denom = onp.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return 0.0 if denom == 0 else (tp * tn - fp * fn) / denom

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            l = _as_numpy(label).astype(int).ravel()
            yhat = _binary_predictions(_as_numpy(pred), l.size)
            tp = float(((yhat == 1) & (l == 1)).sum())
            tn = float(((yhat == 0) & (l == 0)).sum())
            fp = float(((yhat == 1) & (l == 0)).sum())
            fn = float(((yhat == 0) & (l == 1)).sum())
            if self._average == "macro":
                self.sum_metric += self._mcc(tp, tn, fp, fn)
                self.num_inst += 1
            else:
                self._tp += tp
                self._tn += tn
                self._fp += fp
                self._fn += fn
                self.sum_metric = self._mcc(self._tp, self._tn,
                                            self._fp, self._fn)
                self.num_inst = 1


@register("pcc")
class PCC(EvalMetric):
    """The multiclass MCC: the Pearson correlation of the k x k confusion
    matrix, accumulated over every update (micro only)."""

    def __init__(self, name="pcc", average=None, **kwargs):
        if average not in (None, "micro"):
            raise NotImplementedError(
                "PCC accumulates one confusion matrix across batches "
                "(micro); per-batch 'macro' averaging is not supported")
        super().__init__(name, **kwargs)
        self._cm = None

    def reset(self):
        super().reset()
        self._cm = None

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            l = _as_numpy(label).astype(int).ravel()
            yhat = _binary_predictions(_as_numpy(pred), l.size)
            k = int(max(l.max(), yhat.max())) + 1
            if self._cm is None or self._cm.shape[0] < k:
                new = onp.zeros((k, k), "float64")
                if self._cm is not None:
                    new[:self._cm.shape[0], :self._cm.shape[1]] = self._cm
                self._cm = new
            onp.add.at(self._cm, (yhat, l), 1)
            self.num_inst = 1
        cm = self._cm
        n = cm.sum()
        x = cm.sum(1)  # predicted counts
        y = cm.sum(0)  # true counts
        cov_xy = (cm.trace() * n - (x * y).sum())
        cov_xx = (n * n - (x * x).sum())
        cov_yy = (n * n - (y * y).sum())
        denom = math.sqrt(cov_xx * cov_yy)
        self.sum_metric = 0.0 if denom == 0 else cov_xy / denom


@register("torch")
class Torch(Loss):
    """Legacy name: the mean of criterion outputs."""

    def __init__(self, name="torch", **kwargs):
        super().__init__(name, **kwargs)


@register("caffe")
class Caffe(Loss):
    """Legacy name: the mean of criterion outputs."""

    def __init__(self, name="caffe", **kwargs):
        super().__init__(name, **kwargs)
