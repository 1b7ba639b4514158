"""The port's metrics (``mxnet_tpu_torch.metric``) against the JAX
package's on the CPU: the same seeded numpy labels and predictions, as
each package's NDArrays, through several updates; ``get()`` equal bitwise
(both compute on the host in numpy, in the same order), ``TopKAccuracy``
on tied scores included. The registry's names and aliases, ``create`` and
the reference's own metric oracles (``tests/test_gluon.py``
``test_metric_nll_mcc_pcc`` and ``test_metric_mcc_average_semantics``) run
on the port too."""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import metric as jax_metric

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import metric, nd

torch.set_num_threads(2)

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _batches(kind, seed, n=3, rows=16, classes=5):
    """``n`` (label, pred) numpy pairs for a metric of ``kind``."""
    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        label = rng.randint(0, classes, rows).astype(onp.float32)
        if kind == "scores":
            pred = rng.randn(rows, classes).astype(onp.float32)
        elif kind == "tied":            # few distinct values: many ties
            pred = rng.randint(0, 3, (rows, classes)).astype(onp.float32)
        elif kind == "probs":
            p = rng.rand(rows, classes).astype(onp.float32) + 0.05
            pred = (p / p.sum(1, keepdims=True)).astype(onp.float32)
        elif kind == "binary":
            label = rng.randint(0, 2, rows).astype(onp.float32)
            pred = rng.rand(rows, 2).astype(onp.float32)
        elif kind == "sigmoid":
            label = rng.randint(0, 2, rows).astype(onp.float32)
            pred = rng.rand(rows, 1).astype(onp.float32)
        elif kind == "ids":
            pred = rng.randint(0, classes, rows).astype(onp.float32)
        elif kind == "regression":
            label = rng.randn(rows).astype(onp.float32)
            pred = rng.randn(rows, 1).astype(onp.float32)
        elif kind == "sequence":        # (rows, 4 steps, classes)
            label = rng.randint(0, classes, (rows, 4)).astype(onp.float32)
            p = rng.rand(rows, 4, classes).astype(onp.float32) + 0.05
            pred = (p / p.sum(-1, keepdims=True)).astype(onp.float32)
        elif kind == "loss":
            label = onp.zeros(rows, onp.float32)
            pred = rng.rand(rows).astype(onp.float32)
        out.append((label, pred))
    return out


def _rmse_feval(label, pred):
    return float(onp.sqrt(((label - pred.ravel()) ** 2).mean()))


def _pair_feval(label, pred):
    return float((pred.argmax(1) == label).sum()), len(label)


CASES = {
    "accuracy": ("Accuracy", {}, "scores"),
    "accuracy_ids": ("Accuracy", {}, "ids"),
    "top_k_1": ("TopKAccuracy", {"top_k": 1}, "tied"),
    "top_k_3_tied": ("TopKAccuracy", {"top_k": 3}, "tied"),
    "top_k_3": ("TopKAccuracy", {"top_k": 3}, "scores"),
    "f1": ("F1", {}, "binary"),
    "mae": ("MAE", {}, "regression"),
    "mse": ("MSE", {}, "regression"),
    "rmse": ("RMSE", {}, "regression"),
    "cross_entropy": ("CrossEntropy", {}, "probs"),
    "perplexity": ("Perplexity", {"ignore_label": 2}, "sequence"),
    "perplexity_all": ("Perplexity", {}, "sequence"),
    "pearsonr": ("PearsonCorrelation", {}, "regression"),
    "nll": ("NegativeLogLikelihood", {}, "probs"),
    "mcc_macro": ("MCC", {}, "binary"),
    "mcc_micro": ("MCC", {"average": "micro"}, "binary"),
    "mcc_sigmoid": ("MCC", {}, "sigmoid"),
    "pcc": ("PCC", {}, "scores"),
    "pcc_sigmoid": ("PCC", {}, "sigmoid"),
    "loss": ("Loss", {}, "loss"),
    "torch": ("Torch", {}, "loss"),
    "caffe": ("Caffe", {}, "loss"),
    "custom": ("CustomMetric", {"feval": _rmse_feval, "name": "rmse"},
               "regression"),
    "custom_pair": ("CustomMetric", {"feval": _pair_feval}, "scores"),
}


def _run(pkg, metric_mod, cls, kw, batches, listed):
    m = getattr(metric_mod, cls)(**kw)
    assert math.isnan(m.get()[1]) or cls in ("F1", "PCC")
    for label, pred in batches:
        lab, prd = pkg.nd.array(label), pkg.nd.array(pred)
        if listed:
            m.update([lab], [prd])
        else:
            m.update(lab, prd)
    return m.get(), m.get_name_value()


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_equals_the_reference_bitwise(case):
    cls, kw, kind = CASES[case]
    batches = _batches(kind, seed=len(case))
    for listed in (False, True):
        want = _run(mx, jax_metric, cls, kw, batches, listed)
        got = _run(mt, metric, cls, kw, batches, listed)
        assert got == want, (got, want)


def test_top_k_orders_ties_as_numpy_argsort():
    """All-equal scores: numpy's argsort keeps the first k columns, so
    labels 0 and 1 count and 2 does not (torch.topk need not)."""
    pred = onp.zeros((3, 4), onp.float32)
    label = onp.array([0, 1, 2], onp.float32)
    for pkg, mod in ((mx, jax_metric), (mt, metric)):
        m = mod.TopKAccuracy(top_k=2)
        m.update(pkg.nd.array(label), pkg.nd.array(pred))
        assert m.get() == ("top_k_accuracy_2", 2 / 3)


def test_np_metric_and_composite():
    batches = _batches("scores", seed=7)
    got, want = [], []
    for pkg, mod, out in ((mx, jax_metric, want), (mt, metric, got)):
        comp = mod.CompositeEvalMetric([mod.Accuracy(), "top_k_acc"])
        comp.add(mod.np_metric("argmax_hits")(_pair_feval))
        for label, pred in batches:
            comp.update([pkg.nd.array(label)], [pkg.nd.array(pred)])
        out.append(comp.get())
        out.append(str(comp))
        comp.reset()
        out.append(comp.get_name_value()[0][0])
    assert got == want


def test_registry_names_and_create():
    assert sorted(metric._REG._entries) == sorted(jax_metric._REG._entries)
    for name in metric._REG._entries:
        got, want = metric.create(name), jax_metric.create(name)
        assert type(got).__name__ == type(want).__name__, name
        assert got.name == want.name, name
    m = metric.Accuracy()
    assert metric.create(m) is m
    assert isinstance(metric.create(_pair_feval), metric.CustomMetric)
    comp = metric.create(["acc", "mse"])
    assert [c.name for c in comp.metrics] == ["accuracy", "mse"]
    with pytest.raises(mt.MXNetError, match="unknown entry"):
        metric.create("no_such_metric")


def test_metric_on_bf16_predictions():
    """A bf16 prediction is read as float32 (``asnumpy``)."""
    rng = onp.random.RandomState(3)
    pred = rng.randn(8, 5).astype(onp.float32)
    label = rng.randint(0, 5, 8).astype(onp.float32)
    m = metric.Accuracy()
    m.update(nd.array(label), nd.array(pred, dtype="bfloat16"))
    want = metric.Accuracy()
    want.update(nd.array(label), nd.array(
        nd.array(pred, dtype="bfloat16").asnumpy()))
    assert m.get() == want.get()


# ---------------------------------------------------------------------------
# the reference's own oracles (tests/test_gluon.py:542, :616) on the port
# ---------------------------------------------------------------------------
def test_metric_nll_mcc_pcc():
    m = metric.NegativeLogLikelihood()
    m.update(nd.array(onp.array([0, 1], "float32")),
             nd.array(onp.array([[0.9, 0.1], [0.2, 0.8]], "float32")))
    assert abs(m.get()[1] + (math.log(0.9) + math.log(0.8)) / 2) < 1e-6
    mcc = metric.MCC()
    mcc.update(nd.array(onp.array([1, 1, 0, 0], "float32")),
               nd.array(onp.array([[0.1, 0.9], [0.6, 0.4],
                                   [0.8, 0.2], [0.3, 0.7]], "float32")))
    assert abs(mcc.get()[1]) < 1e-12
    pcc = metric.PCC()
    pcc.update(nd.array(onp.array([0, 1, 2, 0], "float32")),
               nd.array(onp.eye(3)[[0, 1, 2, 0]].astype("float32")))
    assert abs(pcc.get()[1] - 1.0) < 1e-9
    assert metric.create("mcc") is not None
    assert metric.create("nll_loss") is not None


def test_metric_mcc_average_semantics():
    labels1 = nd.array(onp.array([1, 1, 0, 0], "float32"))
    preds1 = nd.array(onp.array([[0.1, 0.9], [0.2, 0.8],
                                 [0.8, 0.2], [0.7, 0.3]], "float32"))
    labels2 = nd.array(onp.array([1, 1, 0, 0], "float32"))
    preds2 = nd.array(onp.array([[0.1, 0.9], [0.6, 0.4],
                                 [0.8, 0.2], [0.3, 0.7]], "float32"))
    macro = metric.MCC(average="macro")
    macro.update(labels1, preds1)
    macro.update(labels2, preds2)
    assert abs(macro.get()[1] - 0.5) < 1e-12
    micro = metric.MCC(average="micro")
    micro.update(labels1, preds1)
    micro.update(labels2, preds2)
    assert abs(micro.get()[1] - 0.5) < 1e-12
    with pytest.raises(ValueError):
        metric.MCC(average="weighted")
    with pytest.raises(NotImplementedError):
        metric.PCC(average="macro")


def test_callbacks_read_the_port_metrics(caplog):
    """Speedometer, log_train_metric and LogValidationMetricsCallback over
    a port metric log what the reference's log."""
    import logging

    from mxnet_tpu import callback as jax_callback
    from mxnet_tpu_torch import callback

    lines = {}
    for tag, pkg, mod, cb in (("ref", mx, jax_metric, jax_callback),
                              ("port", mt, metric, callback)):
        m = mod.Accuracy()
        for label, pred in _batches("scores", seed=11):
            m.update(pkg.nd.array(label), pkg.nd.array(pred))
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cb.log_train_metric(2)(cb.BatchEndParam(1, 4, m))
            cb.LogValidationMetricsCallback()(cb.BatchEndParam(1, 4, m))
            speed = cb.Speedometer(16, frequent=2, auto_reset=True)
            speed(cb.BatchEndParam(0, 1, m))
            speed(cb.BatchEndParam(0, 2, m))
        lines[tag] = [r.getMessage().split("Speed")[0]
                      for r in caplog.records]
        assert m.num_inst == 0                   # auto_reset
    assert lines["port"] == lines["ref"] and len(lines["ref"]) == 3
