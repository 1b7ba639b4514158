"""The port's ``Monitor`` and the Symbol branch of ``visualization``
against the JAX package's, on the CPU. Oracles: tests/test_monitor.py and
tests/test_symbol_module.py::test_print_summary_symbol.

The same bound graph fed the same input: the monitor's stat names and
their order equal the reference's, and each value agrees within f32 1e-5
relative (a norm summed in another order). ``print_summary`` of a Symbol
prints the reference's text and returns its total; ``plot_network``
builds the reference's dot source.
"""
import contextlib
import io
import logging

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.tools.symbol_bert import symbol_bert

torch.set_num_threads(2)

SMALL = dict(layers=2, units=64, heads=2, ffn=128, seq=16, vocab=100,
             classes=3, dropout=0.0)


def _net(sym):
    data = sym.Variable("data")
    fc = sym.FullyConnected(data, name="fc1", num_hidden=4)
    return sym.Activation(fc, name="act1", act_type="relu")


def _bound_exe(pkg):
    exe = _net(pkg.sym).simple_bind(pkg.cpu(), data=(2, 3))
    rng = onp.random.RandomState(0)
    with pkg.cpu():
        for k in ("fc1_weight", "fc1_bias"):
            exe.arg_dict[k][:] = pkg.nd.array(
                rng.randn(*exe.arg_dict[k].shape).astype("float32"))
        exe.arg_dict["data"][:] = pkg.nd.array(
            onp.arange(6, dtype="float32").reshape(2, 3) - 2.5)
    return exe


def _monitored(pkg, steps=1, **kw):
    mon = pkg.Monitor(**kw)
    exe = _bound_exe(pkg)
    mon.install(exe)
    out = []
    for _ in range(steps):
        mon.tic()
        exe.forward()
        out.append(mon.toc())
    return out


def _same_rows(got, want):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    for (_, n, g), (_, _, w) in zip(got, want):
        gv = [float(x) for x in g.split("\t") if x]
        wv = [float(x) for x in w.split("\t") if x]
        onp.testing.assert_allclose(gv, wv, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("kw", [
    dict(interval=1),
    dict(interval=1, sort=True),
    dict(interval=2, pattern=".*output"),
    dict(interval=1, monitor_all=True, pattern=".*input.*"),
    dict(interval=1, pattern="fc1_.*")],
    ids=["all", "sorted", "interval_pattern", "monitor_all", "params"])
def test_monitor_rows_equal_the_references(kw):
    want = _monitored(mx, steps=3, **kw)
    got = _monitored(mt, steps=3, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_rows(g, w)
    assert got[0], "the first window collects"
    if kw["interval"] == 2:
        assert got[1] == [] and got[2]


def test_monitor_with_a_stat_func():
    def stat(x):
        return x.max()

    want = _monitored(mx, interval=1, stat_func=stat)[0]
    got = _monitored(mt, interval=1, stat_func=stat)[0]
    _same_rows(got, want)


def test_module_fit_drives_the_monitor(caplog):
    """``fit(monitor=...)`` installs the monitor on the bound executor and
    logs a window a batch, as the reference's fit does."""
    rng = onp.random.RandomState(1)
    x = rng.randn(8, 3).astype("float32")
    y = rng.randint(0, 4, (8,)).astype("float32")
    logged = {}
    for tag, pkg in (("ref", mx), ("port", mt)):
        net = pkg.sym.SoftmaxOutput(_net(pkg.sym), name="softmax")
        with pkg.cpu():
            it = pkg.io.NDArrayIter(x, y, batch_size=4,
                                    label_name="softmax_label")
            w = {"fc1_weight": pkg.nd.array(onp.full((4, 3), 0.1, "f4")),
                 "fc1_bias": pkg.nd.zeros((4,))}
        mod = pkg.mod.Module(net, context=pkg.cpu())
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.fit(it, num_epoch=1, arg_params=w, aux_params={},
                    monitor=pkg.Monitor(1, pattern="act1.*"))
        logged[tag] = [r.getMessage() for r in caplog.records
                       if r.getMessage().startswith("Batch:")]
    assert len(logged["port"]) == len(logged["ref"]) == 2
    assert [m.split()[:3] for m in logged["port"]] == \
        [m.split()[:3] for m in logged["ref"]]


def _printed(fn, *a, **k):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        total = fn(*a, **k)
    return out.getvalue(), total


@pytest.mark.parametrize("graph", ["mlp", "bert"])
def test_print_summary_of_a_symbol_equals_the_references(graph):
    def build(sym):
        if graph == "bert":
            return symbol_bert(sym, **SMALL)
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                                 name="fc1")
        net = sym.Activation(net, act_type="relu", name="act")
        return sym.FullyConnected(net, num_hidden=4, name="fc2")

    shape = {"data": (2, SMALL["seq"] if graph == "bert" else 8)}
    want = _printed(mx.visualization.print_summary, build(mx.sym), shape)
    got = _printed(mt.visualization.print_summary, build(mt.sym), shape)
    assert got == want
    if graph == "mlp":
        assert got[1] == (8 * 16 + 16) + (16 * 4 + 4)
        assert "fc1 (FullyConnected)" in got[0] and "2x16" in got[0]
    assert _printed(mt.visualization.print_summary, build(mt.sym)) == \
        _printed(mx.visualization.print_summary, build(mx.sym))


@pytest.mark.parametrize("hide_weights", [True, False])
@pytest.mark.parametrize("graph", ["mlp", "bert"])
def test_plot_network_dot_equals_the_references(graph, hide_weights):
    def build(sym):
        if graph == "bert":
            return symbol_bert(sym, **SMALL)
        data = sym.Variable("data")
        net = sym.Convolution(data, kernel=(3, 3), num_filter=4, name="conv")
        net = sym.Pooling(net, kernel=(2, 2), pool_type="max", name="pool")
        net = sym.FullyConnected(net, num_hidden=3, name="fc")
        return sym.SoftmaxOutput(net, name="softmax")

    shape = {"data": (2, SMALL["seq"]) if graph == "bert" else (2, 1, 8, 8)}
    for s in (shape, None):
        want = mx.visualization.plot_network(build(mx.sym), title="net",
                                             shape=s,
                                             hide_weights=hide_weights)
        got = mt.visualization.plot_network(build(mt.sym), title="net",
                                            shape=s,
                                            hide_weights=hide_weights)
        assert str(getattr(got, "source", got)) == \
            str(getattr(want, "source", want))


def test_plot_network_of_a_block_equals_the_references():
    nets = []
    for pkg in (mx, mt):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(4), pkg.gluon.nn.Dense(2))
        nets.append(pkg.visualization.plot_network(net, title="b"))
    assert str(getattr(nets[1], "source", nets[1])) == \
        str(getattr(nets[0], "source", nets[0]))
