"""The port's ``gluon.contrib`` (the Estimator with its event handlers, and
the contrib layers ``nn``, ``cnn``, ``rnn``) against the JAX package on the
CPU, from the same seeded weights and inputs.

Tolerances:

- the Estimator (``tests/test_gluon.py`` ``test_estimator_fit_and_handlers``
  through both packages): after 5 epochs of Adam the loss and accuracy
  metrics and every parameter within 1e-5 relative to max(1, |value|)
  (f32; each step's sums in another order); a ``CheckpointHandler`` file
  of either package loads in the other, bitwise; early stopping stops
  both at the same epoch, by patience.
- the contrib layers: 1e-5 of max(1, |value|) (f32, a few products);
  PixelShuffle, Identity and the locked masks' pattern exact.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon import rnn as jax_rnn
from mxnet_tpu.gluon.contrib import cnn as jax_ccnn
from mxnet_tpu.gluon.contrib import estimator as jax_est
from mxnet_tpu.gluon.contrib import nn as jax_cnn
from mxnet_tpu.gluon.contrib import rnn as jax_crnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn, rnn
from mxnet_tpu_torch.gluon.contrib import cnn as ccnn
from mxnet_tpu_torch.gluon.contrib import estimator as est_mod
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.gluon.contrib import rnn as crnn
from mxnet_tpu_torch.gluon.model_zoo import carrier

torch.set_num_threads(2)
# prime the intra-op pool before any comparison (SKILL.md, CPU glitch)
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()
TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _close(got, want, tol=TOL):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    assert got.shape == want.shape
    assert onp.abs(got - want).max() <= tol * max(1.0, onp.abs(want).max())


def _weights(jblock):
    return {k: p.data().asnumpy()
            for k, p in jblock._collect_params_with_prefix().items()}


def _port_params(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


# ---------------------------------------------------------------------------
# the Estimator
# ---------------------------------------------------------------------------
def _mlp(pkg_nn):
    net = pkg_nn.Sequential()
    net.add(pkg_nn.Dense(16, activation="relu"), pkg_nn.Dense(2))
    return net


@pytest.fixture(scope="module")
def problem():
    rng = onp.random.RandomState(0)
    X = rng.rand(64, 8).astype("float32")
    w = rng.rand(8, 2).astype("float32")
    y = (X @ w).argmax(axis=1).astype("float32")
    jnet = _mlp(jax_nn)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(X[:1]))
    return X, y, _weights(jnet)


def _fit(pkg, pkg_nn, gl, est_pkg, problem, ckpt_dir, ctx=None):
    X, y, named = problem
    loader = gl.data.DataLoader(gl.data.ArrayDataset(
        pkg.nd.array(X), pkg.nd.array(y)), batch_size=16)
    net = _mlp(pkg_nn)
    net.initialize()
    net(pkg.nd.array(X[:1]))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(pkg.nd.array(named[k]))
    kw = {} if ctx is None else {"context": ctx}
    est = est_pkg.Estimator(net, gl.loss.SoftmaxCrossEntropyLoss(),
                            trainer=gl.Trainer(net.collect_params(), "adam",
                                               {"learning_rate": 0.05}),
                            **kw)
    ckpt = est_pkg.CheckpointHandler(str(ckpt_dir), monitor=est.loss_metric,
                                     save_best=True)
    est.fit(loader, epochs=5, event_handlers=[ckpt])
    out = {"acc": est.train_metrics[0].get(), "loss": est.loss_metric.get(),
           "params": {k: p.data().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()},
           "best": ckpt.best, "eval": est.evaluate(loader)}
    est2 = est_pkg.Estimator(net, gl.loss.SoftmaxCrossEntropyLoss(),
                             trainer=gl.Trainer(net.collect_params(), "sgd",
                                                {"learning_rate": 0.0}),
                             **kw)
    stopper = est_pkg.EarlyStoppingHandler(est2.loss_metric, patience=0)
    est2.fit(loader, epochs=50, event_handlers=[stopper])
    out["stopper"] = (stopper.wait, stopper.stopped_epoch)
    return out, net


def test_estimator_fit_and_handlers(problem, tmp_path):
    want, jnet = _fit(mx, jax_nn, jax_gluon, jax_est, problem,
                      tmp_path / "ref")
    got, tnet = _fit(mt, nn, gluon, est_mod, problem, tmp_path / "port",
                     ctx=CPU)
    assert got["acc"][0] == want["acc"][0] == "accuracy"
    assert want["acc"][1] > 0.8
    _close(got["acc"][1], want["acc"][1])
    _close(got["loss"][1], want["loss"][1])
    _close(got["best"], want["best"])
    for k in want["params"]:
        _close(got["params"][k], want["params"][k])
    assert [n for n, _ in got["eval"]] == [n for n, _ in want["eval"]]
    for (_, g), (_, w) in zip(got["eval"], want["eval"]):
        _close(g, w)
    assert got["stopper"][0] > 0 and want["stopper"][0] > 0
    assert got["stopper"] == want["stopper"]
    # each package's best checkpoint loads in the other, bitwise
    for src, dst_net, read in (
            (tmp_path / "port", jnet, lambda n: _weights(n)),
            (tmp_path / "ref", tnet, lambda n: _port_params(n))):
        path = src / "model-best.params"
        assert path.exists() and (src / "model-epoch5.params").exists()
        dst_net.load_parameters(str(path))
        loaded = read(dst_net)
        other = (mt.nd if dst_net is jnet else mx.nd).load(str(path))
        for k, v in loaded.items():
            assert onp.array_equal(v, other[k].asnumpy()), k


def test_estimator_moves_batches_to_its_context(problem):
    """The loader's cpu() batches reach the net on ``context`` (here the
    CPU; the card in phase 14): ``_unpack`` places data and label."""
    X, y, _ = problem
    est = est_mod.Estimator(_mlp(nn), gluon.loss.SoftmaxCrossEntropyLoss(),
                            context=[CPU])
    assert est.context == CPU
    data, label = est._unpack((nd.array(X[:4]), nd.array(y[:4])))
    assert data.context == CPU and label.context == CPU
    with pytest.raises(mt.MXNetError, match="one context"):
        est_mod.Estimator(_mlp(nn), gluon.loss.SoftmaxCrossEntropyLoss(),
                          context=[CPU, CPU])


def test_default_handlers_and_priorities():
    def kinds(handlers):
        return [type(h).__name__ for h in handlers]
    for pkg_est, gl, pkg_nn in ((jax_est, jax_gluon, jax_nn),
                                (est_mod, gluon, nn)):
        net = _mlp(pkg_nn)
        net.initialize()
        e = pkg_est.Estimator(net, gl.loss.SoftmaxCrossEntropyLoss())
        user = [pkg_est.EarlyStoppingHandler(e.loss_metric),
                pkg_est.CheckpointHandler("unused", monitor=e.train_metrics[0])]
        hs = e._default_handlers([0], user, 2, None)
        if pkg_est is jax_est:
            want = (kinds(hs), user[0].mode, user[1].mode)
        else:
            got = (kinds(hs), user[0].mode, user[1].mode)
    assert got == want
    assert want[0] == ["CheckpointHandler", "LoggingHandler",
                       "MetricHandler", "ValidationHandler",
                       "EarlyStoppingHandler", "StoppingHandler"]
    assert want[1:] == ("min", "max")


# ---------------------------------------------------------------------------
# the contrib layers (tests/test_gluon.py:387-540)
# ---------------------------------------------------------------------------
def _x(shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def test_deformable_convolution_layer():
    x = _x((1, 3, 8, 8))
    jl = jax_ccnn.DeformableConvolution(4, kernel_size=3, padding=1)
    jl.initialize(mx.init.Xavier())
    jl(mx.nd.array(x))
    named = _weights(jl)
    tl = ccnn.DeformableConvolution(4, kernel_size=3, padding=1)
    carrier.load_jax_params(tl, named, ctx=CPU)
    xs = nd.array(x)
    out = tl(xs)
    _close(out.asnumpy(), jl(mx.nd.array(x)).asnumpy())
    want = nd.Convolution(xs, tl.weight.data(), tl.bias.data(),
                          kernel=(3, 3), pad=(1, 1), num_filter=4)
    _close(out.asnumpy(), want.asnumpy(), 1e-4)
    assert all(onp.all(v == 0) for k, v in named.items() if "offset" in k)
    grads = []
    for pkg, layer in ((mx, jl), (mt, tl)):
        with pkg.autograd.record():
            y = layer(pkg.nd.array(x)).sum()
        y.backward()
        grads.append(layer.offset_weight.grad().asnumpy())
    assert onp.abs(grads[1]).sum() > 0
    _close(grads[1], grads[0], 1e-4)


def test_variational_dropout_cell_locked_mask():
    class _Identity(rnn.RecurrentCell):
        def state_info(self, batch_size=0):
            return []

        def forward(self, inputs, states):
            return inputs, states

    cell = crnn.VariationalDropoutCell(_Identity(), drop_inputs=0.5)
    cell.initialize()
    x = nd.ones((2, 6, 4))
    with autograd.record():
        out, _ = cell.unroll(6, x, merge_outputs=True)
    o = out.asnumpy()
    m1 = cell._input_mask.numpy()
    assert set(onp.unique(o)) <= {0.0, 2.0} and 0.0 in o and 2.0 in o
    for t in range(6):
        onp.testing.assert_array_equal(o[:, t, :], m1)
    cell.reset()
    assert cell._input_mask is None
    lstm = crnn.VariationalDropoutCell(rnn.LSTMCell(8), drop_inputs=0.5,
                                       drop_states=0.5, drop_outputs=0.5)
    lstm.initialize(mt.init.Xavier())
    with autograd.record():
        out2, _ = lstm.unroll(4, nd.ones((2, 4, 3)), merge_outputs=True)
        out2.sum().backward()
    g = list(lstm.base_cell.collect_params().values())[0].grad()
    assert float(onp.abs(g.asnumpy()).sum()) > 0


def test_variational_dropout_outside_training_is_the_base_cell():
    x = _x((2, 5, 3), seed=1)
    jcell = jax_crnn.VariationalDropoutCell(jax_rnn.LSTMCell(8),
                                            drop_inputs=0.5, drop_states=0.5,
                                            drop_outputs=0.5)
    jcell.initialize(mx.init.Xavier())
    want, _ = jcell.unroll(5, mx.nd.array(x), merge_outputs=True)
    tcell = crnn.VariationalDropoutCell(rnn.LSTMCell(8), drop_inputs=0.5,
                                        drop_states=0.5, drop_outputs=0.5)
    carrier.load_jax_params(tcell, _weights(jcell), ctx=CPU)
    got, _ = tcell.unroll(5, nd.array(x), merge_outputs=True)
    _close(got.asnumpy(), want.asnumpy())


def test_lstmp_cell_projection():
    x = _x((3, 5, 2), seed=2)
    jcell = jax_crnn.LSTMPCell(hidden_size=16, projection_size=4)
    jcell.initialize(mx.init.Xavier())
    want, wstates = jcell.unroll(5, mx.nd.array(x), merge_outputs=True)
    tcell = crnn.LSTMPCell(hidden_size=16, projection_size=4)
    carrier.load_jax_params(tcell, _weights(jcell), ctx=CPU)
    out, states = tcell.unroll(5, nd.array(x), merge_outputs=True)
    assert out.shape == (3, 5, 4)
    assert states[0].shape == (3, 4) and states[1].shape == (3, 16)
    _close(out.asnumpy(), want.asnumpy())
    for s, w in zip(states, wstates):
        _close(s.asnumpy(), w.asnumpy())


@pytest.mark.parametrize("cls", ["Concurrent", "HybridConcurrent"])
def test_contrib_concurrent_and_identity(cls):
    x = _x((2, 3), seed=3)
    outs = []
    for pkg, pkg_nn, pkg_cnn in ((mx, jax_nn, jax_cnn), (mt, nn, cnn)):
        net = getattr(pkg_cnn, cls)(axis=-1)
        net.add(pkg_nn.Dense(4), pkg_nn.Dense(6), pkg_cnn.Identity())
        net.initialize()
        net(pkg.nd.array(x))
        if pkg is mx:
            named = _weights(net)
        else:
            carrier.load_jax_params(net, named, ctx=CPU)
        outs.append(net(pkg.nd.array(x)).asnumpy())
    assert outs[1].shape == (2, 13)
    _close(outs[1], outs[0])
    assert onp.array_equal(outs[1][:, 10:], x)


@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 2, (1, 8, 3)),
    ("PixelShuffle2D", 2, (1, 4, 2, 2)),
    ("PixelShuffle2D", (2, 3), (1, 12, 3, 5)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 4))])
def test_contrib_pixelshuffle(cls, factor, shape):
    x = onp.arange(onp.prod(shape)).reshape(shape).astype("float32")
    want = getattr(jax_cnn, cls)(factor)(mx.nd.array(x)).asnumpy()
    got = getattr(cnn, cls)(factor)(nd.array(x)).asnumpy()
    assert onp.array_equal(got, want)


def test_contrib_sparse_embedding_block():
    idx = onp.array([1, 2, 2], "float32")
    jse = jax_cnn.SparseEmbedding(10, 4)
    jse.initialize()
    se = cnn.SparseEmbedding(10, 4)
    carrier.load_jax_params(se, _weights(jse), ctx=CPU)
    with autograd.record():
        out = se(nd.array(idx))
        out.sum().backward()
    _close(out.asnumpy(), jse(mx.nd.array(idx)).asnumpy())
    assert se.weight._grad_stype == jse.weight._grad_stype == "row_sparse"
    g = se.weight.grad()
    assert g.stype == "row_sparse"
    dense = g.tostype("default").asnumpy()
    assert dense[2].tolist() == [2.0] * 4 and dense[1].tolist() == [1.0] * 4
    assert onp.abs(dense[[0, 3, 4, 5, 6, 7, 8, 9]]).sum() == 0


def test_contrib_batchnorm_relu():
    x = _x((2, 3, 4, 4), seed=4)
    outs, stats = [], []
    for pkg, pkg_cnn in ((mx, jax_cnn), (mt, cnn)):
        bnr = pkg_cnn.BatchNormReLU()
        bnr.initialize()
        with pkg.autograd.record():
            out = bnr(pkg.nd.array(x))
        outs.append(out.asnumpy())
        stats.append(bnr.running_mean.data().asnumpy())
    assert outs[1].min() >= 0.0 and (outs[1] == 0).any()
    _close(outs[1], outs[0])
    _close(stats[1], stats[0])
