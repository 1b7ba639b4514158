"""The port's RNN op, recurrent layers, cells and LSTM language model
against the JAX package's, both on the CPU, from the same seeded numpy
inputs and the same weights (the JAX package's, carried across by
``load_jax_params``): f32, within 1e-5 relative (and absolute near zero).

- ``nd.RNN`` in the four modes, with 1 and 2 layers, uni- and
  bidirectional: outputs and final states, and the gradients of the input,
  the flat parameter vector and the initial states;
- ``gluon.rnn.LSTM``/``GRU``/``RNN`` and the cells on the cases of
  tests/test_gluon.py (test_rnn_layers, test_rnn_cells), values included;
- ``LSTMLanguageModel`` (embedding 16, hidden 32, 2 layers, vocabulary 50,
  T 7, batch 3): three truncated-BPTT ``gluon.Trainer`` SGD steps with the
  states carried and the gradients clipped, losses and parameters;
- the op's ignored ``p`` (ROADMAP Queue 3): ``LSTM(dropout=0.5)`` trains
  without inter-layer dropout in both packages.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu_torch.gluon.model_zoo import LSTMLanguageModel, carrier
from mxnet_tpu_torch.ops.nn import rnn_param_size

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

TOL = 1e-5


def _r(seed):
    return onp.random.RandomState(seed)


def _close(got, want, what, tol=TOL):
    got = got.asnumpy() if hasattr(got, "asnumpy") else onp.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _weights(block):
    return {k: p.data().asnumpy()
            for k, p in block._collect_params_with_prefix().items()}


def _carry(port_block, jax_block):
    carrier.load_jax_params(port_block, _weights(jax_block), ctx=mt.cpu())


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------
OP_CASES = [(mode, layers, bi) for mode in ("lstm", "gru", "rnn_tanh",
                                            "rnn_relu")
            for layers in (1, 2) for bi in (False, True)]


@pytest.mark.parametrize("mode, layers, bi", OP_CASES,
                         ids=[f"{m}-{n}L-{'bi' if b else 'uni'}"
                              for m, n, b in OP_CASES])
def test_rnn_op_forward_and_gradient(mode, layers, bi):
    T, N, I, H = 5, 3, 4, 6
    d = 2 if bi else 1
    size = rnn_param_size(mode, layers, I, H, bi)
    inputs = {"x": _r(1).randn(T, N, I).astype(onp.float32),
              "p": _r(2).uniform(-0.4, 0.4, size).astype(onp.float32),
              "h0": _r(3).randn(layers * d, N, H).astype(onp.float32) * 0.5,
              "c0": _r(4).randn(layers * d, N, H).astype(onp.float32) * 0.5}
    heads = [_r(5 + i).randn(*s).astype(onp.float32) for i, s in enumerate(
        [(T, N, d * H), (layers * d, N, H), (layers * d, N, H)])]
    results = []
    for pkg in (mx, mt):
        with pkg.cpu():
            a = {k: pkg.nd.array(v) for k, v in inputs.items()}
            for v in a.values():
                v.attach_grad()
            with pkg.autograd.record():
                out = pkg.nd.RNN(a["x"], a["p"], a["h0"],
                                 a["c0"] if mode == "lstm" else None,
                                 state_size=H, num_layers=layers,
                                 bidirectional=bi, mode=mode)
                loss = sum((o * pkg.nd.array(h)).sum()
                           for o, h in zip(out, heads))
            loss.backward()
            results.append(([o.asnumpy() for o in out],
                            {k: v.grad.asnumpy() for k, v in a.items()}))
    (ref_out, ref_grad), (got_out, got_grad) = results
    assert len(got_out) == len(ref_out) == (3 if mode == "lstm" else 2)
    for i, (g, w) in enumerate(zip(got_out, ref_out)):
        _close(g, w, f"output {i}")
    for k in inputs:
        if k == "c0" and mode != "lstm":
            continue
        _close(got_grad[k], ref_grad[k], f"d{k}")


def test_rnn_param_layout_matches_the_reference():
    from mxnet_tpu.ops.nn import rnn_param_size as jax_size
    for mode in ("lstm", "gru", "rnn_tanh"):
        for bi in (False, True):
            assert rnn_param_size(mode, 3, 5, 7, bi) == \
                jax_size(mode, 3, 5, 7, bi)


# ---------------------------------------------------------------------------
# layers and cells (tests/test_gluon.py's cases, values included)
# ---------------------------------------------------------------------------
def _layer_pair(make):
    mx.random.seed(0)
    ref = make(jrnn)
    ref.initialize(mx.init.Uniform(0.3))
    with mt.cpu():
        got = make(mt.gluon.rnn)
    return ref, got


@pytest.mark.parametrize("kind", ["lstm_2l_bi_tnc", "gru_ntc",
                                  "rnn_tanh_ntc", "rnn_relu_tnc"])
def test_rnn_layers_match_the_reference(kind):
    make, shape = {
        "lstm_2l_bi_tnc": (lambda r: r.LSTM(10, num_layers=2,
                                            bidirectional=True), (5, 3, 6)),
        "gru_ntc": (lambda r: r.GRU(7, layout="NTC"), (2, 4, 3)),
        "rnn_tanh_ntc": (lambda r: r.RNN(5, num_layers=2, activation="tanh",
                                         layout="NTC"), (2, 4, 3)),
        "rnn_relu_tnc": (lambda r: r.RNN(5, bidirectional=True), (4, 2, 3)),
    }[kind]
    ref, got = _layer_pair(make)
    x = _r(7).randn(*shape).astype(onp.float32)
    want = ref(mx.nd.array(x))                 # finishes the deferred init
    _carry(got, ref)
    with mt.cpu():
        _close(got(mt.nd.array(x)), want, "output")
        batch = shape[0] if kind.endswith("ntc") else shape[1]
        states = got.begin_state(batch)
        ref_states = ref.begin_state(batch)
        assert [s.shape for s in states] == [s.shape for s in ref_states]
        h = [mt.nd.array(_r(8 + i).randn(*s.shape).astype(onp.float32))
             for i, s in enumerate(states)]
        out, new = got(mt.nd.array(x), h)
    r_out, r_new = ref(mx.nd.array(x), [mx.nd.array(s.asnumpy())
                                        for s in h])
    _close(out, r_out, "output with states")
    for i, (g, w) in enumerate(zip(new, r_new)):
        _close(g, w, f"state {i}")
    assert sorted(got._collect_params_with_prefix()) == \
        sorted(ref._collect_params_with_prefix())


def _cell_pair(make, x, unroll_kw):
    mx.random.seed(1)
    ref = make(jrnn)
    ref.initialize(mx.init.Uniform(0.3))
    r_out, r_states = ref.unroll(x.shape[1], mx.nd.array(x), **unroll_kw)
    with mt.cpu():
        got = make(mt.gluon.rnn)
        _carry(got, ref)
        g_out, g_states = got.unroll(x.shape[1], mt.nd.array(x),
                                     **unroll_kw)
    assert sorted(got._collect_params_with_prefix()) == \
        sorted(ref._collect_params_with_prefix())
    return (r_out, r_states), (g_out, g_states)


def _lstm_stack(r):
    s = r.SequentialRNNCell()
    s.add(r.LSTMCell(4))
    s.add(r.GRUCell(6))
    return s


def _residual(r):
    s = r.HybridSequentialRNNCell()
    s.add(r.RNNCell(5, activation="relu"))
    s.add(r.ResidualCell(r.GRUCell(5)))
    s.add(r.DropoutCell(0.5))
    s.add(r.ZoneoutCell(r.LSTMCell(5), zoneout_outputs=0.3,
                        zoneout_states=0.2))
    return s


CELL_CASES = {
    "lstm": (lambda r: r.LSTMCell(8), dict(layout="NTC",
                                           merge_outputs=True)),
    "gru": (lambda r: r.GRUCell(6), dict(layout="NTC", merge_outputs=False)),
    "rnn": (lambda r: r.RNNCell(5), dict(layout="NTC", merge_outputs=True)),
    "stack": (_lstm_stack, dict(layout="NTC", merge_outputs=True)),
    "valid_length": (lambda r: r.LSTMCell(4), "valid"),
    "residual_dropout_zoneout": (_residual, dict(layout="NTC",
                                                 merge_outputs=True)),
    "bidirectional": (lambda r: r.BidirectionalCell(r.LSTMCell(4),
                                                    r.GRUCell(3)),
                      dict(layout="NTC", merge_outputs=True)),
}


@pytest.mark.parametrize("kind", sorted(CELL_CASES))
def test_rnn_cells_match_the_reference(kind):
    """Unrolled over 3 steps of (N=2, T=3, C=5) inputs in predict mode
    (dropout and zoneout pass values through)."""
    make, kw = CELL_CASES[kind]
    x = _r(9).randn(2, 3, 5).astype(onp.float32)
    if kw == "valid":
        kw = {"layout": "NTC", "merge_outputs": True}
        ref = make(jrnn)
        mx.random.seed(1)
        ref.initialize(mx.init.Uniform(0.3))
        vl = onp.float32([2, 3])
        r_out, r_states = ref.unroll(3, mx.nd.array(x),
                                     valid_length=mx.nd.array(vl), **kw)
        with mt.cpu():
            got = make(mt.gluon.rnn)
            _carry(got, ref)
            g_out, g_states = got.unroll(3, mt.nd.array(x),
                                         valid_length=mt.nd.array(vl), **kw)
    else:
        (r_out, r_states), (g_out, g_states) = _cell_pair(make, x, kw)
    if isinstance(r_out, (list, tuple)):
        assert len(g_out) == len(r_out)
        for i, (g, w) in enumerate(zip(g_out, r_out)):
            _close(g, w, f"step {i}")
    else:
        _close(g_out, r_out, "outputs")
    assert len(g_states) == len(r_states)
    for i, (g, w) in enumerate(zip(g_states, r_states)):
        _close(g, w, f"state {i}")


def test_cell_single_step_and_begin_state():
    mx.random.seed(2)
    ref = jrnn.LSTMCell(8)
    ref.initialize(mx.init.Uniform(0.3))
    x = _r(10).randn(2, 5).astype(onp.float32)
    r_out, r_states = ref(mx.nd.array(x), ref.begin_state(2))
    with mt.cpu():
        got = mt.gluon.rnn.LSTMCell(8)
        _carry(got, ref)
        states = got.begin_state(2)
        assert [s.shape for s in states] == [(2, 8), (2, 8)]
        g_out, g_states = got(mt.nd.array(x), states)
    _close(g_out, r_out, "output")
    for g, w in zip(g_states, r_states):
        _close(g, w, "state")


def test_zoneout_draws_masks_in_training_mode():
    with mt.cpu():
        cell = mt.gluon.rnn.ZoneoutCell(mt.gluon.rnn.GRUCell(16),
                                        zoneout_outputs=0.5)
        cell.initialize(mt.init.Uniform(0.3))
        x = mt.nd.array(_r(11).randn(4, 3, 8).astype(onp.float32))
        with mt.autograd.train_mode():
            trained, _ = cell.unroll(3, x, layout="NTC", merge_outputs=True)
        plain, _ = cell.base_cell.unroll(3, x, layout="NTC",
                                         merge_outputs=True)
    kept = trained.asnumpy()[:, 1:] == plain.asnumpy()[:, 1:]
    assert 0.2 < kept.mean() < 0.8


# ---------------------------------------------------------------------------
# the LSTM language model through gluon.Trainer
# ---------------------------------------------------------------------------
class JaxLSTMLanguageModel(mx.gluon.HybridBlock):
    """The reference's side of ``LSTMLanguageModel``:
    examples/rnn/lstm_lm.py's model with the port's dropout blocks and
    carried states, in the JAX package."""

    def __init__(self, vocab, embed, hidden, layers, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.embedding = jnn.Embedding(vocab, embed)
            self.drop_in = jnn.Dropout(dropout)
            self.lstm = jrnn.LSTM(hidden, num_layers=layers, layout="NTC")
            self.drop_out = jnn.Dropout(dropout)
            self.decoder = jnn.Dense(vocab, flatten=False)

    def hybrid_forward(self, F, tokens, states):
        h, states = self.lstm(self.drop_in(self.embedding(tokens)), states)
        return self.decoder(self.drop_out(h)), states


VOCAB, EMBED, HIDDEN, LAYERS, T, BATCH = 50, 16, 32, 2, 7, 3
LR, CLIP, STEPS = 1.0, 0.5, 3


def _bptt(pkg, net, batches):
    """STEPS truncated-BPTT steps: losses per step, and the parameters."""
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LR})
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    states = net.begin_state(BATCH) if hasattr(net, "begin_state") else \
        net.lstm.begin_state(BATCH)
    losses = []
    for x, y in batches:
        with pkg.autograd.record():
            out, states = net(pkg.nd.array(x), states)
            loss = ce(out, pkg.nd.array(y))
        loss.backward()
        grads = [p.grad() for p in net.collect_params().values()
                 if p.grad_req != "null"]
        pkg.gluon.utils.clip_global_norm(grads, CLIP * BATCH)
        trainer.step(BATCH)
        states = [s.detach() for s in states]
        losses.append(loss.asnumpy())
    return onp.stack(losses), _weights(net)


def test_lstm_language_model_trains_as_the_reference():
    rng = _r(12)
    corpus = rng.randint(0, VOCAB, (BATCH, STEPS * T + 1))
    batches = [(corpus[:, i * T:(i + 1) * T].astype(onp.float32),
                corpus[:, i * T + 1:(i + 1) * T + 1].astype(onp.float32))
               for i in range(STEPS)]
    mx.random.seed(3)
    ref = JaxLSTMLanguageModel(VOCAB, EMBED, HIDDEN, LAYERS)
    ref.initialize(mx.init.Uniform(0.1))
    ref(mx.nd.array(batches[0][0]), ref.lstm.begin_state(BATCH))
    start = _weights(ref)
    with mt.cpu():
        got = LSTMLanguageModel(VOCAB, EMBED, HIDDEN, LAYERS)
        carrier.load_jax_params(got, start)
        g_losses, g_params = _bptt(mt, got, batches)
    r_losses, r_params = _bptt(mx, ref, batches)
    _close(g_losses, r_losses, "losses")
    assert sorted(g_params) == sorted(r_params) == [
        "decoder.bias", "decoder.weight", "embedding.weight",
        "lstm.parameters"]
    for k in r_params:
        assert not onp.allclose(r_params[k], start[k]), k   # they trained
        _close(g_params[k], r_params[k], k)


def test_carrier_takes_the_lstm_language_model():
    mx.random.seed(5)
    ref = JaxLSTMLanguageModel(VOCAB, EMBED, HIDDEN, LAYERS)
    ref.initialize(mx.init.Uniform(0.1))
    ref(mx.nd.array(onp.zeros((BATCH, T), onp.float32)),
        ref.lstm.begin_state(BATCH))
    named = _weights(ref)
    state = carrier.params_from_jax(named)
    with mt.cpu():
        got = LSTMLanguageModel(VOCAB, EMBED, HIDDEN, LAYERS)
        got.load_state_dict(state)
        for k, v in _weights(got).items():
            onp.testing.assert_array_equal(v, named[k], err_msg=k)
    bad = dict(named, **{"lstm.parameters": named["lstm.parameters"][:-1]})
    with pytest.raises(mt.MXNetError, match="LSTMLanguageModel"):
        carrier.params_from_jax(bad)
    with pytest.raises(mt.MXNetError, match="LSTMLanguageModel"):
        carrier.params_from_jax({k: v for k, v in named.items()
                                 if k != "decoder.bias"})


def test_rnn_layer_keeps_the_module_methods():
    """The flat vector is named ``parameters`` (the reference's name) but
    does not hide ``torch.nn.Module.parameters()`` on the layer."""
    with mt.cpu():
        net = LSTMLanguageModel(VOCAB, EMBED, HIDDEN, LAYERS)
        net.initialize(mt.init.Uniform(0.1))
        (flat,) = net.lstm.collect_params().values()
        with mt.autograd.record():
            out, _ = net(mt.nd.array(onp.zeros((BATCH, T), onp.float32)),
                         net.begin_state(BATCH))
        out.backward()
        tensors = list(net.lstm.parameters())
        assert len(tensors) == 1
        assert tensors[0] is flat.data()._data
        assert tensors[0].shape == (rnn_param_size(
            "lstm", LAYERS, EMBED, HIDDEN, False),)
        assert [n for n, _ in net.lstm.named_parameters()] == ["parameters"]
        assert flat.grad().abs().sum().asscalar() > 0
        net.lstm.zero_grad()
        assert tensors[0].grad is None
        net.lstm.requires_grad_(False)
        assert not tensors[0].requires_grad
        assert len(list(net.parameters())) == 4


def test_rnn_op_ignores_p_as_the_reference():
    """ROADMAP Queue 3: the reference's RNN op accepts ``p`` and does not
    apply it, so ``LSTM(dropout=0.5)`` in training mode gives the outputs
    of ``dropout=0``; the port keeps that behaviour."""
    x = _r(13).randn(5, 2, 4).astype(onp.float32)
    outs = {}
    for pkg, rnn_mod in ((mx, jrnn), (mt, mt.gluon.rnn)):
        with pkg.cpu():
            pkg.random.seed(4)
            a = rnn_mod.LSTM(6, num_layers=2, dropout=0.5)
            a.initialize(pkg.init.Uniform(0.3))
            with pkg.autograd.record(train_mode=True):
                with_p = a(pkg.nd.array(x)).asnumpy()
            b = rnn_mod.LSTM(6, num_layers=2, dropout=0.0)
            b.initialize(pkg.init.Uniform(0.3))
            b(pkg.nd.array(x))
            (pa,), (pb,) = (n.collect_params().values() for n in (a, b))
            pb.set_data(pa.data())
            with pkg.autograd.record(train_mode=True):
                outs[pkg.__name__] = (with_p, b(pkg.nd.array(x)).asnumpy())
    for name, (with_p, without) in outs.items():
        onp.testing.assert_array_equal(with_p, without, err_msg=name)
