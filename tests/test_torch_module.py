"""The port's ``Module``, ``BucketingModule``, ``model`` checkpoints and
checkpoint callbacks against the JAX package's, both on the CPU. Oracles:
tests/test_symbol_module.py and the reference's ``module/module.py``,
``model.py`` and ``callback.py``.

Both packages get the same graph (``tools/symbol_bert.py``'s 2-layer,
64-unit, 2-head, S = 16 encoder, or the reference tests' MLP), the same
initial weights (numpy, seeded) and the same ``NDArrayIter`` batches;
parameters after every epoch of ``fit`` (SGD), ``score`` and ``predict``
agree within f32 1e-5 x max(1, max|ref|) (sums in another order).
Checkpoints written by either package load in the other. The symbolic
BERT, given the port's Gluon ``BERTModel`` weights, equals that model's
sequence output within f32 1e-5.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
from mxnet_tpu_torch.tools import seeded_bert_weights
from mxnet_tpu_torch.tools.symbol_bert import (encoder_output,
                                               gluon_arg_params, symbol_bert)

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

TOL = 1e-5
SMALL = dict(layers=2, units=64, heads=2, ffn=128, seq=16, vocab=100,
             classes=3, dropout=0.0)
N, BATCH = 16, 4


def _mlp(sym):
    data = sym.var("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _bert(sym):
    return symbol_bert(sym, **SMALL)


NETS = {"mlp": (_mlp, (32,)), "bert": (_bert, (SMALL["seq"],))}


def _data(graph, seed=0):
    rng = onp.random.RandomState(seed)
    shape = (N,) + NETS[graph][1]
    if graph == "bert":
        x = rng.randint(0, SMALL["vocab"], shape).astype("float32")
    else:
        x = rng.randn(*shape).astype("float32")
    return x, rng.randint(0, 3, (N,)).astype("float32")


def _weights(graph, seed=1):
    """Seeded numpy values for every parameter of the graph."""
    build, tail = NETS[graph]
    ref = build(mx.sym)
    shapes = dict(zip(ref.list_arguments(), ref.infer_shape(
        data=(BATCH,) + tail, softmax_label=(BATCH,))[0]))
    rng = onp.random.RandomState(seed)
    out = {}
    for k, shp in shapes.items():
        if k in ("data", "softmax_label"):
            continue
        if k.endswith("gamma"):
            out[k] = (1 + 0.1 * rng.randn(*shp)).astype("float32")
        else:
            out[k] = (0.1 * rng.randn(*shp)).astype("float32")
    return out


def _iter(pkg, graph, seed=0):
    x, y = _data(graph, seed)
    with pkg.cpu():
        return pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False,
                                  label_name="softmax_label")


def _close(got, want, what):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, what
    err = onp.abs(got - want).max() / max(1.0, onp.abs(want).max())
    assert err <= TOL, (what, err)


def _fit(pkg, graph, epochs=2):
    build, _ = NETS[graph]
    with pkg.name.NameManager():
        net = build(pkg.sym)
    w = _weights(graph)
    with pkg.cpu():
        arg = {k: pkg.nd.array(v) for k, v in w.items()}
    mod = pkg.mod.Module(net, context=pkg.cpu())
    snaps = []

    def epoch_end(epoch, sym, arg_p, aux_p):
        snaps.append({k: v.asnumpy().copy() for k, v in arg_p.items()})

    train = _iter(pkg, graph)
    mod.fit(train, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05}, arg_params=arg,
            aux_params={}, epoch_end_callback=epoch_end)
    return mod, snaps


@pytest.mark.parametrize("graph", sorted(NETS))
def test_fit_equals_the_reference_after_every_epoch(graph):
    rmod, rsnaps = _fit(mx, graph)
    tmod, tsnaps = _fit(mt, graph)
    assert len(tsnaps) == len(rsnaps) == 2
    for e, (r, t) in enumerate(zip(rsnaps, tsnaps)):
        assert sorted(t) == sorted(r)
        for k in r:
            _close(t[k], r[k], f"epoch {e} {k}")
    rs = dict(rmod.score(_iter(mx, graph, 1), "acc"))
    ts = dict(tmod.score(_iter(mt, graph, 1), "acc"))
    assert ts == rs
    _close(tmod.predict(_iter(mt, graph, 1)).asnumpy(),
           rmod.predict(_iter(mx, graph, 1)).asnumpy(), "predict")
    rl = dict(rmod.score(_iter(mx, graph, 1), mx.metric.CrossEntropy()))
    tl = dict(tmod.score(_iter(mt, graph, 1), mt.metric.CrossEntropy()))
    _close(tl["cross-entropy"], rl["cross-entropy"], "cross-entropy")


def _bound(pkg, graph, for_training=True):
    build, tail = NETS[graph]
    with pkg.name.NameManager():
        net = build(pkg.sym)
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (BATCH,) + tail)],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=for_training)
    return mod


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_cross_between_the_packages(direction, tmp_path):
    """Module.save_checkpoint in one package, Module.load + predict in the
    other: the same predictions, the symbol file byte-equal."""
    src, dst = (mx, mt) if direction == "reference_to_port" else (mt, mx)
    w = _weights("bert")
    mod = _bound(src, "bert")
    with src.cpu():
        mod.init_params(arg_params={k: src.nd.array(v)
                                    for k, v in w.items()}, aux_params={})
    prefix = str(tmp_path / "bert")
    mod.save_checkpoint(prefix, 3)
    want = mod.predict(_iter(src, "bert")).asnumpy()
    loaded = dst.mod.Module.load(prefix, 3, context=dst.cpu())
    loaded.bind(data_shapes=[("data", (BATCH, SMALL["seq"]))],
                label_shapes=[("softmax_label", (BATCH,))],
                for_training=False)
    _close(loaded.predict(_iter(dst, "bert")).asnumpy(), want, "predict")
    with dst.cpu():
        sym, arg, aux = dst.model.load_checkpoint(prefix, 3)
    assert sorted(arg) == sorted(w) and aux == {}
    for k, v in w.items():
        onp.testing.assert_array_equal(arg[k].asnumpy(), v)
    assert sym.list_arguments() == mod.symbol.list_arguments()


def test_model_checkpoint_files_equal_the_references(tmp_path):
    """model.save_checkpoint writes the reference's two files, loadable by
    either package's load_params."""
    w = _weights("mlp")
    for tag, pkg in (("ref", mx), ("port", mt)):
        with pkg.name.NameManager():
            net = _mlp(pkg.sym)
        with pkg.cpu():
            arg = {k: pkg.nd.array(v) for k, v in w.items()}
        pkg.model.save_checkpoint(str(tmp_path / tag), 7, net, arg, {})
    assert (tmp_path / "port-symbol.json").read_text() == \
        (tmp_path / "ref-symbol.json").read_text()
    for pkg in (mx, mt):
        for tag in ("ref", "port"):
            with pkg.cpu():
                arg, aux = pkg.model.load_params(str(tmp_path / tag), 7)
            assert aux == {} and sorted(arg) == sorted(w)
            for k in w:
                onp.testing.assert_array_equal(arg[k].asnumpy(), w[k])


def test_checkpoint_callbacks_write_the_references_files(tmp_path):
    """do_checkpoint and module_checkpoint: the same file names after the
    same epochs, the same contents."""
    w = _weights("mlp")
    names = {}
    for tag, pkg in (("ref", mx), ("port", mt)):
        d = tmp_path / tag
        d.mkdir()
        with pkg.name.NameManager():
            net = _mlp(pkg.sym)
        with pkg.cpu():
            arg = {k: pkg.nd.array(v) for k, v in w.items()}
        cb = pkg.callback.do_checkpoint(str(d / "do"), period=2)
        for epoch in range(4):
            cb(epoch, net, arg, {})
        mod = _bound(pkg, "mlp")
        with pkg.cpu():
            mod.init_params(arg_params=arg, aux_params={})
        mcb = pkg.callback.module_checkpoint(mod, str(d / "mod"), period=3)
        for epoch in range(3):
            mcb(epoch)
        names[tag] = sorted(p.name for p in d.iterdir())
    assert names["port"] == names["ref"] == [
        "do-0002.params", "do-0004.params", "do-symbol.json",
        "mod-0003.params", "mod-symbol.json"]
    for f in names["ref"]:
        if f.endswith(".json"):
            assert (tmp_path / "port" / f).read_text() == \
                (tmp_path / "ref" / f).read_text()
        else:
            r = mx.nd.load(str(tmp_path / "ref" / f))
            with mt.cpu():
                t = mt.nd.load(str(tmp_path / "port" / f))
            assert sorted(t) == sorted(r)
            for k in r:
                onp.testing.assert_array_equal(t[k].asnumpy(),
                                               r[k].asnumpy())


def test_optimizer_states_are_saved(tmp_path):
    mod = _bound(mt, "mlp")
    with mt.cpu():
        mod.init_params(arg_params={k: mt.nd.array(v) for k, v in
                                    _weights("mlp").items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    batch = next(iter(_iter(mt, "mlp")))
    mod.forward_backward(batch)
    mod.update()
    mod.save_checkpoint(str(tmp_path / "m"), 1, save_optimizer_states=True)
    assert (tmp_path / "m-0001.states").stat().st_size > 0


class _Batch:
    def __init__(self, pkg, key, x, y):
        self.bucket_key = key
        with pkg.cpu():
            self.data = [pkg.nd.array(x)]
            self.label = [pkg.nd.array(y)]
        self.provide_data = [("data", x.shape)]
        self.provide_label = [("softmax_label", y.shape)]


def _bucketing(pkg, w, batches):
    def sym_gen(key):
        with pkg.name.NameManager():
            return _bert(pkg.sym), ("data",), ("softmax_label",)

    bm = pkg.mod.BucketingModule(sym_gen, default_bucket_key=16,
                                 context=pkg.cpu())
    bm.bind(data_shapes=[("data", (BATCH, 16))],
            label_shapes=[("softmax_label", (BATCH,))])
    with pkg.cpu():
        bm.init_params(arg_params={k: pkg.nd.array(v) for k, v in w.items()},
                       aux_params={})
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1})
    outs = []
    for key, x, y, train in batches:
        bm.forward(_Batch(pkg, key, x, y), is_train=train)
        outs.append(bm.get_outputs()[0].asnumpy())
        if train:
            bm.backward()
            bm.update()
    return bm, outs


def test_bucketing_module_equals_the_reference():
    """Buckets 8 and 16 over one parameter set: the same outputs through
    updates under either bucket; the buckets' executors hold the same
    parameter objects (the reference's sharing, bucketing_module.py)."""
    rng = onp.random.RandomState(4)
    plan = []
    for key, train in ((16, False), (8, True), (16, True), (8, False),
                       (16, False)):
        plan.append((key, rng.randint(0, SMALL["vocab"], (BATCH, key))
                     .astype("float32"),
                     rng.randint(0, 3, (BATCH,)).astype("float32"), train))
    w = _weights("bert")
    rbm, routs = _bucketing(mx, w, plan)
    tbm, touts = _bucketing(mt, w, plan)
    for i, (t, r) in enumerate(zip(touts, routs)):
        _close(t, r, f"step {i}")
    assert sorted(tbm._buckets) == sorted(rbm._buckets) == [8, 16]
    for k in w:
        assert tbm._buckets[8]._exec.arg_dict[k] is \
            tbm._buckets[16]._exec.arg_dict[k]
    assert tbm.symbol is not None
    _close(tbm.get_params()[0]["layer0_qkv_weight"].asnumpy(),
           rbm.get_params()[0]["layer0_qkv_weight"].asnumpy(), "params")
    tbm.switch_bucket(8, [("data", (BATCH, 8))],
                      [("softmax_label", (BATCH,))])
    assert tbm._curr is tbm._buckets[8]


def test_the_references_bucketing_case():
    """tests/test_symbol_module.py::test_bucketing_module on the port."""
    def sym_gen(seq_len):
        data = mt.sym.var("data")
        fc = mt.sym.FullyConnected(data, num_hidden=8, name="fc_shared")
        out = mt.sym.SoftmaxOutput(fc, name="softmax")
        return out, ("data",), ("softmax_label",)

    bm = mt.mod.BucketingModule(sym_gen, default_bucket_key=16,
                                context=mt.cpu())
    bm.bind(data_shapes=[("data", (4, 16))],
            label_shapes=[("softmax_label", (4,))])
    with mt.cpu():
        bm.init_params(mt.init.Uniform(0.1))
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1})
    rng = onp.random.RandomState(0)
    batch = _Batch(mt, 16, rng.randn(4, 16).astype("float32"),
                   onp.zeros(4, "float32"))
    bm.forward(batch, is_train=True)
    bm.backward()
    bm.update()
    bm.forward(batch, is_train=True)
    assert bm.get_outputs()[0].shape == (4, 8)
    with pytest.raises(MXNetError, match="call forward"):
        mt.mod.BucketingModule(sym_gen, 16, context=mt.cpu()).backward()


def test_module_api_errors_and_params():
    with mt.name.NameManager():
        mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    with pytest.raises(MXNetError, match="bind before init_params"):
        mod.init_params()
    with pytest.raises(MXNetError, match="bound module"):
        mod.install_monitor(mt.Monitor(1))
    mod = _bound(mt, "mlp")
    w = _weights("mlp")
    with mt.cpu():
        partial = {k: mt.nd.array(v) for k, v in w.items()
                   if k != "fc2_bias"}
        with pytest.raises(MXNetError, match="fc2_bias missing"):
            mod.init_params(arg_params=partial)
        mod.init_params(arg_params=partial, allow_missing=True)
    arg, aux = mod.get_params()
    assert sorted(arg) == sorted(w) and aux == {}
    onp.testing.assert_array_equal(arg["fc1_weight"].asnumpy(),
                                   w["fc1_weight"])
    with mt.cpu():
        mod.set_params({k: mt.nd.array(v * 2) for k, v in w.items()}, {})
    onp.testing.assert_array_equal(
        mod.get_params()[0]["fc2_bias"].asnumpy(), w["fc2_bias"] * 2)
    assert mod.get_input_grads() == [None]


def test_the_symbolic_bert_equals_the_gluon_bert():
    """The port's Gluon BERTModel's seeded weights carried onto the graph
    (``gluon_arg_params``): the encoder's output equals the model's
    sequence output (dropout 0, token types 0) within f32 1e-5."""
    net = BERTModel(num_layers=SMALL["layers"], units=SMALL["units"],
                    hidden_size=SMALL["ffn"], num_heads=SMALL["heads"],
                    vocab_size=SMALL["vocab"], max_length=SMALL["seq"],
                    dropout=0.0)
    named = seeded_bert_weights(net, 0)
    from mxnet_tpu_torch.gluon.model_zoo.carrier import load_jax_params
    load_jax_params(net, named, ctx=mt.cpu())
    args = gluon_arg_params(named)
    assert "pooler.weight" in named and len(args) == len(named) - 2
    enc = encoder_output(symbol_bert(mt.sym, **SMALL), SMALL["layers"])
    assert sorted(enc.list_arguments()) == sorted(["data", *args])
    ex = enc.simple_bind(mt.cpu(), grad_req="null",
                         data=(BATCH, SMALL["seq"]))
    with mt.cpu():
        ex.copy_params_from({k: mt.nd.array(v) for k, v in args.items()})
        tokens = onp.random.RandomState(2).randint(
            0, SMALL["vocab"], (BATCH, SMALL["seq"]))
        got = ex.forward(data=tokens.astype("float32"))[0].asnumpy()
        t = mt.nd.array(tokens, dtype="int32")
        want = net(t, mt.nd.zeros(tokens.shape, dtype="int32"))[0]
    want = want.asnumpy() if hasattr(want, "asnumpy") else \
        want.detach().numpy()
    _close(got, want, "sequence output")
    with pytest.raises(KeyError, match="no graph argument"):
        gluon_arg_params({"decoder.weight": 0})
