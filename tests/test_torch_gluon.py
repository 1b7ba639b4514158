"""The port's Gluon surface (Block, HybridBlock, Parameter, ParameterDict,
initializers, losses, Trainer, utils, ``.params`` files, the model zoo's
names) against the JAX package on the CPU, at a small size.

Inputs and weights are made with numpy from a seed and handed to both
packages (the weights as numpy arrays). The JAX package runs as its own
tests run it on the CPU (its Trainer with ``kvstore="device"``).
Tolerances:

- deterministic initializers, the suffix dispatch, ``.params`` bytes and
  names: exact.
- random initializers, over at least 1e5 draws: each bound exact; mean
  within 5 standard errors of 0; the standard deviation within 1% of the
  formula's (5 standard errors at 1e5 draws are 1.6% for a uniform
  draw's variance, 0.45% of its standard deviation). Orthogonal: W W^T = I
  within 1e-5.
- hybridized against eager in the port: bitwise (``hybridize`` keeps the
  eager forward).
- losses: 1e-6 relative to max(1, |loss|) (both f32, a few operations in
  another order).
- the LeNet drive (Xavier, SGD 0.1, three eager then three hybridized
  steps): losses and parameters within rtol 1e-5 (atol 1e-6 for weights
  that are near zero); f32 on both sides, sums in another order.
- the small BERT through ``Trainer("adam")`` (three steps, f32): losses
  within 1e-5 relative; parameters within 0.05 lr, as the port's
  ``ParallelTrainStep`` test holds them (one Adam step moves a weight by
  about lr, and the sign of a near-zero gradient can flip with the order
  of the sums).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jax_autograd
from mxnet_tpu import gluon as jax_gluon
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon.model_zoo import bert as jax_bert
from mxnet_tpu.gluon.model_zoo import vision as jax_vision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd, parallel
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert, vision

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's arrays and parameters default to gpu(0); these tests
    run on the CPU."""
    with CPU:
        yield


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
DETERMINISTIC = [
    ("Zero", {}, "weight", (5, 7)),
    ("One", {}, "weight", (5, 7)),
    ("Constant", {"value": 0.3}, "weight", (5, 7)),
    ("Constant", {"value": -2.0}, "thing", (3,)),
    ("Bilinear", {}, "upsample_weight", (2, 1, 4, 4)),
    ("Bilinear", {}, "upsample_weight", (3, 1, 5, 3)),
    ("LSTMBias", {"forget_bias": 1.0}, "lstm_i2h_weight", (16,)),
    ("LSTMBias", {"forget_bias": 2.5}, "lstm_h2h_bias", (32,)),
]


@pytest.mark.parametrize("name,kw,pname,shape", DETERMINISTIC,
                         ids=[f"{d[0]}{i}" for i, d in
                              enumerate(DETERMINISTIC)])
def test_deterministic_initializer_equals_jax(name, kw, pname, shape):
    want = mx.nd.zeros(shape)
    getattr(mx.init, name)(**kw)(mx.init.InitDesc(pname), want)
    got = nd.zeros(shape)
    getattr(mt.init, name)(**kw)(mt.init.InitDesc(pname), got)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("pname", ["bn_gamma", "bn_beta", "fc_bias",
                                   "bn_running_mean", "bn_running_var",
                                   "bn_moving_var"])
def test_suffix_dispatch_equals_jax(pname):
    want = mx.nd.ones((4, 3)) * 7
    mx.init.Uniform()(pname, want)
    got = nd.ones((4, 3)) * 7
    mt.init.Uniform()(pname, got)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_mixed_and_load_equal_jax():
    values = {"arg:a_weight": onp.arange(6, dtype=onp.float32).reshape(2, 3)}
    for pkg, mk in ((mx, mx.nd.array), (mt, nd.array)):
        load = pkg.init.Load({k: mk(v) for k, v in values.items()},
                             default_init=pkg.init.Constant(5.0))
        mixed = pkg.init.Mixed(["a_.*", ".*"],
                               [load, pkg.init.Constant(-1.0)])
        out = []
        for name in ("a_weight", "b_weight"):
            arr = pkg.nd.zeros((2, 3))
            mixed(name, arr)
            out.append(arr.asnumpy())
        if pkg is mx:
            want = out
        else:
            got = out
    for a, b in zip(got, want):
        onp.testing.assert_array_equal(a, b)
    with pytest.raises(MXNetError, match="did not match"):
        mt.init.Mixed(["x.*"], [mt.init.Zero()])("y", nd.zeros((2,)))


def _draw(init, shape, pname="weight"):
    arr = nd.zeros(shape)
    init(mt.init.InitDesc(pname), arr)
    return arr.asnumpy().astype(onp.float64)


def _check_moments(a, std, bound=None):
    n = a.size
    assert n >= 100_000
    assert abs(a.mean()) < 5 * std / n ** 0.5
    assert abs(a.std() / std - 1) < 0.01
    if bound is not None:
        assert a.min() >= -bound and a.max() <= bound
        assert a.max() > 0.99 * bound and a.min() < -0.99 * bound


def test_uniform_and_normal_distributions():
    _check_moments(_draw(mt.init.Uniform(0.07), (400, 300)),
                   0.07 / 3 ** 0.5, 0.07)
    _check_moments(_draw(mt.init.Normal(0.02), (400, 300)), 0.02)


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_xavier_distribution(rnd_type, factor_type):
    shape = (64, 32, 3, 3)                  # 18432 per filter bank
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = (2.0 / factor) ** 0.5
    a = onp.concatenate([_draw(mt.init.Xavier(rnd_type, factor_type, 2),
                               shape).ravel() for _ in range(6)])
    if rnd_type == "uniform":
        _check_moments(a, scale / 3 ** 0.5, scale)
    else:
        _check_moments(a, scale)


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_msraprelu_distribution(factor_type):
    shape = (300, 400)
    fan_in, fan_out = 400, 300
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    magnitude = 2.0 / (1 + 0.25 ** 2)
    _check_moments(_draw(mt.init.MSRAPrelu(factor_type, 0.25), shape),
                   (magnitude / factor) ** 0.5)


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_rows_are_orthonormal(rand_type):
    w = _draw(mt.init.Orthogonal(scale=1.0, rand_type=rand_type),
              (64, 8, 4, 4)).reshape(64, -1)
    onp.testing.assert_allclose(w @ w.T, onp.eye(64), rtol=0, atol=1e-5)


def test_same_seed_same_draws():
    draws = []
    for _ in range(2):
        mt.random.seed(42)
        draws.append(_draw(mt.init.Xavier(), (50, 60)))
    mt.random.seed(43)
    other = _draw(mt.init.Xavier(), (50, 60))
    onp.testing.assert_array_equal(draws[0], draws[1])
    assert not onp.array_equal(draws[0], other)


@pytest.mark.parametrize("mode,layers,bi", [("lstm", 2, True),
                                             ("gru", 1, False)])
def test_fused_rnn_equals_jax(mode, layers, bi):
    """A fused RNN's flat vector: the inner initializer per sub-matrix
    (a constant here, so the layout is compared exactly), biases 0 and an
    LSTM's forget gates forget_bias / 2."""
    g, h, n_in, d = {"lstm": 4, "gru": 3}[mode], 5, 3, 2 if bi else 1
    size = sum(d * (g * h * (n_in if i == 0 else h * d) + g * h * h)
               for i in range(layers)) + layers * d * 2 * g * h
    want = mx.nd.zeros((size,))
    mx.init.FusedRNN(mx.init.Constant(0.25), h, layers, mode, bi, 1.5)(
        "rnn_parameters", want)
    got = nd.zeros((size,))
    mt.init.FusedRNN(mt.init.Constant(0.25), h, layers, mode, bi, 1.5)(
        "rnn_parameters", got)
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_initializer_create_and_dumps():
    x = mt.init.Xavier("gaussian", "in", 2.5)
    again = mt.init.create(x.dumps())
    assert isinstance(again, mt.init.Xavier) and again._kwargs == x._kwargs
    assert isinstance(mt.init.create("zeros"), mt.init.Zero)
    assert mt.initializer.create(x) is x


# ---------------------------------------------------------------------------
# Parameter, Block and deferred initialization (tests/test_gluon.py)
# ---------------------------------------------------------------------------
def test_parameter():
    p = gluon.Parameter("weight", shape=(10, 10))
    with pytest.raises(MXNetError, match="not been initialized"):
        p.data()
    p.initialize(init=mt.init.Xavier(), ctx=[CPU])
    assert len(p.list_data()) == 1 and len(p.list_grad()) == 1
    assert p.data(CPU).shape == (10, 10)
    assert p.var() is p
    p.zero_grad()
    assert (p.grad().asnumpy() == 0).all()
    # several contexts: one copy each, keyed by the context
    p2 = gluon.Parameter("w2", shape=(2,))
    p2.initialize(ctx=[CPU, mt.cpu(1)])
    assert p2.list_ctx() == [CPU, mt.cpu(1)]
    assert p2.data(mt.cpu(1)).context == mt.cpu(1)
    with pytest.raises(MXNetError, match="not initialized on"):
        p2.data(mt.cpu(2))


def test_constant():
    class Test(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.value = onp.asarray([[1, 2], [3, 4.0]])
            self.const = self.params.get_constant("const", self.value)

        def hybrid_forward(self, F, x, const):
            return x + const

    test = Test()
    test.initialize()
    trainer = gluon.Trainer(test.collect_params(), "sgd",
                            {"learning_rate": 1.0, "momentum": 0.5})
    with autograd.record():
        x = nd.ones((2, 2))
        x.attach_grad()
        y = test(x)
        y.backward()
    trainer.step(1)
    assert (test.const.data().asnumpy() == test.value).all()
    assert (x.grad.asnumpy() == 1).all()


def test_dense():
    model = nn.Dense(128, activation="tanh", in_units=10, flatten=False)
    inputs = nd.zeros((2, 3, 10))
    model.initialize()
    assert model(inputs).shape == (2, 3, 128)
    model2 = nn.Dense(64, in_units=30)
    model2.initialize()
    assert model2(nd.zeros((17, 2, 15))).shape == (17, 64)


def test_deferred_init():
    model = nn.Dense(10)
    model.initialize()
    with pytest.raises(gluon.DeferredInitializationError):
        model.weight.data()
    out = model(nd.zeros((4, 7)))
    assert model.weight.shape == (10, 7) and out.shape == (4, 10)
    for layer, x in ((nn.Conv2D(4, 3), nd.zeros((2, 5, 8, 8))),
                     (nn.BatchNorm(), nd.zeros((2, 6, 3, 3))),
                     (nn.LayerNorm(), nd.zeros((2, 9)))):
        layer.initialize()
        layer(x)
    assert layer.gamma.shape == (9,)


def test_sequential_and_children():
    net = nn.Sequential()
    net.add(nn.Dense(5), nn.Dense(3))
    assert len(net) == 2 and isinstance(net[0], nn.Dense)
    net.initialize()
    assert net(nd.ones((2, 4))).shape == (2, 3)
    assert len(net.collect_params()) == 4     # 2 weights + 2 biases
    assert len(list(net.parameters())) == 4   # registered on the modules


def test_hybrid_equals_eager_bitwise():
    rng = onp.random.RandomState(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.LayerNorm(), nn.Dense(4))
    net.initialize()
    x = nd.array(rng.rand(5, 8).astype("f"))
    eager = net(x).asnumpy()
    net.hybridize()
    assert net._active and net[0]._active
    onp.testing.assert_array_equal(net(x).asnumpy(), eager)
    onp.testing.assert_array_equal(net(x).asnumpy(), eager)


def test_batchnorm_stats_under_record():
    bn = nn.BatchNorm(in_channels=3, momentum=0.5)
    bn.initialize()
    x = nd.array(onp.random.RandomState(1).rand(4, 3, 5, 5)
                 .astype("f") * 2 + 1)
    out_pred = bn(x)                     # not training: running stats
    assert (bn.running_mean.data().asnumpy() == 0).all()
    onp.testing.assert_allclose(out_pred.asnumpy(), x.asnumpy() /
                                onp.sqrt(1 + 1e-5), rtol=1e-6)
    with autograd.record():
        bn(x)
    rm = bn.running_mean.data().asnumpy()
    onp.testing.assert_allclose(rm, 0.5 * x.asnumpy().mean(axis=(0, 2, 3)),
                                rtol=1e-5)
    with autograd.record(train_mode=False):
        bn(x)                           # recorded, not training: no update
    onp.testing.assert_array_equal(bn.running_mean.data().asnumpy(), rm)


def test_embedding():
    emb = nn.Embedding(10, 4)
    emb.initialize()
    out = emb(nd.array([0, 5, 9], dtype="int32"))
    assert out.shape == (3, 4)
    onp.testing.assert_array_equal(out.asnumpy(),
                                   emb.weight.data().asnumpy()[[0, 5, 9]])


def test_block_save_load(tmp_path):
    fname = str(tmp_path / "model.params")
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4), nn.Dense(2, in_units=8))
    net.initialize()
    x = nd.ones((1, 4))
    ref = net(x).asnumpy()
    net.save_parameters(fname)
    net2 = nn.HybridSequential()
    net2.add(nn.Dense(8, in_units=4), nn.Dense(2, in_units=8))
    net2.load_parameters(fname)
    onp.testing.assert_array_equal(net2(x).asnumpy(), ref)


def test_trainer_sgd_momentum():
    p = gluon.Parameter("w", shape=(3,))
    p.initialize(init=mt.init.One())
    trainer = gluon.Trainer({"w": p}, "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    p.grad()._set_data(nd.ones((3,)).data)
    trainer.step(1)
    onp.testing.assert_allclose(p.data().asnumpy(), onp.full(3, 0.9, "f"))
    p.grad()._set_data(nd.ones((3,)).data)
    trainer.step(1)
    # v = 0.9*(-0.1) - 0.1 = -0.19; w = 0.9 - 0.19 = 0.71
    onp.testing.assert_allclose(p.data().asnumpy(), onp.full(3, 0.71, "f"),
                                rtol=1e-6)


def test_trainer_save_load_states(tmp_path):
    fname = str(tmp_path / "opt.states")
    p = gluon.Parameter("w", shape=(2,))
    p.initialize(init=mt.init.One())
    tr = gluon.Trainer({"w": p}, "adam", {"learning_rate": 0.1})
    p.grad()._set_data(nd.ones((2,)).data)
    tr.step(1)
    tr.save_states(fname)
    tr2 = gluon.Trainer({"w": p}, "adam", {"learning_rate": 0.1})
    tr2.load_states(fname)
    assert tr2._updaters.states
    for a, b in zip(tr._updaters.states[0], tr2._updaters.states[0]):
        assert torch.equal(a, b)
    state = tr.state_dict()
    tr3 = gluon.Trainer({"w": p}, "adam", {"learning_rate": 0.1})
    tr3.load_state_dict(state)
    assert tr3.optimizer.num_update == 1
    for a, b in zip(tr._updaters.states[0], tr3._updaters.states[0]):
        assert torch.equal(a, b)


def test_parameter_dict_get_shared_setattr_save_load(tmp_path):
    pd = gluon.ParameterDict("net_")
    w = pd.get("w", shape=(2, 3))
    assert w.name == "net_w" and pd.get("w") is w
    shared = gluon.ParameterDict("net_", shared=pd)
    assert shared.get("w") is w
    c = pd.get_constant("c", onp.arange(3, dtype="f"))
    pd.initialize(mt.init.Constant(0.5))
    pd.setattr("lr_mult", 0.0)
    assert w.lr_mult == 0.0 and c.lr_mult == 0.0
    fname = str(tmp_path / "pd.params")
    pd.save(fname, strip_prefix="net_")
    other = gluon.ParameterDict("net_")
    other.get("w", shape=(2, 3))
    other.get_constant("c", onp.zeros(3, "f"))
    other.load(fname, restore_prefix="net_")
    onp.testing.assert_array_equal(other["net_w"].data().asnumpy(),
                                   onp.full((2, 3), 0.5, "f"))
    onp.testing.assert_array_equal(other["net_c"].data().asnumpy(),
                                   onp.arange(3, dtype="f"))
    with pytest.raises(MXNetError, match="same name"):
        pd.update({"net_w": gluon.Parameter("net_w", shape=(2, 3))})
    w.reset_ctx(CPU)
    assert w.data().context == CPU


def test_trainer_takes_lr_mult_and_learning_rate():
    frozen, moving = (gluon.Parameter(n, shape=(3,)) for n in ("f", "m"))
    for p in (frozen, moving):
        p.initialize(mt.init.One())
        p.grad()._set_data(nd.ones((3,)).data)
    frozen.lr_mult = 0.0
    trainer = gluon.Trainer([frozen, moving], "sgd", {"learning_rate": 0.5})
    assert trainer.learning_rate == 0.5
    trainer.step(1)
    trainer.set_learning_rate(0.25)
    trainer.step(1)
    onp.testing.assert_array_equal(frozen.data().asnumpy(), onp.ones(3))
    onp.testing.assert_allclose(moving.data().asnumpy(), onp.full(3, 0.25))


@pytest.mark.parametrize("kv", ["dist_sync", "dist_device_sync"])
def test_trainer_refuses_distributed_kvstores(kv):
    """Outside a launched job a distributed store is a one-worker store
    (the reference's; the port refused it before the multi-process
    slice): the Trainer's step over it is the local SGD step."""
    p = gluon.Parameter("w", shape=(2,))
    p.initialize()
    w0 = p.data().asnumpy().copy()
    p.grad()._set_data(nd.ones((2,)).data)
    trainer = gluon.Trainer([p], "sgd", {"learning_rate": 0.5}, kvstore=kv)
    trainer.step(1)
    assert trainer._kvstore.type == kv and trainer._kvstore.num_workers == 1
    onp.testing.assert_array_equal(p.data().asnumpy(),
                                   w0 - onp.float32(0.5))
    # a kvstore-side update works in one process (the reference's SGD
    # step: w - lr * g)
    w0 = p.data().asnumpy().copy()
    p.grad()._set_data(nd.ones((2,)).data)
    trainer = gluon.Trainer([p], "sgd", {"learning_rate": 0.5},
                            update_on_kvstore=True)
    trainer.step(1)
    assert trainer._update_on_kvstore
    onp.testing.assert_array_equal(p.data().asnumpy(),
                                   w0 - onp.float32(0.5))


# (loss, constructor keywords, the inputs' kind)
LOSSES = [
    ("SoftmaxCrossEntropyLoss", {}, "class"),
    ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, "dense"),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "weight": 0.5},
     "class"),
    ("L2Loss", {}, "regress"),
    ("L1Loss", {"weight": 2.0}, "regress"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True}, "prob"),
    ("KLDivLoss", {"from_logits": False}, "dense"),
    ("HuberLoss", {"rho": 0.5}, "regress"),
    ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {"margin": 2}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("TripletLoss", {"margin": 0.5}, "triplet"),
    ("PoissonNLLLoss", {}, "count"),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     "rate"),
    ("CosineEmbeddingLoss", {"margin": 0.1}, "cosine"),
]


def _loss_inputs(kind, rng):
    pred = rng.randn(6, 5).astype("f")
    if kind == "class":
        return [pred, rng.randint(0, 5, (6,)).astype("f")]
    if kind == "dense":
        lab = rng.rand(6, 5).astype("f")
        return [pred, lab / lab.sum(1, keepdims=True)]
    if kind == "regress":
        return [pred, rng.randn(6, 5).astype("f")]
    if kind == "binary":
        return [pred, rng.randint(0, 2, (6, 5)).astype("f")]
    if kind == "prob":
        return [rng.rand(6, 5).astype("f") * 0.98 + 0.01,
                rng.randint(0, 2, (6, 5)).astype("f")]
    if kind == "signed":
        return [pred, rng.randint(0, 2, (6, 5)).astype("f") * 2 - 1]
    if kind == "triplet":
        return [pred, rng.randn(6, 5).astype("f"), rng.randn(6, 5)
                .astype("f")]
    if kind == "count":
        return [pred, rng.poisson(2.0, (6, 5)).astype("f")]
    if kind == "rate":
        return [rng.rand(6, 5).astype("f") + 0.1,
                rng.poisson(2.0, (6, 5)).astype("f")]
    return [pred, rng.randn(6, 5).astype("f"),
            (rng.randint(0, 2, (6,)) * 2 - 1).astype("f")]


@pytest.mark.parametrize("name,kw,kind", LOSSES,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_loss_matches_jax(name, kw, kind):
    inputs = _loss_inputs(kind, onp.random.RandomState(len(name)))
    want = getattr(jax_gluon.loss, name)(**kw)(
        *[mx.nd.array(a) for a in inputs]).asnumpy()
    got = getattr(gluon.loss, name)(**kw)(*[nd.array(a) for a in inputs])
    assert isinstance(got, nd.NDArray) and got.shape == want.shape
    onp.testing.assert_allclose(got.asnumpy(), want, rtol=0,
                                atol=1e-6 * max(1.0, onp.abs(want).max()))


def test_loss_sample_weight_and_batch_axis():
    rng = onp.random.RandomState(3)
    pred, label = rng.randn(4, 6).astype("f"), rng.randn(4, 6).astype("f")
    sw = rng.rand(4, 1).astype("f")
    want = jax_gluon.loss.L2Loss(batch_axis=1)(
        mx.nd.array(pred), mx.nd.array(label), mx.nd.array(sw)).asnumpy()
    got = gluon.loss.L2Loss(batch_axis=1)(nd.array(pred), nd.array(label),
                                          nd.array(sw)).asnumpy()
    assert got.shape == (6,)
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_split_and_load():
    data = nd.array(onp.arange(8).reshape(4, 2))
    parts = gluon.utils.split_and_load(data, [CPU])
    assert len(parts) == 1
    parts2 = gluon.utils.split_data(data, 2)
    assert parts2[0].shape == (2, 2)
    onp.testing.assert_array_equal(parts2[1].asnumpy(), [[4, 5], [6, 7]])
    with pytest.raises(MXNetError, match="evenly"):
        gluon.utils.split_data(data, 3)


def test_clip_global_norm():
    arrays = [nd.ones((2, 2)) * 3, nd.ones((3,)) * 4]
    norm = gluon.utils.clip_global_norm(arrays, 1.0)
    assert abs(norm - (9 * 4 + 16 * 3) ** 0.5) < 1e-5
    total = onp.sqrt(sum((a.asnumpy() ** 2).sum() for a in arrays))
    assert abs(total - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# the Gluon semantics the port keeps over PyTorch's
# ---------------------------------------------------------------------------
def test_one_tensor_per_parameter():
    net = nn.Dense(3, in_units=4)
    net.initialize()
    w = net.weight
    assert w.data().data is net._parameters["weight"]
    assert isinstance(w.data().data, torch.nn.Parameter)
    before = w.data().data
    w.set_data(nd.ones((3, 4)))
    w.data()[:] = 2.0
    assert w.data().data is before and (before == 2).all()
    step = parallel.ParallelTrainStep(
        net, lambda out, y: (out - y).square(), mt.optimizer.SGD(),
        parallel.make_mesh({"dp": 1}, ctx=CPU))
    assert step.params["weight"] is before


def test_grad_req_write_and_add():
    net = nn.Dense(2, in_units=3, use_bias=False)
    net.initialize(mt.init.One())
    x = nd.ones((1, 3))
    for _ in range(2):
        with autograd.record():
            y = net(x).sum()
        y.backward()
    onp.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                   onp.ones((2, 3)))       # write
    net.weight.grad_req = "add"
    net.weight.zero_grad()
    for _ in range(2):
        with autograd.record():
            y = net(x).sum()
        y.backward()
    onp.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                   2 * onp.ones((2, 3)))   # add
    net.weight.grad_req = "null"
    with pytest.raises(MXNetError, match="null"):
        net.weight.grad()


def test_graph_only_inside_record():
    net = nn.Dense(2, in_units=3)
    net.initialize()
    out = net(nd.ones((1, 3)))
    assert not out.data.requires_grad
    with pytest.raises(MXNetError, match="recorded"):
        out.backward()


def test_dropout_masks_only_while_training_from_the_context_generator():
    drop = nn.Dropout(0.5)
    x = nd.ones((64, 64))
    onp.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    masks = []
    for _ in range(2):
        mt.random.seed(5)
        state = torch.random.get_rng_state()
        with autograd.record():
            masks.append(drop(x).asnumpy())
        assert torch.equal(torch.random.get_rng_state(), state)
    onp.testing.assert_array_equal(masks[0], masks[1])
    assert 0.4 < (masks[0] == 0).mean() < 0.6
    with autograd.record(train_mode=False):
        onp.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())


def test_cast_reregisters_and_keeps_batchnorm_f32():
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3), nn.BatchNorm(in_channels=4))
    net.initialize()
    net.cast("bfloat16")
    dense, bn = net[0], net[1]
    assert dense.weight.data().dtype == "bfloat16"
    assert dense._parameters["weight"] is dense.weight.data().data
    assert dense.weight.grad().dtype == "bfloat16"
    assert bn.gamma.data().dtype == onp.float32
    assert bn._buffers["running_var"].dtype == torch.float32
    out = net(nd.ones((2, 3)).astype("bfloat16"))
    assert out.dtype == "bfloat16"


def test_parallel_train_step_refuses_uninitialized_block():
    with pytest.raises(MXNetError, match="not initialized"):
        parallel.ParallelTrainStep(
            nn.Dense(3, in_units=2), lambda o, y: o, mt.optimizer.SGD(),
            parallel.make_mesh({"dp": 1}, ctx=CPU))


def test_parallel_train_step_runs_a_gluon_block():
    """The rebased layers under ParallelTrainStep: one SGD step equals the
    same step taken by hand."""
    rng = onp.random.RandomState(9)
    x, y = rng.randn(8, 5).astype("f"), rng.randn(8, 3).astype("f")
    net = nn.HybridSequential()
    net.add(nn.Dense(6, activation="tanh", in_units=5),
            nn.Dense(3, in_units=6))
    net.initialize(mt.init.Xavier())
    w0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    step = parallel.ParallelTrainStep(
        net, lambda o, t: (o - t).square(), mt.optimizer.SGD(learning_rate=0.1),
        parallel.make_mesh({"dp": 1}, ctx=CPU))
    loss = step(x, y)
    ref = nn.HybridSequential()
    ref.add(nn.Dense(6, activation="tanh", in_units=5),
            nn.Dense(3, in_units=6))
    ref.load_state_dict(w0)
    params = dict(ref.named_parameters())
    out = ref(torch.from_numpy(x))
    want = (out - torch.from_numpy(y)).square().mean()
    grads = torch.autograd.grad(want, list(params.values()))
    assert torch.equal(loss, want.detach())
    for (k, p), g in zip(params.items(), grads):
        assert torch.equal(step.params[k], (p - 0.1 * g).detach()), k


def test_parallel_train_step_takes_a_gluon_loss_block():
    """A user's NDArray block (``hybrid_forward``) as the step's loss:
    called with tensors it records as torch's grad mode says, and the step
    equals the one with the same loss written on tensors, bitwise."""
    class L2(gluon.HybridBlock):
        def hybrid_forward(self, F, out, y):
            return ((out - y) * (out - y)).mean(axis=1)

    rng = onp.random.RandomState(10)
    x, y = rng.randn(6, 4).astype("f"), rng.randn(6, 2).astype("f")
    w0 = None
    got = []
    for loss in (L2(), lambda o, t: (o - t).square().mean(dim=1)):
        net = nn.Dense(2, in_units=4)
        net.initialize(mt.init.Xavier())
        if w0 is None:
            w0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
        net.load_state_dict(w0)
        step = parallel.ParallelTrainStep(
            net, loss, mt.optimizer.Adam(learning_rate=0.1),
            parallel.make_mesh({"dp": 1}, ctx=CPU))
        got.append(([step(x, y) for _ in range(2)], dict(step.params)))
    (la, pa), (lb, pb) = got
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["weight"], w0["weight"])


# ---------------------------------------------------------------------------
# .params files
# ---------------------------------------------------------------------------
def _mixed_arrays():
    rng = onp.random.RandomState(4)
    return {"w": rng.randn(3, 4).astype("f"),
            "b16": (rng.randn(5) * 3).astype("f"),
            "i": rng.randint(-9, 9, (2, 3)).astype(onp.int32)}


def test_params_file_bytes_equal_jax(tmp_path):
    arrays = _mixed_arrays()
    jax_path, port_path = tmp_path / "jax.params", tmp_path / "port.params"
    mx.nd.save(str(jax_path), {
        k: mx.nd.array(v).astype("bfloat16") if k == "b16" else
        mx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()})
    nd.save(str(port_path), {
        k: nd.array(v).astype("bfloat16") if k == "b16" else
        nd.array(v, dtype=v.dtype) for k, v in arrays.items()})
    assert port_path.read_bytes() == jax_path.read_bytes()
    got = nd.load(str(jax_path))
    assert got["b16"].dtype == "bfloat16" and got["i"].dtype == onp.int32
    onp.testing.assert_array_equal(got["w"].asnumpy(), arrays["w"])
    lst = tmp_path / "list.params"
    nd.save(str(lst), [nd.array(arrays["w"]), nd.array(arrays["i"])])
    back = mx.nd.load(str(lst))
    assert isinstance(back, list) and len(back) == 2
    onp.testing.assert_array_equal(back[1].asnumpy(), arrays["i"])


def _jax_lenet():
    net = jax_nn.HybridSequential()
    net.add(jax_nn.Conv2D(6, 5, padding=2, activation="relu"),
            jax_nn.MaxPool2D(2), jax_nn.Flatten(), jax_nn.Dense(10))
    return net


def _port_lenet():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(6, 5, padding=2, activation="relu"), nn.MaxPool2D(2),
            nn.Flatten(), nn.Dense(10))
    return net


def test_save_parameters_cross_both_packages(tmp_path):
    x = onp.random.RandomState(2).rand(2, 1, 28, 28).astype("f")
    jnet = _jax_lenet()
    jnet.initialize(mx.init.Xavier())
    want = jnet(mx.nd.array(x)).asnumpy()
    jax_file = str(tmp_path / "jax.params")
    jnet.save_parameters(jax_file)
    tnet = _port_lenet()
    tnet.load_parameters(jax_file)
    onp.testing.assert_allclose(tnet(nd.array(x)).asnumpy(), want,
                                rtol=1e-5, atol=1e-6)
    tnet2 = _port_lenet()
    tnet2.initialize(mt.init.Xavier())
    tnet2(nd.array(x))
    port_file = str(tmp_path / "port.params")
    tnet2.save_parameters(port_file)
    jnet2 = _jax_lenet()
    jnet2.load_parameters(port_file)
    onp.testing.assert_allclose(jnet2(mx.nd.array(x)).asnumpy(),
                                tnet2(nd.array(x)).asnumpy(), rtol=1e-5,
                                atol=1e-6)


# ---------------------------------------------------------------------------
# the LeNet drive (SKILL.md) in both packages
# ---------------------------------------------------------------------------
def _lenet_pair():
    rng = onp.random.RandomState(8)
    x = rng.randn(8, 1, 28, 28).astype("f")
    y = onp.asarray([0, 1] * 4, "f")
    jnet = _jax_lenet()
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.array(x))
    tnet = _port_lenet()
    tnet.initialize(mt.init.Xavier())
    for k, p in tnet._collect_params_with_prefix().items():
        p.set_data(nd.array(jnet._collect_params_with_prefix()[k].data()
                            .asnumpy()))
    return jnet, tnet, x, y


def test_lenet_drive_matches_jax():
    jnet, tnet, x, y = _lenet_pair()
    runs = []
    for pkg, glu, ag, net in ((mx, jax_gluon, jax_autograd, jnet),
                              (mt, gluon, autograd, tnet)):
        trainer = glu.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="device")
        loss_fn = glu.loss.SoftmaxCrossEntropyLoss()
        xs, ys = pkg.nd.array(x), pkg.nd.array(y)
        losses = []
        for i in range(6):
            if i == 3:
                net.hybridize()
            with ag.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(8)
            losses.append(loss.asnumpy())
        runs.append((losses, {k: p.data().asnumpy() for k, p in
                              net._collect_params_with_prefix().items()}))
    (jl, jp), (tl, tp) = runs
    for a, b in zip(tl, jl):
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert set(tp) == set(jp)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-6,
                                    err_msg=k)
    assert tl[-1].mean() < tl[0].mean()


# ---------------------------------------------------------------------------
# the small BERT through the Trainer
# ---------------------------------------------------------------------------
SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
             vocab_size=100, max_length=32, dropout=0.0)
B, S, P = 4, 16, 3
LR = 1e-2


def _bert_batch():
    rng = onp.random.RandomState(11)
    toks = rng.randint(0, 100, (3, B, S)).astype("int32")
    tt = rng.randint(0, 2, (3, B, S)).astype("int32")
    pos = onp.sort(rng.rand(3, B, S).argsort(-1)[..., :P], -1) \
        .astype("int32")
    mlm = rng.randint(0, 100, (3, B, P)).astype("int32")
    nsp = rng.randint(0, 2, (3, B)).astype("int32")
    return toks, tt, pos, mlm, nsp


def test_small_bert_trainer_matches_jax():
    jm = jax_bert.BERTForPretraining(jax_bert.BERTModel(**SMALL), 100)
    jm.initialize()
    tok = mx.nd.array(onp.zeros((1, 8), "int32"), dtype="int32")
    jm(tok, tok)
    rng = onp.random.RandomState(0)
    named = {}
    for k, p in jm._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype("f")
        named[k] = a + 1.0 if k.endswith("gamma") else a
        p.set_data(mx.nd.array(named[k]))
    tm = bert.BERTForPretraining(bert.BERTModel(**SMALL), 100)
    bert.load_jax_params(tm, named, ctx=CPU)
    toks, tt, pos, mlm, nsp = _bert_batch()
    runs = []
    for pkg, glu, ag, net, loss_fn in (
            (mx, jax_gluon, jax_autograd, jm, jax_bert.BERTPretrainingLoss()),
            (mt, gluon, autograd, tm, bert.BERTPretrainingLoss())):
        trainer = glu.Trainer(net.collect_params(), "adam",
                              {"learning_rate": LR}, kvstore="device")
        losses = []
        for i in range(3):
            a = [pkg.nd.array(v[i], dtype="int32")
                 for v in (toks, tt, pos, mlm, nsp)]
            with ag.record():
                out = net(a[0], a[1], None, a[2])
                loss = loss_fn(*out, a[3], a[4])
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asscalar()))
        runs.append((losses, {k: p.data().asnumpy() for k, p in
                              net._collect_params_with_prefix().items()}))
    (jl, jp), (tl, tp) = runs
    onp.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(tp) == set(jp)
    for k in jp:
        onp.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=0.05 * LR,
                                    err_msg=k)
    assert any(not onp.allclose(tp[k], named[k]) for k in named)


# ---------------------------------------------------------------------------
# the model zoo's names
# ---------------------------------------------------------------------------
def test_zoo_structural_names_equal_jax():
    jm = jax_bert.BERTForPretraining(jax_bert.BERTModel(**SMALL), 100)
    tm = bert.BERTForPretraining(bert.BERTModel(**SMALL), 100)
    assert list(tm._collect_params_with_prefix()) == \
        list(jm._collect_params_with_prefix())
    jl = jax_bert.TransformerLM(num_layers=2, units=32, hidden_size=64,
                                num_heads=2, vocab_size=50, max_length=16)
    tl = bert.TransformerLM(num_layers=2, units=32, hidden_size=64,
                            num_heads=2, vocab_size=50, max_length=16)
    assert list(tl._collect_params_with_prefix()) == \
        list(jl._collect_params_with_prefix())
    jr = jax_vision.get_model("resnet18_v1", classes=10)
    tr = vision.get_model("resnet18_v1", classes=10)
    assert list(tr._collect_params_with_prefix()) == \
        list(jr._collect_params_with_prefix())


def test_zoo_collect_params_equal_jax_under_one_prefix():
    jm = jax_bert.BERTForPretraining(jax_bert.BERTModel(**SMALL, prefix="b_"),
                                     100, prefix="p_")
    tm = bert.BERTForPretraining(bert.BERTModel(**SMALL, prefix="b_"), 100,
                                 prefix="p_")
    assert list(tm.collect_params()) == list(jm.collect_params())
    jr = jax_vision.get_model("resnet50_v1", classes=10, prefix="r_")
    tr = vision.get_model("resnet50_v1", classes=10, prefix="r_")
    assert list(tr.collect_params()) == list(jr.collect_params())
    assert len(tr.collect_params()) == 299
    n = len("r_")
    assert tr.jax_names() == {k: p.name[n:] for k, p in
                              tr._collect_params_with_prefix().items()}
