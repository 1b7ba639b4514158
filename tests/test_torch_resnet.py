"""The port's ResNet-50 training slice (convolution, pooling, BatchNorm,
SoftmaxCrossEntropyLoss, SGD, ResNetV1 and ParallelTrainStep with
BatchNorm's moving-stat write-back) against the JAX package on the CPU, at a
small size, and the weight carrier on resnet50_v1's names.

Weights, running stats and batches are made with numpy from a seed and
handed to both packages. Tolerances (measured values from this CPU):

- ops in f32: 1e-5 absolute on O(1) values (sum order only); bf16
  BatchNorm one bf16 ulp of max |out| (2^-7), since both sides round the
  same f32 values computed in another order.
- the small bottleneck net's f32 forward: 1e-4 relative to max |out|
  (sum order through 13 layers; measured 1.9e-6); bf16 forward: 3e-2
  relative to max |out| (bf16 activations; measured 3.9e-3).
- 3 SGD-momentum steps in f32: losses 1e-5 relative (measured 1.5e-7);
  parameters within 1e-4 lr (a step moves a weight by lr times its
  gradient, so the gradients' sum-order error times lr; measured
  7.2e-6 lr); running stats within 1e-5 relative to max |stat| (measured
  4.4e-7).
- bf16 compute over f32 masters: losses 1e-2 relative (the loss is
  rounded to bf16 on both sides, and one ulp at 3.2 is 5e-3 of it;
  measured 6.0e-3); parameters within 2 lr at most and 0.05 lr on average
  (bf16 activations and gradients are rounded by different convolution
  and reduction kernels, and a gradient error moves a weight by lr times
  it, three times over with momentum; measured 0.68 and 0.013 lr); running
  stats within 5e-2 relative to max |stat| (moments of bf16 activations of
  weights that differ as above; measured 2.6e-2).
"""
import numpy as onp
import pytest
import torch
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu.ops import nn as jax_ops
from mxnet_tpu.ops import tensor as jax_ops_tensor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, optimizer, parallel
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import carrier, vision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
from mxnet_tpu_torch.gluon.nn import BatchNorm, Flatten
from mxnet_tpu_torch.ops import nn as ops

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

LAYERS, CHANNELS, CLASSES = [1, 1, 1, 1], [16, 32, 64, 128, 256], 10
B, K = 4, 3
LR, MOMENTUM, WD = 0.05, 0.9, 1e-4


def _t(a, dtype=torch.float32):
    return torch.from_numpy(onp.asarray(a, onp.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(onp.asarray(a, onp.float32)).astype(dtype)


def _close(got, want, atol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    onp.testing.assert_allclose(onp.asarray(got, onp.float32),
                                onp.asarray(want, onp.float32), rtol=0,
                                atol=atol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride,pad,bias", [(1, 1, True), (2, 1, False),
                                             (2, 3, True), (1, 0, True)])
def test_convolution_matches_jax(stride, pad, bias):
    rng = onp.random.RandomState(0)
    k = 2 * pad + 1
    x = rng.randn(2, 5, 11, 9)
    w = rng.randn(6, 5, k, k) / onp.sqrt(5 * k * k)
    b = rng.randn(6) if bias else None
    want = jax_ops.convolution(_j(x), _j(w), None if b is None else _j(b),
                               kernel=(k, k), stride=stride, pad=pad,
                               num_filter=6)
    got = ops.convolution(_t(x), _t(w), None if b is None else _t(b),
                          stride=stride, pad=pad)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_convolution_bf16_in_bf16_out():
    x = torch.randn(1, 4, 6, 6, dtype=torch.bfloat16)
    w = torch.randn(8, 4, 1, 1, dtype=torch.bfloat16)
    assert ops.convolution(x, w).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["max_3_2_1", "max_2", "max_3_2_1_bf16",
                                  "global_avg"])
def test_pooling_matches_jax(kind):
    x = onp.random.RandomState(1).randn(2, 3, 13, 10)
    kw = {"max_3_2_1": dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                            pad=(1, 1)),
          "max_2": dict(kernel=(2, 2), pool_type="max"),
          "max_3_2_1_bf16": dict(kernel=(3, 3), pool_type="max",
                                 stride=(2, 2), pad=(1, 1)),
          "global_avg": dict(pool_type="avg", global_pool=True)}[kind]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if kind.endswith("bf16") \
        else (jnp.float32, torch.float32)
    want = jax_ops.pooling(_j(x, jdt), **kw)
    got = ops.pooling(_t(x, tdt), **kw)
    assert got.shape == want.shape and got.dtype == tdt
    _close(got, onp.asarray(want, onp.float32), 1e-6)


@pytest.mark.parametrize("kind", ["avg_3_2_1", "global_max", "sum"])
def test_pooling_refuses_what_is_not_ported(kind):
    kw = {"avg_3_2_1": dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                            pad=(1, 1)),
          "global_max": dict(pool_type="max", global_pool=True),
          "sum": dict(kernel=(2, 2), pool_type="sum")}[kind]
    with pytest.raises(MXNetError, match="not ported"):
        ops.pooling(torch.zeros(1, 1, 4, 4), **kw)


def test_flatten_matches_jax():
    x = onp.random.RandomState(8).randn(3, 4, 2, 5)
    _close(Flatten()(_t(x)), jax_ops_tensor.flatten(_j(x)), 0)


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_activation_matches_jax(act):
    x = onp.random.RandomState(2).randn(3, 7) * 3
    _close(ops.activation(_t(x), act_type=act),
           jax_ops.activation(_j(x), act_type=act), 1e-6)


@pytest.mark.parametrize("act", ["sigmoid", "softrelu"])
def test_activation_refuses_what_is_not_ported(act):
    with pytest.raises(MXNetError, match="not ported"):
        ops.activation(torch.zeros(2), act_type=act)


# the three forms of the reference's BatchNorm: (input dtype, env)
BN_FORMS = {"bf16_reduce": ("bfloat16", {}),
            "onepass_f32": ("float32", {"MXNET_BN_ONEPASS": "1"}),
            "twopass_f32": ("float32", {})}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("fix_gamma", [False, True], ids=["gamma", "fixed"])
@pytest.mark.parametrize("form", sorted(BN_FORMS))
def test_batch_norm_matches_jax(form, fix_gamma, training, monkeypatch):
    dtype, env = BN_FORMS[form]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = onp.random.RandomState(3)
    x = 2.0 + 3.0 * rng.randn(4, 6, 5, 3)
    gamma, beta = 1 + 0.1 * rng.randn(6), 0.1 * rng.randn(6)
    mm, mv = 0.1 * rng.randn(6), 1 + 0.2 * rng.rand(6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_ops.batch_norm(_j(x, jdt), _j(gamma), _j(beta), _j(mm),
                              _j(mv), fix_gamma=fix_gamma, training=training,
                              momentum=0.9, eps=1e-5)
    got = ops.batch_norm(_t(x, tdt), _t(gamma), _t(beta), _t(mm), _t(mv),
                         fix_gamma=fix_gamma, training=training,
                         momentum=0.9, eps=1e-5)
    assert got[0].dtype == tdt
    ref_out = onp.asarray(want[0], onp.float32)
    tol = 2.0 ** -7 * onp.abs(ref_out).max() if tdt == torch.bfloat16 \
        else 1e-5
    _close(got[0], ref_out, tol)
    for g, w in zip(got[1:], want[1:]):          # moving stats, f32
        assert g.dtype == torch.float32
        _close(g, w, 1e-5 * max(1.0, float(onp.abs(w).max())))
    if not training:
        _close(got[1], mm, 0)


def test_batch_norm_layer_writes_back_moving_stats_in_f32():
    bn = BatchNorm(in_channels=3)
    x = torch.randn(8, 3, 4, 4) * 2 + 1
    mean0 = bn.running_mean
    bn.train()
    bn(x.to(torch.bfloat16))
    assert bn.running_mean is mean0 and mean0.dtype == torch.float32
    want = 0.1 * x.mean(dim=(0, 2, 3))
    _close(bn.running_mean, want, 2e-2)
    bn.eval()
    before = bn.running_var.clone()
    bn(x)
    assert torch.equal(bn.running_var, before)     # eval: no write-back
    net = torch.nn.Sequential(bn).to(torch.bfloat16)   # a half cast
    assert all(t.dtype == torch.float32 for t in
               list(bn.parameters()) + list(bn.buffers()))
    assert net[0] is bn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_jax(dtype):
    rng = onp.random.RandomState(4)
    pred = 3 * rng.randn(5, 11)
    label = rng.randint(0, 11, (5,)).astype(onp.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jax_loss.SoftmaxCrossEntropyLoss()(mx.nd.array(_j(pred, jdt)),
                                              mx.nd.array(label))
    got = port_loss.SoftmaxCrossEntropyLoss()(_t(pred, tdt),
                                              torch.from_numpy(label))
    assert got.shape == (5,) and got.dtype == tdt
    _close(got, want.asnumpy(), 1e-5 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# the small bottleneck ResNet against the JAX package
# ---------------------------------------------------------------------------
def _jax_net():
    net = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, LAYERS, CHANNELS,
                              classes=CLASSES, thumbnail=True)
    net.initialize()
    net(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))   # shapes
    return net


def _port_net():
    return resnet.ResNetV1(resnet.BottleneckV1, LAYERS, CHANNELS,
                           classes=CLASSES, thumbnail=True)


@pytest.fixture(scope="module")
def named():
    """Seeded weights and running stats under the JAX package's
    ``_collect_params_with_prefix()`` names (the port's state-dict keys)."""
    rng = onp.random.RandomState(5)
    out = {}
    for name, p in _jax_net()._collect_params_with_prefix().items():
        a = rng.randn(*p.shape)
        if name.endswith("weight"):
            a = a / onp.sqrt(onp.prod(p.shape[1:]))
        elif name.endswith("gamma"):
            a = 1 + 0.1 * a
        elif name.endswith("running_var"):
            a = 1 + 0.2 * onp.abs(a)
        else:
            a = 0.1 * a
        out[name] = a.astype(onp.float32)
    return out


@pytest.fixture(scope="module")
def batches():
    rng = onp.random.RandomState(6)
    xs = rng.rand(K, B, 3, 32, 32).astype(onp.float32)
    ys = rng.randint(0, CLASSES, (K, B)).astype(onp.float32)
    return xs, ys


def _jax_model(named, dtype=None):
    net = _jax_net()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(named[k]))
    if dtype is not None:
        net.cast(dtype)
    return net


def _port_model(named, dtype=None):
    net = _port_net()
    carrier.load_jax_params(net, named)
    return net if dtype is None else net.to(dtype)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_small_resnet_forward_matches_jax_f32(named, batches, training):
    x = batches[0][0]
    jnet = _jax_model(named)
    if training:
        with mx.autograd.train_mode():
            want = jnet(mx.nd.array(x)).asnumpy()
    else:
        want = jnet(mx.nd.array(x)).asnumpy()
    tnet = _port_model(named).train(training)
    with torch.no_grad():
        got = tnet(_t(x))
    assert tuple(got.shape) == (B, CLASSES)
    _close(got, want, 1e-4 * max(1.0, onp.abs(want).max()))


def test_small_resnet_forward_matches_jax_bf16(named, batches):
    x = batches[0][0]
    want = _jax_model(named, "bfloat16")(
        mx.nd.array(_j(x, jnp.bfloat16))).asnumpy()
    tnet = _port_model(named, torch.bfloat16).eval()
    with torch.no_grad():
        got = tnet(_t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, 3e-2 * max(1.0, onp.abs(
        onp.asarray(want, onp.float32)).max()))


def _jax_train(named, batches, compute_dtype=None):
    import jax
    xs, ys = batches
    net = _jax_model(named)
    mesh = jax_parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jax_parallel.ParallelTrainStep(
        net, jax_loss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.SGD(learning_rate=LR, momentum=MOMENTUM, wd=WD), mesh,
        compute_dtype=compute_dtype)
    losses = [float(step(xs[i], ys[i]).asscalar()) for i in range(K)]
    step.sync_to_block()
    return onp.asarray(losses), {
        k: p.data().asnumpy() for k, p in
        net._collect_params_with_prefix().items()}


def _port_train(named, batches, compute_dtype=None, use_step_n=False):
    xs, ys = batches
    net = _port_net()
    carrier.load_jax_params(net, named)
    step = parallel.ParallelTrainStep(
        net, port_loss.SoftmaxCrossEntropyLoss(),
        optimizer.SGD(learning_rate=LR, momentum=MOMENTUM, wd=WD),
        parallel.make_mesh({"dp": 1}, ctx=mt.cpu()),
        compute_dtype=compute_dtype)
    buffers = step.buffers
    if use_step_n:
        losses = step.step_n(xs, ys)
    else:
        losses = torch.stack([step(xs[i], ys[i]) for i in range(K)])
    after = step.buffers
    assert all(after[k] is v and v.dtype == torch.float32
               for k, v in buffers.items())      # neither cast nor replaced
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return losses, state


@pytest.fixture(scope="module")
def jax_f32(named, batches):
    return _jax_train(named, batches)


@pytest.fixture(scope="module")
def port_f32(named, batches):
    return _port_train(named, batches)


def _split(named):
    stats = sorted(k for k in named if ".running_" in k)
    return sorted(set(named) - set(stats)), stats


def test_small_resnet_sgd_steps_match_jax_f32(named, jax_f32, port_f32):
    j_losses, j_state = jax_f32
    t_losses, t_state = port_f32
    assert t_losses.dtype == torch.float32 and t_losses.shape == (K,)
    onp.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=1e-5)
    assert set(t_state) == set(j_state) == set(named)
    params, stats = _split(named)
    for k in params:
        assert t_state[k].dtype == torch.float32, k
        _close(t_state[k], j_state[k], 1e-4 * LR)
    for k in stats:
        assert t_state[k].dtype == torch.float32, k
        _close(t_state[k], j_state[k],
               1e-5 * max(1.0, onp.abs(j_state[k]).max()))
    # every parameter and running stat moved
    assert all(not onp.array_equal(j_state[k], named[k]) for k in named)


def test_small_resnet_sgd_steps_bf16_within_band(named, batches):
    j_losses, j_state = _jax_train(named, batches, compute_dtype="bfloat16")
    t_losses, t_state = _port_train(named, batches,
                                    compute_dtype="bfloat16")
    onp.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=1e-2)
    params, stats = _split(named)
    diff = onp.concatenate([onp.abs(t_state[k].numpy() - j_state[k]).ravel()
                            for k in params])
    assert diff.max() <= 2 * LR and diff.mean() <= 0.05 * LR, \
        (diff.max() / LR, diff.mean() / LR)
    for k in stats:
        assert t_state[k].dtype == torch.float32, k
        _close(t_state[k], j_state[k],
               5e-2 * max(1.0, onp.abs(j_state[k]).max()))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_port_step_n_equals_steps(named, batches, compute_dtype):
    a_losses, a_state = _port_train(named, batches, compute_dtype)
    b_losses, b_state = _port_train(named, batches, compute_dtype,
                                    use_step_n=True)
    assert torch.equal(a_losses, b_losses)
    for k in a_state:                         # running stats included
        assert torch.equal(a_state[k], b_state[k]), k


# ---------------------------------------------------------------------------
# the weight carrier on resnet50_v1's names
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def r50_names():
    """resnet50_v1's ``collect_params()`` names with each one's
    ``_collect_params_with_prefix()`` name and shape."""
    net = jax_vision.get_model("resnet50_v1", classes=1000)
    net.initialize()
    net(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))
    by_id = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    return {c: (by_id[id(p)], tuple(p.shape))
            for c, p in net.collect_params().items()}


def test_resnet50_names_map_one_to_one(r50_names):
    net = vision.get_model("resnet50_v1", classes=1000)
    assert len(r50_names) == 299 == len(net.state_dict())
    pre = next(iter(r50_names)).split("_")[0] + "_"
    got = {pre + v: k for k, v in net.jax_names().items()}
    assert got == {c: key for c, (key, _) in r50_names.items()}
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == {key: s for key, s in r50_names.values()}


def _seeded(r50_names):
    rng = onp.random.RandomState(7)
    return {c: rng.randn(*s).astype(onp.float32)
            for c, (_, s) in r50_names.items()}


def test_weight_carrier_takes_resnet50_collect_params(r50_names):
    named = _seeded(r50_names)
    sd = carrier.params_from_jax(named)
    assert len(sd) == 299
    for c, (key, _) in r50_names.items():
        assert torch.equal(sd[key], torch.from_numpy(named[c])), c
    net = resnet.resnet50_v1(classes=1000)
    carrier.load_jax_params(net, named)
    state = net.state_dict()
    for c, (key, _) in r50_names.items():            # running stats too
        assert torch.equal(state[key], torch.from_numpy(named[c])), c


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_weight_carrier_refuses_resnet_mismatch(r50_names, fault):
    bad = _seeded(r50_names)
    pre = next(iter(bad)).split("_")[0] + "_"
    if fault == "missing":
        del bad[pre + "stage3_batchnorm4_running_var"]
    elif fault == "extra":
        bad[pre + "stage3_conv2d99_bias"] = onp.zeros(4, onp.float32)
    else:
        bad[pre + "dense0_bias"] = onp.zeros(999, onp.float32)
    with pytest.raises(MXNetError, match=fault):
        carrier.params_from_jax(bad)
    net = resnet.resnet50_v1(classes=1000)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.raises(MXNetError):
        carrier.load_jax_params(net, bad)
    for k, v in net.state_dict().items():           # nothing was copied
        assert torch.equal(v, before[k]), k


def test_get_model_names():
    assert isinstance(vision.get_model("resnet50_v1"), resnet.ResNetV1)
    with pytest.raises(MXNetError, match="not ported"):
        vision.get_model("resnet50_v2")
