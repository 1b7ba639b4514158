"""The SSD slice of the port (``mxnet_tpu_torch/gluon/model_zoo/vision/
ssd.py``, ``mxnet_tpu_torch/test_utils.py``) against the JAX package on
the CPU: ``ssd_96_tiny`` from the reference's weights through
``ssd.state_from_jax`` (the forward: anchors bitwise, predictions within
1e-5; ``SSDMultiBoxLoss``: the matching and the mined negatives bitwise,
the loss within 1e-6; three SGD-momentum Trainer steps: losses and
weights within 1e-5 of max(1, |w|); ``detect()`` rows within 1e-5, on
inputs for which NMS is well posed), ``ssd_300_vgg16``'s shapes and its
8732 anchors against the reference's ``MultiBoxPrior``, ``MApMetric``,
``get_shapes_detection``, and the training step the card drives
(``ParallelTrainStep``) against the Trainer. The reference's accuracy
drive (251 Adam steps to a VOC07 mAP of 0.6) is opt-in here, as in
tests/test_ssd.py (``MXNET_TEST_DETECTION=1``); phase 10 of chip_smoke.py
runs it on the card.
"""
import os

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.gluon.model_zoo.vision import ssd as jax_ssd
from mxnet_tpu.ops import contrib as jax_contrib
from mxnet_tpu.test_utils import get_shapes_detection as jax_shapes

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, autograd, gluon, optimizer, parallel
from mxnet_tpu_torch.gluon.model_zoo import carrier
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import ssd
from mxnet_tpu_torch.ops import contrib
from mxnet_tpu_torch.test_utils import get_shapes_detection
from mxnet_tpu_torch.tools import op_cases

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()
B = 4
TOL = 1e-5


def _xavier(rng, shape):
    if len(shape) < 2:
        return rng.uniform(-0.05, 0.05, shape)
    fan_in = onp.prod(shape[1:])
    fan_out = shape[0] * onp.prod(shape[2:])
    a = onp.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-a, a, shape)


@pytest.fixture(scope="module")
def data():
    imgs, labels = get_shapes_detection(B, size=96, seed=5)
    return imgs, labels


@pytest.fixture(scope="module")
def reference(data):
    """The reference's ssd_96_tiny with seeded Xavier-uniform weights
    (biases uniform in +-0.05), and its parameters by collect_params()
    name."""
    net = jax_ssd.ssd_96_tiny(classes=3)
    net.initialize()
    net(mx.nd.array(data[0][:1]))                 # the deferred shapes
    rng = onp.random.RandomState(3)
    named = {}
    for name, p in net.collect_params().items():
        named[name] = _xavier(rng, p.shape).astype(onp.float32)
        p.set_data(mx.nd.array(named[name]))
    return net, named


def _port(named):
    net = ssd.ssd_96_tiny(classes=3)
    carrier.load_jax_params(net, ssd.state_from_jax(named), ctx=CPU)
    return net


def _close(got, want, tol=TOL, what=""):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(onp.abs(want).max()))
    err = float(onp.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} > {tol}"


# ---------------------------------------------------------------------------
# data and metric
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,size,seed", [(6, 96, 0), (2, 300, 3)])
def test_get_shapes_detection_equals_the_reference(n, size, seed):
    want = jax_shapes(n, size=size, seed=seed)
    got = get_shapes_detection(n, size=size, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        onp.testing.assert_array_equal(g, w)


def test_map_metric_perfect_and_miss_as_the_reference():
    labels = onp.array([[[0, 0.1, 0.1, 0.4, 0.4],
                         [1, 0.5, 0.5, 0.9, 0.9]]], "float32")
    perfect = onp.array([[[0, 0.9, 0.1, 0.1, 0.4, 0.4],
                          [1, 0.8, 0.5, 0.5, 0.9, 0.9]]], "float32")
    miss = onp.array([[[0, 0.9, 0.6, 0.6, 0.8, 0.8],
                       [1, 0.8, 0.5, 0.5, 0.9, 0.9]]], "float32")
    r = onp.random.RandomState(4)
    rand = onp.concatenate([r.randint(-1, 2, (2, 20, 1)), r.rand(2, 20, 1),
                            onp.sort(r.rand(2, 20, 4), -1)[..., [0, 1, 2, 3]]],
                           -1).astype("float32")
    rand_labels = onp.concatenate([r.randint(-1, 2, (2, 4, 1)),
                                   onp.sort(r.rand(2, 4, 4), -1)], -1) \
        .astype("float32")
    for det, lab in ((perfect, labels), (miss, labels), (rand, rand_labels)):
        m, jm = ssd.MApMetric(ovp_thresh=0.5), jax_ssd.MApMetric(0.5)
        m.update(det, lab)
        jm.update(det, lab)
        assert m.get() == jm.get()
    m = ssd.MApMetric()
    m.update(perfect, labels)
    assert m.get() == ("mAP", pytest.approx(1.0, abs=1e-6))
    m.reset()
    m.update(torch.from_numpy(miss), labels)
    assert 0.0 < m.get()[1] < 1.0


# ---------------------------------------------------------------------------
# ssd_96_tiny against the reference
# ---------------------------------------------------------------------------
def test_tiny_forward_matches_the_reference(reference, data):
    jnet, named = reference
    net = _port(named)
    x = data[0]
    ja, jc, jl = (a.asnumpy() for a in jnet(mx.nd.array(x)))
    with CPU:
        ta, tc, tl = (a.asnumpy() for a in net(mt.nd.array(x)))
    assert ta.shape == (1, 760, 4) and tc.shape == (B, 4, 760)
    onp.testing.assert_array_equal(ta, ja)
    _close(tc, jc, what="cls_preds")
    _close(tl, jl, what="loc_preds")


def test_tiny_loss_matches_the_reference(reference, data):
    """The anchors' matching (MultiBoxTarget) and the hard negatives the
    double stable argsort mines are bitwise the reference's; the loss is
    within 1e-6 (sums in another order)."""
    jnet, named = reference
    net = _port(named)
    x, y = data
    ja, jc, jl = jnet(mx.nd.array(x))
    jloss = jax_ssd.SSDMultiBoxLoss()(ja, jc, jl, mx.nd.array(y)).asnumpy()
    with CPU:
        ta, tc, tl = net(mt.nd.array(x))
        tloss = ssd.SSDMultiBoxLoss()(ta, tc, tl, mt.nd.array(y)).asnumpy()
    _close(tloss, jloss, 1e-6, "loss")
    want = [onp.asarray(a) for a in jax_contrib.multibox_target(
        jnp.asarray(ja.asnumpy()), jnp.asarray(y), jnp.asarray(jc.asnumpy()))]
    got = [a.numpy() for a in contrib.multibox_target(
        ta.data, torch.from_numpy(y), tc.data)]
    onp.testing.assert_array_equal(got[1], want[1])       # box masks
    onp.testing.assert_array_equal(got[2], want[2])       # classes
    assert (got[2] > 0).sum() > 0

    # the mined negatives, each package's ops on its own predictions
    jm = _mined(mx.nd, jc, mx.nd.array(want[2]))
    with CPU:
        tm = _mined(mt.nd, tc, mt.nd.array(got[2]))
    onp.testing.assert_array_equal(tm, jm)
    assert 0 < jm.sum() < jm.size


def _mined(nd, cls_preds, cls_t, ratio=3.0):
    """SSDMultiBoxLoss's hard negatives (rank < 3 positives + 1) as 0/1."""
    ce = -nd.pick(nd.log_softmax(cls_preds, axis=1), cls_t, axis=1)
    pos = cls_t > 0
    neg = nd.where(pos, nd.zeros_like(ce), ce)
    rank = nd.argsort(nd.argsort(neg, axis=1, is_ascend=False), axis=1,
                      is_ascend=True)
    n_neg = nd.sum(pos, axis=1) * ratio + 1
    return (rank < n_neg.reshape((-1, 1))).asnumpy() * (1 - pos.asnumpy())


def _trainer_steps(pkg, glu, ag, net, x, y, steps=3):
    trainer = glu.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 1e-3, "momentum": 0.9})
    loss_fn = (jax_ssd if pkg is mx else ssd).SSDMultiBoxLoss()
    losses = []
    for _ in range(steps):
        with ag.record():
            a, c, l_ = net(pkg.nd.array(x))
            loss = loss_fn(a, c, l_, pkg.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.asnumpy())
    return onp.stack(losses)


@pytest.fixture(scope="module")
def trained(reference, data):
    """Three SGD-momentum steps (lr 1e-3, tests/test_ssd.py's) through
    each package's Trainer from the same weights and batch."""
    jnet, named = reference
    net = _port(named)
    x, y = data
    jl = _trainer_steps(mx, mx.gluon, mx.autograd, jnet, x, y)
    with CPU:
        tl = _trainer_steps(mt, gluon, autograd, net, x, y)
    return jnet, net, jl, tl


def test_tiny_trainer_steps_match_the_reference(trained):
    jnet, net, jl, tl = trained
    _close(tl, jl, what="losses")
    assert tl[-1].mean() < tl[0].mean()
    jp = {k: p.data().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    tp = {k: p.data().asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    assert set(tp) == set(jp)
    for k in jp:
        _close(tp[k], jp[k], what=k)


def test_tiny_detect_matches_the_reference(trained, data):
    """detect() after the three steps: the rows within 1e-5. Well posed:
    no candidate's score within 1e-6 of the threshold or of another
    candidate's, no same-class candidate pair's IoU within 1e-4 of the NMS
    threshold."""
    jnet, net, _, _ = trained
    x = data[0]
    kw = dict(threshold=0.2, nms_threshold=0.45, nms_topk=24)
    ja, jc, jl = (a.asnumpy() for a in jnet(mx.nd.array(x)))
    assert not op_cases.detection_problems(jc, jl, ja, kw["threshold"],
                                           kw["nms_threshold"],
                                           kw["nms_topk"])
    want = jnet.detect(mx.nd.array(x), **kw).asnumpy()
    with CPU:
        got = net.detect(mt.nd.array(x), **kw).asnumpy()
    assert got.shape == want.shape == (B, 760, 6)
    onp.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got, want, what="detect rows")
    assert (got[..., 0] >= 0).sum() > 0
    with torch.no_grad():
        tensor_rows = net.detect(torch.from_numpy(x), **kw)
    onp.testing.assert_array_equal(tensor_rows.numpy(), got)


# ---------------------------------------------------------------------------
# ssd_300_vgg16
# ---------------------------------------------------------------------------
def test_ssd300_shapes_and_anchors():
    """8732 anchors at 300 x 300, bitwise the reference's MultiBoxPrior
    (op by op) on the six feature maps (38, 19, 10, 5, 3, 1)."""
    net = vision.get_model("ssd_300_vgg16", classes=20)
    net.initialize(mt.init.Xavier(), ctx=CPU)
    x = onp.random.RandomState(0).rand(1, 3, 300, 300).astype("float32")
    with CPU:
        anchors, cls_preds, loc_preds = net(mt.nd.array(x))
    assert anchors.shape == (1, 8732, 4)
    assert cls_preds.shape == (1, 21, 8732)
    assert loc_preds.shape == (1, 8732 * 4)
    want = onp.concatenate([onp.asarray(jax_contrib.multibox_prior(
        jnp.zeros((1, 1, s, s)), sizes=sz, ratios=r))
        for s, sz, r in zip((38, 19, 10, 5, 3, 1), ssd._SIZES, ssd._RATIOS)],
        axis=1)
    onp.testing.assert_array_equal(anchors.asnumpy(), want)
    assert onp.isfinite(cls_preds.asnumpy()).all()


def test_zoo_names_equal_the_reference():
    for name, kw in (("ssd_300_vgg16", {"classes": 20}),
                     ("ssd_96_tiny", {"classes": 3})):
        jm = jax_vision.get_model(name, **kw)
        tm = vision.get_model(name, **kw)
        assert list(tm._collect_params_with_prefix()) == \
            list(jm._collect_params_with_prefix())
        canon = lambda n: ssd._canonical(n)[0]  # noqa: E731
        assert [canon(n) for n in tm.collect_params()] == \
            [canon(n) for n in jm.collect_params()]


# ---------------------------------------------------------------------------
# the weight carrier
# ---------------------------------------------------------------------------
def test_state_from_jax_maps_the_vgg_names():
    """The reference's ssd_300_vgg16 collect_params() names (of a net
    numbered past 0) map onto the port's structural keys in order."""
    jax_ssd.ssd_300_vgg16(classes=2)                  # ssd counters move
    jm = jax_ssd.ssd_300_vgg16(classes=2)
    tm = ssd.ssd_300_vgg16(classes=2)
    shapes = [p.shape for p in tm._collect_params_with_prefix().values()]
    named = {n: onp.zeros(s, onp.float32)
             for n, s in zip(jm.collect_params(), shapes)}
    sd = carrier.params_from_jax(named)
    assert list(sd) == list(jm._collect_params_with_prefix())
    assert sd["conv4_3_scale"].shape == (1, 512, 1, 1)


def test_state_from_jax_round_trips_the_tiny_net(reference):
    _, named = reference
    sd = ssd.state_from_jax(named)
    net = ssd.ssd_96_tiny(classes=3)
    keys = net.jax_names()
    for k, v in sd.items():
        assert torch.equal(v, torch.from_numpy(named[next(
            n for n in named if ssd._canonical(n)[0] == keys[k])])), k
    with pytest.raises(MXNetError, match="no ssd_300_vgg16"):
        ssd.state_from_jax({k: v.numpy() for k, v in sd.items()})


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "two nets"])
def test_state_from_jax_refuses_a_mismatch(reference, fault):
    _, named = reference
    bad = dict(named)
    first = next(iter(named))
    if fault == "missing":
        del bad[first]
    elif fault == "extra":
        bad["ssd0_conv2d99_weight"] = onp.zeros((1,), onp.float32)
    elif fault == "shape":
        bad[first] = onp.zeros((1, 1, 1, 1), onp.float32)
    else:
        bad["ssd7_" + first.split("_", 2)[-1]] = bad.pop(
            next(n for n in named if n.startswith("ssd")))
    with pytest.raises(MXNetError):
        ssd.state_from_jax(bad)


# ---------------------------------------------------------------------------
# the card's training path, on the CPU
# ---------------------------------------------------------------------------
def test_train_step_equals_the_trainer_and_trains_in_bf16(reference, data):
    """ParallelTrainStep (the card's main path) with Adam: two f32 steps
    give the Trainer's weights within 1e-5 of max(1, |w|) (the mean of
    the per-image losses against their sum over the batch size); two bf16
    steps over f32 masters give finite losses that fall on one batch."""
    _, named = reference
    x, y = data
    step = parallel.ParallelTrainStep(
        _port(named), ssd.SSDMultiBoxLoss(),
        optimizer.Adam(learning_rate=1e-3),
        parallel.make_mesh({"dp": 1}, ctx=CPU))
    p_losses = [step(x, y).item() for _ in range(2)]
    net = _port(named)
    with CPU:
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-3})
        loss_fn = ssd.SSDMultiBoxLoss()
        g_losses = []
        for _ in range(2):
            with autograd.record():
                loss = loss_fn(*net(mt.nd.array(x)), mt.nd.array(y))
            loss.backward()
            trainer.step(B)
            g_losses.append(float(loss.asnumpy().mean()))
    _close(p_losses, g_losses, what="losses")
    tp = {k: p.data().asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    for k, v in step.params.items():
        _close(v.detach().numpy(), tp[k], what=k)

    bf16 = parallel.ParallelTrainStep(
        _port(named), ssd.SSDMultiBoxLoss(),
        optimizer.Adam(learning_rate=1e-3),
        parallel.make_mesh({"dp": 1}, ctx=CPU), compute_dtype="bfloat16")
    losses = [bf16(x, y).item() for _ in range(3)]
    assert onp.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(v.dtype == torch.float32 for v in bf16.params.values())


@pytest.mark.skipif(
    os.environ.get("MXNET_TEST_DETECTION", "0") != "1",
    reason="detection-accuracy tier is opt-in (set MXNET_TEST_DETECTION=1), "
           "as tests/test_ssd.py's; phase 10 of chip_smoke.py runs it on "
           "the card")
def test_tiny_ssd_trains_to_map_floor():
    """tests/test_ssd.py's accuracy drive through the port: ssd_96_tiny,
    251 Adam steps (lr 2e-3, batch 16) on 96 shapes images, VOC07 mAP@0.5
    on 32 held-out images at least 0.6."""
    imgs, labels = get_shapes_detection(96, size=96, seed=0)
    val_imgs, val_labels = get_shapes_detection(32, size=96, seed=99)
    with CPU:
        net = ssd.ssd_96_tiny(classes=3)
        net.initialize(mt.init.Xavier())
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 2e-3})
        loss_fn = ssd.SSDMultiBoxLoss()
        rng = onp.random.RandomState(7)
        for step in range(251):
            idx = rng.randint(0, len(imgs), 16)
            with autograd.record():
                L = loss_fn(*net(mt.nd.array(imgs[idx])),
                            mt.nd.array(labels[idx]))
            L.backward()
            trainer.step(16)
            if step == 0:
                first = float(L.asnumpy().mean())
        assert float(L.asnumpy().mean()) < first / 4
        metric = ssd.MApMetric(ovp_thresh=0.5)
        metric.update(net.detect(mt.nd.array(val_imgs), threshold=0.01),
                      val_labels)
    assert metric.get()[1] >= 0.6, metric.get()
