"""The port's vision zoo beyond ResNet v1 (ResNet v2, AlexNet, VGG,
SqueezeNet, DenseNet, Inception-v3, MobileNet v1/v2) against the JAX
package on the CPU.

- Every model name of the reference's ``get_model``: the same
  ``collect_params()`` names (the net's prefix stripped) and structural
  names in the same order, and the same known dimensions (a dimension the
  reference defers, 0 until the first forward, may be known in the port:
  ResNet gives every layer its input channels).
- Each family's blocks at small widths, and the smallest member of each
  family whole at the smallest input the reference takes (DenseNet at a
  reduced configuration of the same class: densenet121's first reference
  call compiles for ~25 s on a CPU), from the same seeded weights (the
  reference's parameters after its first forward, set from numpy and
  carried into the port by ``carrier``): the forward in inference mode
  within 1e-4 x max(1, max|reference|) (f32 both; sums in another order),
  and the parameter shapes equal. The nets take the JAX package's
  ``collect_params()`` dict through ``carrier.params_from_jax``.
- resnet50_v1's parameter count, running stats included, as the JAX
  package counts it, is ``tools.RESNET50_V1_PARAM_COUNT``, which
  ``Block.summary`` prints on the card in phase 14 of ``chip_smoke.py``.
"""
import contextlib
import io
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import initializer as jax_initializer
from mxnet_tpu.gluon.model_zoo import vision as jv
from mxnet_tpu.gluon.model_zoo.vision import dense_nets as jdn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.gluon.model_zoo.vision import simple_nets as jsn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import carrier
from mxnet_tpu_torch.gluon.model_zoo import vision as tv
from mxnet_tpu_torch.gluon.model_zoo.vision import dense_nets as tdn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.gluon.model_zoo.vision import simple_nets as tsn
from mxnet_tpu_torch.tools import RESNET50_V1_PARAM_COUNT

torch.set_num_threads(2)
# prime the intra-op pool before any comparison (SKILL.md, CPU glitch)
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()
TOL = 1e-4
NAMES = sorted(n for n in jv._models if not n.startswith("ssd"))


def _known(shape):
    return tuple(shape or ())


@pytest.mark.parametrize("name", NAMES)
def test_every_model_has_the_reference_names_and_shapes(name):
    j, t = jv.get_model(name, classes=7), tv.get_model(name, classes=7)
    jp = [(k[len(j.prefix):], _known(p.shape))
          for k, p in j.collect_params().items()]
    tp = [(k[len(t.prefix):], _known(p.shape))
          for k, p in t.collect_params().items()]
    assert [k for k, _ in jp] == [k for k, _ in tp]
    assert list(j._collect_params_with_prefix()) == \
        list(t._collect_params_with_prefix())
    for (k, js), (_, ts) in zip(jp, tp):
        assert len(js) == len(ts) and all(
            a in (0, b) for a, b in zip(js, ts)), (k, js, ts)


def test_get_model_takes_every_reference_name():
    assert sorted(tv._models) == sorted(jv._models)
    assert isinstance(tv.get_model("densenet121"), tdn.DenseNet)
    with pytest.raises(MXNetError, match="not supported"):
        tv.get_model("resnet51_v1")


# ---------------------------------------------------------------------------
# seeded weights through both packages
# ---------------------------------------------------------------------------
def _seed(jblock, x, seed):
    """Initialize ``jblock``, run it once (deferred shapes), then set every
    parameter from seeded numpy (He-scaled weights, BatchNorm's moments and
    affine near their identities); returns {structural name: array} and
    the reference's inference output."""
    for p in jblock.collect_params().values():
        if isinstance(p.init, str):      # the reference cannot (Queue 3)
            p.init = jax_initializer._REG.get(p.init)()
    jblock.initialize()
    jblock(mx.nd.array(x))
    rng = onp.random.RandomState(seed)
    named = {}
    for k, p in jblock._collect_params_with_prefix().items():
        shape = tuple(p.shape)
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", "beta", "bias")):
            v = rng.uniform(-0.1, 0.1, shape)
        elif k.endswith("gamma"):
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.randn(*shape) * math.sqrt(2.0 / math.prod(shape[1:]))
        named[k] = v.astype(onp.float32)
        p.set_data(mx.nd.array(named[k]))
    return named, jblock(mx.nd.array(x)).asnumpy()


def _port_forward(tblock, named, x):
    carrier.load_jax_params(tblock, named, ctx=CPU)
    with CPU:
        return tblock(mt.nd.array(x)).asnumpy()


def _close(got, want):
    assert got.shape == want.shape
    err = onp.abs(got - want).max() / max(1.0, onp.abs(want).max())
    assert err <= TOL, err


def _x(shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


BLOCKS = {
    "BasicBlockV2": (lambda m: m.BasicBlockV2(8, 2, True, in_channels=4),
                     (jres, tres), (2, 4, 8, 8)),
    "BottleneckV2": (lambda m: m.BottleneckV2(16, 2, True, in_channels=8),
                     (jres, tres), (2, 8, 8, 8)),
    "BottleneckV2_identity": (
        lambda m: m.BottleneckV2(8, 1, False, in_channels=8),
        (jres, tres), (2, 8, 6, 6)),
    "DenseLayer": (lambda m: m._DenseLayer(4, 2, 0), (jdn, tdn),
                   (2, 6, 6, 6)),
    "InceptionA": (lambda m: m._make_A(8, "A1_"), (jdn, tdn), (1, 8, 7, 7)),
    "InceptionB": (lambda m: m._make_B("B_"), (jdn, tdn), (1, 8, 9, 9)),
    "InceptionC": (lambda m: m._make_C(8, "C1_"), (jdn, tdn), (1, 8, 7, 7)),
    "InceptionD": (lambda m: m._make_D("D_"), (jdn, tdn), (1, 8, 9, 9)),
    "InceptionE": (lambda m: m._InceptionE("E1_"), (jdn, tdn), (1, 8, 5, 5)),
    "LinearBottleneck": (lambda m: m._LinearBottleneck(8, 8, 2, 1),
                         (jdn, tdn), (2, 8, 6, 6)),
    "LinearBottleneck_stride2": (lambda m: m._LinearBottleneck(8, 16, 3, 2),
                                 (jdn, tdn), (2, 8, 7, 7)),
    "Fire": (lambda m: m._Fire(4, 8, 8), (jsn, tsn), (2, 6, 7, 7)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_the_reference(name):
    make, (jm, tm), shape = BLOCKS[name]
    x = _x(shape)
    named, want = _seed(make(jm), x, seed=1)
    tblock = make(tm)
    _close(_port_forward(tblock, named, x), want)
    assert {k: tuple(p.shape) for k, p in
            tblock._collect_params_with_prefix().items()} == \
        {k: v.shape for k, v in named.items()}


# (name, constructor kwargs, input height/width): the family's smallest
# member at the smallest input its pools take; SqueezeNet at 34, where its
# ceil-mode pools round up (16 -> 8 -> 4 -> 2; floor would give 7, 3, 1)
NETS = [("resnet18_v2", {}, 32), ("mobilenet0_25", {}, 32),
        ("mobilenet_v2_0_25", {}, 32), ("squeezenet1_1", {}, 34),
        ("alexnet", {}, 63), ("vgg11", {}, 32), ("vgg11_bn", {}, 32),
        ("inception_v3", {}, 299),
        ("DenseNet", dict(num_init_features=8, growth_rate=4,
                          block_config=[1, 1, 1, 1]), 224)]


def _build(pkg, name, kw):
    if name == "DenseNet":
        return pkg.DenseNet(classes=5, **kw)
    return pkg.get_model(name, classes=5, **kw)


@pytest.mark.parametrize("name,kw,hw", NETS, ids=[n[0] for n in NETS])
def test_whole_net_matches_the_reference(name, kw, hw):
    x = _x((2, 3, hw, hw), seed=2)
    jnet = _build(jv if name != "DenseNet" else jdn, name, kw)
    named, want = _seed(jnet, x, seed=3)
    tnet = _build(tv if name != "DenseNet" else tdn, name, kw)
    if name == "DenseNet":       # not a get_model name: structural names
        _close(_port_forward(tnet, named, x), want)
        return
    # the JAX package's collect_params() dict through the carrier
    by_id = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    collect = {c: named[by_id[id(p)]]
               for c, p in jnet.collect_params().items()}
    sd = carrier.params_from_jax(collect)
    assert set(sd) == set(named)
    assert all(tuple(sd[k].shape) == v.shape for k, v in named.items())
    tnet.load_state_dict(sd)
    with CPU:
        got = tnet(mt.nd.array(x)).asnumpy()
    _close(got, want)


def test_reference_vgg_string_initializer_fault():
    """The reference's VGG names its Dense layers' initializer by string
    ("normal"), and its Parameter calls the string: the net cannot
    initialize (ROADMAP Queue 3). The port resolves the name."""
    jnet = jv.get_model("vgg11", classes=5)
    jnet.initialize()
    with pytest.raises(TypeError, match="not callable"):
        jnet(mx.nd.array(_x((1, 3, 32, 32))))
    tnet = tv.get_model("vgg11", classes=5)
    tnet.initialize(ctx=CPU)
    with CPU:
        out = tnet(mt.nd.array(_x((1, 3, 32, 32))))
    assert out.shape == (1, 5)
    w = tnet.output.weight.data().asnumpy()
    assert abs(w.std() - 0.01) < 0.002          # Normal(0.01)


def test_carrier_refuses_a_family_mismatch():
    """A MobileNet's ``collect_params()`` dict (the port's own names, which
    equal the reference's) with one running variance missing."""
    net = tv.get_model("mobilenet0_25", classes=5)
    net.initialize(ctx=CPU)
    with CPU:
        net(mt.nd.array(_x((1, 3, 32, 32))))
    collect = {c: p.data().asnumpy() for c, p in net.collect_params().items()}
    assert carrier.zoo_family(collect) == "mobilenet"
    assert set(carrier.params_from_jax(collect)) == \
        set(net._collect_params_with_prefix())
    bad = dict(collect)
    bad.pop(next(k for k in bad if k.endswith("batchnorm3_running_var")))
    with pytest.raises(MXNetError, match="missing"):
        carrier.params_from_jax(bad)


def test_resnet50_v1_parameter_count():
    """The JAX package's count (after its first forward), the port's
    ``Block.summary`` total and the constant phase 14 holds the card's
    summary to agree."""
    jnet = jv.get_model("resnet50_v1", classes=1000)
    jnet.initialize()
    jnet(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))
    want = sum(math.prod(p.shape) for p in jnet.collect_params().values())
    assert want == RESNET50_V1_PARAM_COUNT
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tv.resnet50_v1(classes=1000).summary()
    last = out.getvalue().strip().splitlines()[-1]
    assert last == f"Total params: {RESNET50_V1_PARAM_COUNT}"


def test_print_summary_rows_equal_the_reference():
    """``visualization.print_summary`` of a Block (``Block.summary``): the
    reference's rows, widths and total, shapes known after a forward."""
    from mxnet_tpu import visualization as jax_visualization
    from mxnet_tpu_torch import visualization
    x = _x((1, 3, 34, 34))
    jnet = jv.get_model("squeezenet1_1", classes=5, prefix="sq_")
    jnet.initialize()
    jnet(mx.nd.array(x))
    tnet = tv.get_model("squeezenet1_1", classes=5, prefix="sq_")
    tnet.initialize(ctx=CPU)
    with CPU:
        tnet(mt.nd.array(x))
    printed = []
    for fn, net in ((jax_visualization.print_summary, jnet),
                    (visualization.print_summary, tnet)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            total = fn(net)
        printed.append((out.getvalue(), total))
    assert printed[1] == printed[0]
    with pytest.raises(MXNetError, match="Gluon Block"):
        visualization.print_summary("not a block")
