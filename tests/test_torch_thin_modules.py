"""The port's thin top-level modules (``runtime``, ``error``, ``libinfo``,
``log``, ``registry``, ``resource``, ``context``, ``tensor_inspector``,
``util`` and ``contrib.{autograd, io, ndarray}``) against the JAX
package's, on the oracles of tests/test_config.py
(``test_tensor_inspector``, ``test_resource_manager``,
``test_top_level_thin_modules``) and tests/test_contrib_text_svrg.py
(``test_contrib_thin_modules``). On the CPU; ``Features`` reports the
port's CUDA stack (no card here)."""
import logging

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import contrib, nd
from mxnet_tpu_torch.tensor_inspector import CheckerType

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))      # prime the intra-op pool (SKILL.md)

CPU = mt.cpu()
VALUES = onp.array([[1.0, -2.0, 0.0], [onp.nan, onp.inf, -onp.inf]],
                   "float32")
CHECKERS = [v for k, v in vars(CheckerType).items() if k.endswith("Checker")]


# ---------------------------------------------------------------------------
# tensor_inspector
# ---------------------------------------------------------------------------
def test_tensor_inspector():
    a = nd.array(onp.array([[1.0, -2.0], [onp.nan, onp.inf]], "float32"),
                 ctx=CPU)
    ti = mt.TensorInspector(a, tag="grad")
    s = ti.to_string()
    assert "grad" in s and "float32" in s and "(2, 2)" in s
    assert ti.check_value(CheckerType.NaNChecker) == [(1, 0)]
    assert ti.check_value(CheckerType.AbnormalChecker) == [(1, 0), (1, 1)]
    assert ti.check_value(CheckerType.NegativeChecker) == [(0, 1)]
    assert ti.check_value(lambda x: x == 1.0) == [(0, 0)]


@pytest.mark.parametrize("checker", CHECKERS)
def test_tensor_inspector_checkers_equal_the_references(checker):
    got = mt.TensorInspector(nd.array(VALUES, ctx=CPU)).check_value(checker)
    want = jmx.TensorInspector(jnd.array(VALUES)).check_value(checker)
    assert got == want


@pytest.mark.parametrize("what", ["ndarray", "tensor", "bf16", "int"])
def test_tensor_inspector_text_equals_the_references(what):
    arr = onp.arange(100, dtype="float32").reshape(10, 10) - 50
    if what == "int":
        arr = arr.astype("int32")
    want = jmx.TensorInspector(arr, tag="t").to_string(max_elems=16)
    src = {"ndarray": nd.array(arr, ctx=CPU, dtype=arr.dtype),
           "tensor": torch.from_numpy(arr),
           "bf16": torch.from_numpy(arr).bfloat16(),
           "int": torch.from_numpy(arr)}[what]
    got = mt.TensorInspector(src, tag="t").to_string(max_elems=16)
    assert got == want


def test_tensor_inspector_dump_to_file(tmp_path):
    f = mt.TensorInspector(nd.array(VALUES, ctx=CPU)).dump_to_file(
        str(tmp_path / "ti"), 3)
    assert f.endswith("ti_3.npy")
    onp.testing.assert_array_equal(onp.load(f), VALUES)


def test_tensor_inspector_unknown_checker_raises():
    with pytest.raises(mt.MXNetError, match="unknown checker"):
        mt.TensorInspector(VALUES).check_value("odd")


# ---------------------------------------------------------------------------
# resource
# ---------------------------------------------------------------------------
def test_resource_manager():
    with CPU:
        r = mt.resource.request(mt.resource.ResourceRequest.kRandom)
        g1, g2 = r.get_random(), r.get_random()
        assert isinstance(g1, torch.Generator)
        assert g1.initial_seed() != g2.initial_seed()
        gens = r.get_parallel_random(4)
        assert len(gens) == 4 and len({g.initial_seed() for g in gens}) == 4
        space = mt.resource.request("temp_space").get_space((8, 8))
        assert space.shape == (8, 8)
    with pytest.raises(mt.MXNetError):
        mt.resource.request(mt.resource.ResourceRequest.kCuDNNDropoutDesc)


def test_resource_streams_follow_the_seed():
    def draws():
        mt.random.seed(11)
        r = mt.resource.request("random", ctx=CPU)
        return [torch.rand(3, generator=g) for g in r.get_parallel_random(2)]
    a, b = draws(), draws()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])


def test_resource_on_the_card_needs_one():
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        mt.resource.request("random", ctx=mt.gpu(0)).get_random()


# ---------------------------------------------------------------------------
# libinfo, registry, log, error
# ---------------------------------------------------------------------------
def test_top_level_thin_modules():
    assert mt.libinfo.__version__ == "2.0.0" == jmx.libinfo.__version__
    assert all(p.endswith(".so") for p in mt.libinfo.find_lib_path())
    assert mt.libinfo.find_include_path().endswith("csrc")

    class Base:
        pass

    class Foo(Base):
        pass

    mt.registry.get_register_func(Base, "base")(Foo)
    assert isinstance(mt.registry.get_create_func(Base, "base")("foo"), Foo)
    alias = mt.registry.get_alias_func(Base, "base")
    alias("bar", "baz")(Foo)
    assert isinstance(mt.registry.get_create_func(Base, "base")("baz"), Foo)
    assert set(mt.registry.get_registry(Base)) == {"foo", "bar", "baz"}

    lg = mt.log.get_logger("port-parity-test", level=mt.log.DEBUG)
    assert lg.level == mt.log.DEBUG

    with pytest.raises(mt.base.MXNetError):
        raise mt.error.InternalError("boom")
    assert mt.error.get_error_class("InternalError") is mt.error.InternalError


def test_registry_creates_from_json_and_instances():
    class Base:
        pass

    class Opt(Base):
        def __init__(self, lr=0.0):
            self.lr = lr

    for reg in (mt.registry, jmx.registry):
        reg.get_register_func(Base, "opt")(Opt)
        create = reg.get_create_func(Base, "opt")
        assert create('["opt", {"lr": 0.5}]').lr == 0.5
        inst = Opt(1.0)
        assert create(inst) is inst
        assert create(opt="OPT", lr=2.0).lr == 2.0


def test_registry_refuses_other_classes():
    class Base:
        pass

    with pytest.raises(mt.MXNetError):
        mt.registry.get_register_func(Base, "b")(int)


def test_log_format_equals_the_references(tmp_path):
    lines = []
    for mod, name in ((mt.log, "port-fmt"), (jmx.log, "ref-fmt")):
        path = tmp_path / f"{name}.log"
        lg = mod.get_logger(name, filename=str(path), level=mod.INFO)
        lg.info("hello")
        for h in lg.handlers:
            h.flush()
        lines.append(path.read_text().split(" ", 2)[2])
    assert lines[0].replace("port-fmt", "X") == \
        lines[1].replace("ref-fmt", "X")
    assert (mt.log.WARNING, mt.log.NOTSET) == (logging.WARNING,
                                               logging.NOTSET)


def test_error_registry_by_name():
    @mt.error.register
    class PortTestError(mt.MXNetError):
        pass

    @mt.error.register("ValueErrorName")
    class Other(mt.MXNetError):
        pass

    assert mt.error.get_error_class("PortTestError") is PortTestError
    assert mt.error.get_error_class("ValueErrorName") is Other
    assert mt.error.get_error_class("nothing") is mt.MXNetError
    assert str(mt.error.InternalError("x")) == \
        str(jmx.error.InternalError("x"))


# ---------------------------------------------------------------------------
# runtime, context, util
# ---------------------------------------------------------------------------
def test_features_report_the_cuda_stack():
    feats = mt.runtime.Features()
    assert set(feats) == set(jmx.runtime.Features())
    assert not feats.is_enabled("TPU") and not feats.is_enabled("xla")
    assert not feats.is_enabled("PALLAS")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert feats.card is None          # no card in this test's process
    assert [f.name for f in mt.runtime.feature_list()] == list(feats)
    assert mt.runtime.libinfo_features is mt.runtime.feature_list
    assert "✖ CUDA" in repr(feats)


def test_context_module():
    assert mt.context.Context is mt.Context
    assert mt.context.cpu(0) == CPU and mt.context.gpu(1) == mt.gpu(1)
    assert mt.context.num_gpus() == torch.cuda.device_count() == \
        mt.util.get_gpu_count()
    assert mt.context.current_context() == mt.gpu(0)


def test_util(tmp_path):
    d = tmp_path / "a" / "b"
    mt.util.makedirs(str(d))
    mt.util.makedirs(str(d))
    assert d.is_dir()
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        mt.util.get_gpu_memory(0)


# ---------------------------------------------------------------------------
# contrib.autograd, contrib.io, contrib.ndarray
# ---------------------------------------------------------------------------
def test_contrib_autograd_grad_and_loss_equals_the_references():
    x = onp.array([1., 2., 3.], "float32")
    grads, loss = contrib.autograd.grad_and_loss(
        lambda a: (a * a).sum())(nd.array(x, ctx=CPU))
    jgrads, jloss = jmx.contrib.autograd.grad_and_loss(
        lambda a: (a * a).sum())(jnd.array(x))
    onp.testing.assert_allclose(grads[0].asnumpy(), [2., 4., 6.])
    onp.testing.assert_array_equal(grads[0].asnumpy(), jgrads[0].asnumpy())
    assert float(loss.asnumpy()) == float(jloss.asnumpy())
    g = contrib.autograd.grad(lambda a, b: (a * b).sum(), argnum=1)
    got = g(nd.array(x, ctx=CPU), nd.array(x * 0 + 2, ctx=CPU))
    onp.testing.assert_array_equal(got[0].asnumpy(), x)


def test_contrib_autograd_training_switch():
    prev = contrib.autograd.set_is_training(True)
    try:
        assert mt.autograd.is_training()
    finally:
        contrib.autograd.set_is_training(prev)
    assert mt.autograd.is_training() == prev
    with contrib.autograd.train_section():
        assert mt.autograd.is_recording()
    with contrib.autograd.test_section():
        assert not mt.autograd.is_recording()


class _DS(mt.gluon.data.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return onp.full((3,), float(i), "float32"), i % 2


def test_dataloader_iter():
    loader = mt.gluon.data.DataLoader(_DS(), batch_size=4)
    it = contrib.io.DataLoaderIter(loader)
    assert it.batch_size == 4
    assert it.provide_data[0].name == "data"
    assert tuple(it.provide_data[0].shape) == (4, 3)
    assert it.provide_label[0].name == "softmax_label"
    first = it.next()
    assert first.data[0].shape == (4, 3)
    onp.testing.assert_array_equal(first.data[0].asnumpy()[:, 0],
                                   [0., 1., 2., 3.])
    assert it.next().data[0].shape == (4, 3)
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    assert it.next().data[0].shape == (4, 3)


def test_dataloader_iter_refuses_a_generator_and_an_empty_loader():
    with pytest.raises(mt.MXNetError, match="re-iterable"):
        contrib.io.DataLoaderIter(
            (onp.zeros((2, 3)), onp.zeros(2)) for _ in range(3))
    with pytest.raises(mt.MXNetError, match="empty"):
        contrib.io.DataLoaderIter([])


def test_contrib_ndarray_is_nd_contrib():
    assert len(dir(contrib.ndarray)) > 3
    assert contrib.ndarray.foreach is nd.contrib.foreach
    assert contrib.ndarray.boolean_mask is nd.contrib.boolean_mask
