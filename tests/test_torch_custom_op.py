"""The port's custom operators (``operator``: ``CustomOp``,
``CustomOpProp``, ``register``, ``nd.Custom``) and external op libraries
(``library.load``) against the JAX package on the CPU.

The seven cases of ``tests/test_custom_op.py`` and the five of
``tests/test_library.py`` run through both packages on the same seeded
inputs (the same ops registered in each under names of their own; the
library built by g++ from ``tests/torch_ext_ops.cc``, the ops of
``tests/test_library.py``'s source). Values and gradients within 1e-6
relative (f32; the bodies do the same one or two products), exact where
the reference test is exact. A hybridized block takes the place of
``test_custom_op_under_jit`` (``hybridize`` keeps the eager forward in the
port). Then the port's own: the context a body gets, the registration
version, and the fork handlers of ``library``.
"""
import os
import subprocess
from pathlib import Path

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError

torch.set_num_threads(2)

CPU = mt.cpu()
RTOL = 1e-6
EXT_SOURCE = Path(__file__).with_name("torch_ext_ops.cc")


def _register(pkg):
    """Sqr, Mult and Scale (the reference test's ops) in ``pkg``."""
    op = pkg.operator

    @op.register("port_sqr")
    class SqrProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Sqr(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2 * in_data[0] * out_grad[0])
            return Sqr()

    @op.register("port_mult")
    class MultProp(op.CustomOpProp):
        def list_arguments(self):
            return ["lhs", "rhs"]

        def list_outputs(self):
            return ["output"]

        def create_operator(self, ctx, shapes, dtypes):
            class Mult(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * in_data[1])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], in_data[1] * out_grad[0])
                    self.assign(in_grad[1], req[1], in_data[0] * out_grad[0])
            return Mult()

    @op.register("port_scale")
    class ScaleProp(op.CustomOpProp):
        def __init__(self, factor="1.0"):
            super().__init__(need_top_grad=True)
            assert isinstance(factor, str)    # attrs arrive as strings
            self.factor = float(factor)

        def create_operator(self, ctx, shapes, dtypes):
            factor = self.factor

            class Scale(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * factor)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * factor)
            return Scale()


_register(mx)
_register(mt)


def _both(fn):
    """``fn(pkg)`` through the JAX package and through the port on
    ``cpu()``; numpy results."""
    want = fn(mx)
    with CPU:
        got = fn(mt)
    return got, want


def _same(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=rtol)


def _u(seed, shape):
    return onp.random.RandomState(seed).uniform(-1, 1, shape).astype(
        onp.float32)


# ---------------------------------------------------------------------------
# tests/test_custom_op.py's cases
# ---------------------------------------------------------------------------
def test_custom_op_forward():
    x = _u(0, (4, 10))
    got, want = _both(lambda pkg: [pkg.nd.Custom(
        pkg.nd.array(x), op_type="port_sqr").asnumpy()])
    _same(got, want)
    _same(got, [x ** 2])


def test_custom_op_backward():
    x = _u(1, (4, 10))

    def run(pkg):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            loss = pkg.nd.Custom(a, op_type="port_sqr").sum()
        loss.backward()
        return [a.grad.asnumpy()]
    got, want = _both(run)
    _same(got, want)
    _same(got, [2 * x])


def test_custom_op_two_inputs():
    a0, b0 = _u(2, (3, 5)), _u(3, (3, 5))

    def run(pkg):
        a, b = pkg.nd.array(a0), pkg.nd.array(b0)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(a, b, op_type="port_mult")
            y.backward()
        return [y.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]
    got, want = _both(run)
    _same(got, want)
    _same(got, [a0 * b0, b0, a0])


def test_custom_op_kwargs_and_infer():
    got, want = _both(lambda pkg: [pkg.nd.Custom(
        pkg.nd.ones((2, 3)), op_type="port_scale", factor=2.5).asnumpy()])
    _same(got, want)
    _same(got, [2.5 * onp.ones((2, 3))])


def test_custom_op_under_hybridize():
    """The reference runs the op inside jax.jit; the port's hybridized
    block runs it eagerly: value and gradient."""
    x = _u(3, (4, 4))

    def run(pkg):
        class Net(pkg.gluon.HybridBlock):
            def hybrid_forward(self, F, a):
                return F.Custom(a, op_type="port_sqr") + 1.0
        net = Net()
        net.hybridize()
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            out = net(a)
            total = out.sum()
        total.backward()
        return [out.asnumpy(), a.grad.asnumpy()]
    got, want = _both(run)
    _same(got, want)
    _same(got, [x ** 2 + 1.0, 2 * x], rtol=1e-5)


def test_custom_op_in_gluon_block():
    x = onp.arange(6, dtype="float32").reshape(2, 3)

    def run(pkg):
        class SqrBlock(pkg.gluon.HybridBlock):
            def hybrid_forward(self, F, a):
                return F.Custom(a, op_type="port_sqr")
        return [SqrBlock()(pkg.nd.array(x)).asnumpy()]
    got, want = _both(run)
    assert onp.array_equal(got[0], want[0])
    _same(got, [x ** 2])


def test_custom_op_unknown_raises():
    with CPU, pytest.raises(MXNetError, match="not registered"):
        mt.nd.Custom(mt.nd.ones((1,)), op_type="no_such_op")
    with pytest.raises(mx.MXNetError):
        mx.nd.Custom(mx.nd.ones((1,)), op_type="no_such_op")


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------
def test_body_gets_the_inputs_context_and_reregistration_replaces():
    seen = []
    op = mt.operator

    def register(scale):
        @op.register("port_ctx_probe")
        class Probe(op.CustomOpProp):
            def create_operator(self, ctx, shapes, dtypes):
                seen.append(ctx)

                class Body(op.CustomOp):
                    def forward(self, is_train, req, in_data, out_data, aux):
                        seen.append(in_data[0].context)
                        self.assign(out_data[0], req[0], in_data[0] * scale)
                return Body()
    register(2.0)
    with CPU:
        x = mt.nd.ones((2,))
        a = mt.nd.Custom(x, op_type="port_ctx_probe").asnumpy()
        register(3.0)
        b = mt.nd.Custom(x, op_type="port_ctx_probe").asnumpy()
    assert a.tolist() == [2.0, 2.0] and b.tolist() == [3.0, 3.0]
    assert seen == ["cpu(0)", CPU, "cpu(0)", CPU]
    assert "port_ctx_probe" in op.get_all_registered_operators()


def test_custom_is_a_registered_op():
    from mxnet_tpu.ops import registry as jax_registry
    from mxnet_tpu_torch.ops import registry
    assert "Custom" in registry.list_ops() and callable(mt.nd.Custom)
    assert len(registry.list_ops()) == 369
    # less the _np_* ops the reference's mx.np registers on first use
    assert set(registry.list_ops()) == {o for o in jax_registry.list_ops()
                                        if not o.startswith("_np_")}


# ---------------------------------------------------------------------------
# tests/test_library.py's cases
# ---------------------------------------------------------------------------
def _gxx(src, so):
    r = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", str(so),
                        str(src)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def ext_lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("extlib") / "libportextops.so"
    _gxx(EXT_SOURCE, so)
    mx.library.load(str(so), verbose=False)
    mt.library.load(str(so), verbose=False)
    return str(so)


def test_external_op_forward(ext_lib):
    x = onp.array([1.0, -2.0, 3.0], "float32")
    got, want = _both(lambda pkg: [pkg.nd.Custom(
        pkg.nd.array(x), op_type="port_ext_square").asnumpy()])
    _same(got, want)
    _same(got, [[1.0, 4.0, 9.0]])


def test_external_op_backward(ext_lib):
    x = onp.array([1.0, -2.0, 3.0], "float32")

    def run(pkg):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Custom(a, op_type="port_ext_square")
            y.sum().backward()
        return [a.grad.asnumpy()]
    got, want = _both(run)
    _same(got, want)
    _same(got, [[2.0, -4.0, 6.0]])


def test_external_op_under_hybridize(ext_lib):
    x = onp.array([2.0, 3.0], "float32")

    def run(pkg):
        class Net(pkg.gluon.HybridBlock):
            def hybrid_forward(self, F, a):
                return F.Custom(a, op_type="port_ext_square") + 1.0
        net = Net()
        net.hybridize()
        return [net(pkg.nd.array(x)).asnumpy()]
    got, want = _both(run)
    _same(got, want)
    _same(got, [[5.0, 10.0]])


def test_external_op_two_inputs(ext_lib):
    a, b = (onp.array([1.0, 2.0], "float32"),
            onp.array([10.0, 20.0], "float32"))
    got, want = _both(lambda pkg: [pkg.nd.Custom(
        pkg.nd.array(a), pkg.nd.array(b),
        op_type="port_ext_addmul").asnumpy()])
    _same(got, want)
    _same(got, [[21.0, 42.0]])


def test_load_missing_entry_point(tmp_path):
    src = tmp_path / "bad.cc"
    so = tmp_path / "libbad.so"
    src.write_text("extern \"C\" { int not_the_entry() { return 0; } }")
    _gxx(src, so)
    with pytest.raises(MXNetError, match="mxtpu_lib_init"):
        mt.library.load(str(so), verbose=False)
    with pytest.raises(mx.MXNetError, match="mxtpu_lib_init"):
        mx.library.load(str(so), verbose=False)
    with pytest.raises(MXNetError, match="not found"):
        mt.library.load(str(tmp_path / "absent.so"), verbose=False)


_FORK_CHECK = """
import faulthandler, os
from mxnet_tpu_torch import engine
assert faulthandler.is_enabled()
parent = engine.get_engine()
done = []
parent.push(lambda: done.append(1))
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    os.close(r)
    ok = engine._engine is None
    child = engine.get_engine()
    ran = []
    child.push(lambda: ran.append(1))
    child.wait_all()
    os.write(w, b"1" if ok and ran == [1] and child is not parent else b"0")
    os._exit(0)
os.close(w)
answer = os.read(r, 1)
os.waitpid(pid, 0)
assert done == [1], done
assert answer == b"1", answer
assert engine.get_engine() is parent
print("fork ok")
"""


def test_fork_drains_the_engine_and_the_child_builds_its_own():
    """Before a fork the parent's host engine runs out its tasks; the
    child gets a new engine, whose tasks run; faulthandler is on. In a
    process of its own that imports the port alone (a fork of this one
    would copy JAX's threads)."""
    import sys
    env = {k: v for k, v in os.environ.items()
           if k != "MXNET_USE_SIGNAL_HANDLER"}
    proc = subprocess.run([sys.executable, "-c", _FORK_CHECK],
                          cwd=Path(__file__).resolve().parents[1], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "fork ok" in proc.stdout, proc.stderr
