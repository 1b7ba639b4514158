"""The port's autograd (mxnet_tpu_torch.autograd over NDArrays) against the
JAX package's, both on the CPU, on every case of tests/test_autograd.py
lines 10-125: simple, chain rule, multiple inputs, ``grad_req="add"``, head
gradients, the ``grad`` API, the recording and training flags, ``pause``,
``detach`` and a custom ``Function``.

Each case runs the same numpy inputs through both packages; gradients must
have the reference's dtype and shape and agree within 1e-5 relative (f32
sums, and exp/sigmoid, in another order or implementation). The tests
after those hold the MXNet semantics the port keeps where PyTorch's
defaults differ.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

RTOL = 1e-5


def _run(case):
    ref = case(mx, mx.cpu())
    with mt.cpu():
        got = case(mt, mt.cpu())
    assert list(ref) == list(got)
    for k in ref:
        r, g = ref[k], got[k]
        if not hasattr(r, "asnumpy"):
            assert g == r, k
            continue
        assert str(g.dtype) == str(r.dtype) and g.shape == r.shape, k
        onp.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=RTOL,
                                    atol=RTOL, err_msg=k)


def _x(pkg, ctx, seed, shape, shift=0.0):
    a = onp.random.RandomState(seed).randn(*shape).astype(onp.float32)
    return pkg.nd.array(a + shift, ctx=ctx)


def case_simple(pkg, ctx):
    x = _x(pkg, ctx, 0, (3,))
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x * 2).sum()
    y.backward()
    return {"y": y, "grad": x.grad}


def case_chain_rule(pkg, ctx):
    x = _x(pkg, ctx, 1, (2, 2))
    x.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.exp(x)
        z = (y * y).sum()
    z.backward()
    return {"z": z, "grad": x.grad}


def case_multi_input(pkg, ctx):
    a, b = _x(pkg, ctx, 2, (4,)), _x(pkg, ctx, 3, (4,))
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        c = (a * b + a).sum()
    c.backward()
    return {"a_grad": a.grad, "b_grad": b.grad}


def case_grad_req_add(pkg, ctx):
    x = _x(pkg, ctx, 4, (3,))
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
    return {"grad": x.grad}


def case_head_grads(pkg, ctx):
    x = _x(pkg, ctx, 5, (2,))
    x.attach_grad()
    with pkg.autograd.record():
        y = x * 3
    y.backward(pkg.nd.array([10.0, 20.0], ctx=ctx))
    return {"grad": x.grad}


def case_grad_api(pkg, ctx):
    x = pkg.nd.array([2.0], ctx=ctx)
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x
        g = pkg.autograd.grad(y, x, retain_graph=False)
    return {"g": g, "grad_untouched": x.grad}


def case_flags(pkg, ctx):
    ag = pkg.autograd
    out = {"idle": (ag.is_recording(), ag.is_training())}
    with ag.record():
        out["record"] = (ag.is_recording(), ag.is_training())
        with ag.pause():
            out["pause"] = (ag.is_recording(), ag.is_training())
        with ag.predict_mode():
            out["predict"] = (ag.is_recording(), ag.is_training())
    with ag.record(train_mode=False):
        out["record_predict"] = (ag.is_recording(), ag.is_training())
    with ag.train_mode():
        out["train"] = (ag.is_recording(), ag.is_training())
    out["set_recording"] = ag.set_recording(True)
    out["set_recording_back"] = ag.set_recording(False)
    out["set_training"] = ag.set_training(True)
    out["set_training_back"] = ag.set_training(False)
    out["after"] = (ag.is_recording(), ag.is_training())
    return out


def case_pause(pkg, ctx):
    x = pkg.nd.array([1.0], ctx=ctx)
    x.attach_grad()
    with pkg.autograd.record():
        y = x * 2
        with pkg.autograd.pause():
            z = x * 100          # not recorded
        w = (y + z).sum()
    w.backward()
    return {"grad": x.grad}


def case_detach(pkg, ctx):
    x = pkg.nd.array([3.0], ctx=ctx)
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    return {"grad": x.grad}


def case_custom_function(pkg, ctx):
    nd = pkg.nd

    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = _x(pkg, ctx, 6, (5,))
    x.attach_grad()
    with pkg.autograd.record():
        y = Sigmoid()(x)
        s = (y * nd.array(onp.arange(5, dtype=onp.float32), ctx=ctx)).sum()
    s.backward()
    return {"y": y, "grad": x.grad}


def case_non_scalar_head(pkg, ctx):
    x = _x(pkg, ctx, 7, (2, 3))
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x + x           # not a scalar: head gradient of ones
    y.backward()
    return {"grad": x.grad}


@pytest.mark.parametrize("case", [
    case_simple, case_chain_rule, case_multi_input, case_grad_req_add,
    case_head_grads, case_grad_api, case_flags, case_pause, case_detach,
    case_custom_function, case_non_scalar_head],
    ids=lambda f: f.__name__[5:])
def test_port_matches_the_jax_package(case):
    _run(case)


# ---------------------------------------------------------------------------
# MXNet's semantics where PyTorch's defaults differ
# ---------------------------------------------------------------------------
def test_write_overwrites_and_add_accumulates():
    nd, ag = mt.nd, mt.autograd
    for req, want in (("write", [2.0, 4.0]), ("add", [6.0, 12.0])):
        x = nd.array([1.0, 2.0], ctx=mt.cpu())
        x.attach_grad(grad_req=req)
        for k in (1, 1, 1):
            with ag.record():
                y = (x * x * k).sum()
            y.backward()
        onp.testing.assert_array_equal(x.grad.asnumpy(), want)
        assert x.data.grad is None        # nothing piles up on the leaf


def test_no_graph_outside_record():
    x = mt.nd.array([1.0, 2.0], ctx=mt.cpu())
    x.attach_grad()
    y = (x * 2).sum()
    assert not y.data.requires_grad
    with pytest.raises(MXNetError, match="not recorded"):
        y.backward()
    with mt.autograd.record():
        with mt.autograd.pause():
            z = x * 3
    assert not z.data.requires_grad


def test_training_flag_is_apart_from_recording():
    ag = mt.autograd
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()


def test_in_place_write_keeps_the_gradient():
    """``x += 1`` and ``x[k] = v`` rebind an attached array's tensor; it
    stays a leaf that collects its gradient."""
    x = mt.nd.array([1.0, 2.0, 3.0], ctx=mt.cpu())
    x.attach_grad()
    x += 1
    x[0] = 10.0
    with mt.autograd.record():
        y = (x * x).sum()
    y.backward()
    onp.testing.assert_array_equal(x.grad.asnumpy(), [20.0, 6.0, 8.0])


def test_mark_variables_and_unreachable_grad():
    ag = mt.autograd
    x = mt.nd.array([1.0, 2.0], ctx=mt.cpu())
    u = mt.nd.array([5.0], ctx=mt.cpu())
    buf = mt.nd.zeros((2,), ctx=mt.cpu())
    ag.mark_variables([x, u], [buf, mt.nd.zeros((1,), ctx=mt.cpu())],
                      grad_reqs="write")
    with ag.record():
        y = (x * 4).sum()
    with pytest.raises(MXNetError, match="unreachable"):
        ag.grad(y, [x, u], retain_graph=True)
    y.backward()
    assert x.grad is buf
    onp.testing.assert_array_equal(buf.asnumpy(), [4.0, 4.0])
    with pytest.raises(MXNetError, match="grad_req"):
        ag.mark_variables(x, buf, "sometimes")


def test_grad_with_create_graph_differentiates_again():
    x = mt.nd.array([2.0, 3.0], ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = (x * x * x).sum()
        (g,) = mt.autograd.grad(y, [x], create_graph=True)
        z = g.sum()
    z.backward()
    onp.testing.assert_allclose(g.asnumpy(), [12.0, 27.0])
    onp.testing.assert_allclose(x.grad.asnumpy(), [12.0, 18.0])
