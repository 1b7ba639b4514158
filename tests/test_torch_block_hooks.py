"""Gluon forward hooks of the port's Block against the JAX package's
(``mxnet_tpu/gluon/block.py`` ``register_forward_pre_hook`` /
``register_forward_hook``): a hook gets ``(block, args)`` before the
forward and ``(block, args, out)`` after it, its return value is ignored,
and registering returns the hook. Seeded numpy inputs and weights go
through both packages on the CPU; outputs within 1e-6 x max(1, |out|)
(f32 both, one small product)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jax_nn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))    # prime the intra-op pool (SKILL.md)

CPU = mt.cpu()
TOL = 1e-6


def _dense(pkg_nn, w, b):
    net = pkg_nn.Dense(2, in_units=3)
    net.initialize()
    net.weight.set_data(w)
    net.bias.set_data(b)
    return net


def _drive(pkg, pkg_nn, x, w, b):
    """The Dense's output with a pre-hook that returns zeroed inputs and a
    forward hook that returns a zeroed output registered, what each hook
    saw, and what registering returned."""
    net = _dense(pkg_nn, pkg.nd.array(w), pkg.nd.array(b))
    seen = {}

    def pre(block, args):
        seen["pre"] = (block is net, [a.asnumpy() for a in args])
        return (args[0] * 0,)

    def post(block, args, out):
        seen["post"] = (block is net, [a.asnumpy() for a in args],
                        out.asnumpy())
        return out * 0

    returned = (net.register_forward_pre_hook(pre),
                net.register_forward_hook(post))
    out = net(pkg.nd.array(x)).asnumpy()
    return out, seen, returned == (pre, post)


@pytest.fixture
def data():
    rng = onp.random.RandomState(0)
    return (rng.randn(4, 3).astype(onp.float32),
            rng.randn(2, 3).astype(onp.float32),
            rng.randn(2).astype(onp.float32))


def test_hook_return_values_are_ignored(data):
    want, _, _ = _drive(mx, jax_nn, *data)
    with CPU:
        got, _, _ = _drive(mt, nn, *data)
    assert onp.abs(want).max() > 0
    assert onp.abs(got - want).max() <= TOL * max(1.0, onp.abs(want).max())


def test_hooks_see_the_reference_arguments_and_register_returns_them(data):
    _, jseen, jret = _drive(mx, jax_nn, *data)
    with CPU:
        out, tseen, tret = _drive(mt, nn, *data)
    assert jret and tret
    assert tseen["pre"][0] and tseen["post"][0]
    onp.testing.assert_array_equal(tseen["pre"][1][0], jseen["pre"][1][0])
    onp.testing.assert_array_equal(tseen["post"][1][0], jseen["post"][1][0])
    onp.testing.assert_allclose(tseen["post"][2], jseen["post"][2],
                                rtol=TOL, atol=TOL)
    onp.testing.assert_array_equal(tseen["post"][2], out)


def test_hooks_fire_on_tensor_calls_and_inside_a_parent(data):
    """A child's hooks fire once per call, with the arguments as its caller
    passed them: NDArrays from a container called with NDArrays, tensors
    when it is called with tensors; torch's own hooks are not used."""
    x, w, b = data
    with CPU:
        child = _dense(nn, mt.nd.array(w), mt.nd.array(b))
        net = nn.HybridSequential()
        net.add(child)
        calls = []
        child.register_forward_pre_hook(
            lambda blk, args: calls.append(("pre", type(args[0]))))
        child.register_forward_hook(
            lambda blk, args, out: calls.append(("post", type(out))))
        out = net(mt.nd.array(x))
        direct = child(torch.from_numpy(x))
    assert calls == [("pre", mt.nd.NDArray), ("post", mt.nd.NDArray),
                     ("pre", torch.Tensor), ("post", torch.Tensor)]
    onp.testing.assert_array_equal(out.asnumpy(), direct.detach().numpy())
    assert not child._forward_hooks and not child._forward_pre_hooks
