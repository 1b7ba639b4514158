"""The port's samplers (``ops/random_ops.py`` through ``nd.random``) on the
CPU: each gives the JAX package's dtype and shape for the same call, the
same numbers for the same seed and other numbers for another, and first
two moments within the stated bounds of the distribution's (about five
standard errors at the sample sizes drawn; ``tools/op_cases.py``, whose
table phase 9 of chip_smoke.py runs on the card). JAX's threefry bits cannot be
matched, so values are not compared across packages. No sampler touches
PyTorch's global generator."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.tools.op_cases import SAMPLER_CALLS, moment_errors

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

N = 200_000


def _calls(nd, ctx):
    # the JAX package's zipfian op takes its threefry key as an input
    return SAMPLER_CALLS(nd, ctx, key=(mx.random.take_key(),)
                         if nd is mx.nd else ())


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("name", sorted(_calls(mt.nd, mt.cpu())))
def test_sampler_dtype_shape_seed_and_moments(name):
    ref = _first(_calls(mx.nd, mx.cpu())[name](100))
    ctx = mt.cpu()
    mt.random.seed(11)
    with ctx:
        got = _first(_calls(mt.nd, ctx)[name](100))
        assert str(got.dtype) == str(ref.dtype), (got.dtype, ref.dtype)
        assert got.shape == ref.shape, (got.shape, ref.shape)
        mt.random.seed(11)
        again = _first(_calls(mt.nd, ctx)[name](100))
        onp.testing.assert_array_equal(again.asnumpy(), got.asnumpy())
        mt.random.seed(12)
        other = _first(_calls(mt.nd, ctx)[name](100))
        assert not onp.array_equal(other.asnumpy(), got.asnumpy())
        mt.random.seed(0)
        big = _first(_calls(mt.nd, ctx)[name](N)).asnumpy()
    assert not moment_errors(name, big), moment_errors(name, big)


def test_every_sampler_of_the_reference_is_tested():
    from mxnet_tpu.ops import registry
    ref = {n for n in registry.list_ops() if registry.get_op(n).fn.__module__
           == "mxnet_tpu.ops.random_ops"}
    assert ref == set(_calls(mt.nd, mt.cpu()))


def test_multinomial_get_prob_is_the_log_probability():
    ctx = mt.cpu()
    with ctx:
        p = mt.nd.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]])
        idx, lp = mt.nd.random.multinomial(p, shape=(50,), get_prob=True)
    want = onp.log(p.asnumpy())[onp.arange(2)[:, None],
                                idx.asnumpy().astype(int)]
    onp.testing.assert_allclose(lp.asnumpy(), want, rtol=1e-6)
    ref_idx, ref_lp = mx.nd.random.multinomial(
        mx.nd.array(p.asnumpy()), shape=(50,), get_prob=True)
    assert (idx.shape, str(idx.dtype), lp.shape, str(lp.dtype)) == \
        (ref_idx.shape, str(ref_idx.dtype), ref_lp.shape, str(ref_lp.dtype))


@pytest.mark.parametrize("sampler", ["uniform_like", "normal_like",
                                     "gamma_like", "exponential_like",
                                     "poisson_like", "negative_binomial_like",
                                     "generalized_negative_binomial_like"])
def test_like_samplers_take_shape_and_context(sampler):
    with mt.cpu():
        data = mt.nd.zeros((3, 4))
        out = getattr(mt.nd.random, sampler)(data)
    ref = getattr(mx.nd.random, sampler)(mx.nd.zeros((3, 4)))
    assert out.shape == (3, 4) and out.context == mt.cpu()
    assert str(out.dtype) == str(ref.dtype)


def test_samplers_never_use_the_global_generator():
    torch.manual_seed(0)
    before = torch.get_rng_state()
    with mt.cpu():
        for call in _calls(mt.nd, mt.cpu()).values():
            call(64)
    assert torch.equal(torch.get_rng_state(), before)


def test_dropout_draws_from_the_context_generator():
    with mt.cpu():
        x = mt.nd.ones((20000,))
        mt.random.seed(5)
        with mt.autograd.train_mode():
            a = mt.nd.Dropout(x, p=0.25).asnumpy()
        mt.random.seed(5)
        with mt.autograd.train_mode():
            b = mt.nd.Dropout(x, p=0.25).asnumpy()
        with mt.autograd.train_mode():
            shared = mt.nd.Dropout(mt.nd.ones((4, 500)), p=0.5,
                                   axes=(0,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    onp.testing.assert_allclose(a[a != 0], 1 / 0.75, rtol=1e-7)
    assert abs((a == 0).mean() - 0.25) < 5 * (0.25 * 0.75 / a.size) ** 0.5
    assert (shared == shared[:1]).all()
