"""The port's operator registry and ``nd`` surface (mxnet_tpu_torch) against
the JAX package's (mxnet_tpu), both on the CPU: one case per registered op
of ``mxnet_tpu/ops/{elemwise,tensor,nn,contrib}.py`` and the two registry
ops of ``mxnet_tpu/ops/pallas/flash_attention.py`` (the samplers of
``random_ops.py`` are held to their moments in test_torch_random_ops.py)
and a coverage test over the reference's registry; the edge matrices of
tests/test_operator_edges.py are in test_torch_ops_edges.py.

Each case builds the same arrays from the same seeded numpy inputs in both
packages and returns named results; the port's must have the reference's
dtype (by name) and shape, and values within the case's tolerance: EXACT
for data movement, indexing and ordering (sorts get tie-free inputs),
SUMS (1e-5 relative) for sums and products, TRANSCENDENTAL (1e-6
relative) for the f32 transcendental functions, BF16 (one bf16 ulp near 1,
2^-7) for bf16/f16 results, each also as an absolute bound near zero.
The cases are the table of ``mxnet_tpu_torch/tools/op_cases.py`` (which
phase 9 of chip_smoke.py runs on the card against the CPU), with two
reference-side exceptions written here: the reference's ``Deconvolution`` applies its kernel with in and out
swapped, so its side is the gradient of its Convolution, and BatchNorm's
training mode takes each package's ``autograd``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jax_registry
from mxnet_tpu_torch.ops import registry as port_registry
from mxnet_tpu_torch.tools import op_cases
from mxnet_tpu_torch.tools.op_cases import CASES, SUMS, differences

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

# not ported yet (ROADMAP Queue 1): none since SyncBatchNorm landed with
# the multi-process slice
DEFERRED = set()
# held to their moments and determinism in test_torch_random_ops.py
SAMPLERS = {
    "_random_uniform", "_random_normal", "_random_gamma",
    "_random_exponential", "_random_poisson", "_random_negative_binomial",
    "_random_generalized_negative_binomial", "_random_randint",
    "_random_bernoulli", "_random_dirichlet", "_sample_multinomial",
    "_shuffle", "_sample_unique_zipfian", "_sample_uniform",
    "_sample_normal", "_sample_gamma", "_sample_exponential",
    "_sample_poisson", "_sample_negative_binomial",
    "_sample_generalized_negative_binomial"}
# the reference exposes these through nd.random, not as nd functions
_ND_RANDOM = {"_random_uniform": "uniform", "_random_normal": "normal",
              "_random_gamma": "gamma", "_random_exponential": "exponential",
              "_random_poisson": "poisson",
              "_random_negative_binomial": "negative_binomial",
              "_random_generalized_negative_binomial":
                  "generalized_negative_binomial",
              "_random_randint": "randint", "_random_bernoulli": "bernoulli",
              "_random_dirichlet": "dirichlet", "_shuffle": "shuffle"}
FAMILIES = ("mxnet_tpu.ops.elemwise", "mxnet_tpu.ops.tensor",
            "mxnet_tpu.ops.nn", "mxnet_tpu.ops.random_ops",
            "mxnet_tpu.ops.contrib", "mxnet_tpu.ops.pallas.flash_attention",
            "mxnet_tpu.ops.optimizer_ops", "mxnet_tpu.ops.image_ops")

def _run(case, tol, ref_nd=None):
    ref = case(ref_nd or mx.nd, mx.cpu())
    with mt.cpu():
        got = case(mt.nd, mt.cpu())
    diff = differences(ref, got, tol)
    assert not diff, diff


f32, i32 = op_cases.f32, op_cases.i32
_x234, _m = op_cases._x234, op_cases._m


def _deconv_by_conv_grad(x, w, b, kernel, stride=None, pad=None, adj=None,
                         dilate=None, num_group=1, **_):
    """The reference's transposed convolution of ``x`` by ``w`` (in_c,
    out_c / g, *k) as the gradient of its Convolution (num_filter = in_c)
    with respect to the input (the reference's own Deconvolution applies
    the kernel with in and out swapped; ROADMAP Queue 3)."""
    nd_ = len(kernel)
    s = stride or (1,) * nd_
    p = pad or (0,) * nd_
    a = adj or (0,) * nd_
    d = dilate or (1,) * nd_
    w_np = w.asnumpy()
    out_c = w_np.shape[1] * num_group
    sp = [(x.shape[2 + i] - 1) * s[i] - 2 * p[i] + d[i] * (kernel[i] - 1) +
          a[i] + 1 for i in range(nd_)]
    z = mx.nd.zeros((x.shape[0], out_c) + tuple(sp))
    z.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Convolution(z, w, None, kernel=kernel, stride=s, pad=p,
                              dilate=d, num_filter=w_np.shape[0],
                              num_group=num_group, no_bias=True)
    y.backward(x)
    out = z.grad
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * nd_)
    return out


class _ReferenceDeconvolution:
    """mx.nd with Deconvolution computed as its Convolution's gradient."""

    Deconvolution = staticmethod(_deconv_by_conv_grad)

    def __getattr__(self, name):
        return getattr(mx.nd, name)


REFERENCE_SIDE = {"Deconvolution": _ReferenceDeconvolution()}


def test_batchnorm_training_mode_writes_back_the_moving_stats():
    def fn(nd, ctx, autograd):
        x, g, b, mm, mv = op_cases._bn_args(nd, ctx)
        with autograd.train_mode():
            out = nd.BatchNorm(x, g, b, mm, mv, fix_gamma=False,
                               momentum=0.8)
        return {"out": out, "moving_mean": mm, "moving_var": mv}
    ref = fn(mx.nd, mx.cpu(), mx.autograd)
    with mt.cpu():
        got = fn(mt.nd, mt.cpu(), mt.autograd)
    assert not differences(ref, got, SUMS)


def test_arange_like_without_axis_counts_every_element():
    """The reference's arange_like without an axis fails under its jit
    (it takes int() of a traced size; ROADMAP Queue 3); the port gives
    start + step * arange over every element, in x's shape."""
    with mt.cpu():
        x = mt.nd.zeros((2, 3))
        got = mt.nd.arange_like(x, start=1.0, step=0.5).asnumpy()
    onp.testing.assert_array_equal(
        got, (1.0 + 0.5 * onp.arange(6, dtype=onp.float32)).reshape(2, 3))
    with pytest.raises(Exception, match="concrete value"):
        mx.nd.arange_like(mx.nd.zeros((2, 3)))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", sorted(CASES))
def test_op_matches_the_jax_package(op):
    fn, tol = CASES[op]
    _run(fn, tol, REFERENCE_SIDE.get(op))


def _reference_ops():
    return {n for n in jax_registry.list_ops()
            if jax_registry.get_op(n).fn.__module__ in FAMILIES}


def test_every_reference_op_is_ported_or_named_deferred():
    """Every op of the reference's six families is in the port's registry
    and reachable from ``mt.nd`` (the samplers through ``nd.random``), and
    has a parity case here or a sampler test, except the named deferred
    list."""
    ref = _reference_ops()
    assert DEFERRED <= ref
    ported = set(port_registry.list_ops())
    missing = sorted(ref - DEFERRED - ported)
    assert not missing, missing
    assert not (ported & DEFERRED)
    for name in sorted(ref - DEFERRED):
        if name in _ND_RANDOM:
            assert hasattr(mt.nd.random, _ND_RANDOM[name]), name
        else:
            assert callable(getattr(mt.nd, name, None)), name
    untested = sorted(ref - DEFERRED - SAMPLERS - set(CASES))
    assert not untested, untested
    assert SAMPLERS <= ref


def test_port_registers_nothing_beyond_the_reference():
    ref = {n for n in jax_registry.list_ops()}
    assert set(port_registry.list_ops()) <= ref


@pytest.mark.parametrize("legacy", [
    "SequenceMask", "SequenceLast", "SequenceReverse", "RNN", "Cast",
    "SwapAxis", "Concat", "SliceChannel", "Flatten", "Reshape", "LeakyReLU",
    "Pad", "stop_gradient", "ElementWiseSum", "BatchNorm", "Dropout",
    "linspace", "eye", "full_like", "multi_sum_sq", "all_finite"])
def test_hand_written_and_legacy_names_exist(legacy):
    assert callable(getattr(mt.nd, legacy)), legacy
    assert callable(getattr(mx.nd, legacy)), legacy


def case_legacy_wrappers(nd, ctx):
    x = _x234(nd, ctx)
    return {"Cast": nd.Cast(x, "int32"), "SwapAxis": nd.SwapAxis(
                x, dim1=0, dim2=1),
            "Concat": nd.Concat(x, x, dim=0),
            "SliceChannel": nd.SliceChannel(x, num_outputs=3),
            "Flatten": nd.Flatten(x), "Reshape": nd.Reshape(x, shape=(-1,)),
            "LeakyReLU": nd.LeakyReLU(x, slope=0.2),
            "Pad": nd.Pad(nd.expand_dims(x, axis=0), mode="constant",
                          pad_width=(0, 0, 0, 0, 1, 1, 0, 1)),
            "stop_gradient": nd.stop_gradient(x),
            "ElementWiseSum": nd.ElementWiseSum(x, x),
            "linspace": nd.linspace(0, 1, 7, ctx=ctx),
            "linspace_open": nd.linspace(-1, 2, 6, endpoint=False, ctx=ctx),
            "eye": nd.eye(3, 4, 1, ctx=ctx),
            "full_like": nd.full_like(nd.array(i32([1, 2]), ctx=ctx), 2.5),
            "multi_sum_sq": nd.multi_sum_sq(x, x * 2),
            "all_finite": nd.all_finite(x, x),
            "not_finite": nd.all_finite(x, nd.array(f32([1, onp.inf]),
                                                    ctx=ctx))}


def test_legacy_wrappers_match_the_jax_package():
    _run(case_legacy_wrappers, SUMS)
