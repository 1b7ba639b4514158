"""The port's NDArray and ``nd`` functions (mxnet_tpu_torch.nd) against the
JAX package's (mxnet_tpu.nd), both on the CPU, on the cases of
tests/test_ndarray.py that the rtc slice ports.

Each case builds the same arrays from the same numpy inputs in both
packages and returns named results; the port's must have the reference's
dtype (by name) and shape, and its values must be equal, except where a
case says otherwise: reductions, products and means within 1e-5 relative
(f32 sums in another order), and transcendental functions (exp, log, tanh,
sigmoid, sqrt) within 1e-6 relative (XLA's and PyTorch's f32
implementations round differently in the last bits). The samplers cannot
match JAX's threefry bits: they are tested for determinism per seed and for
their moments.
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

EXACT, SUMS, TRANSCENDENTAL = 0.0, 1e-5, 1e-6


def _values(a):
    v = onp.asarray(a.asnumpy())
    return v.astype(onp.float32) if str(a.dtype) == "bfloat16" else v


def _run(case, rtol):
    ref = case(mx.nd, mx.cpu())
    with mt.cpu():
        got = case(mt.nd, mt.cpu())
    assert list(ref) == list(got)
    for k in ref:
        r, g = ref[k], got[k]
        if not hasattr(r, "asnumpy"):
            assert g == r, k
            continue
        assert str(g.dtype) == str(r.dtype), (k, g.dtype, r.dtype)
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if rtol == EXACT:
            onp.testing.assert_array_equal(_values(g), _values(r), err_msg=k)
        else:
            onp.testing.assert_allclose(_values(g), _values(r), rtol=rtol,
                                        atol=rtol, err_msg=k)


def _rng(seed):
    return onp.random.RandomState(seed)


def case_creation(nd, ctx):
    r = _rng(0)
    return {
        "int_list": nd.array([[1, 2], [3, 4]], ctx=ctx),
        "float_list": nd.array([1.5, -2.0], ctx=ctx),
        "f64_ndarray": nd.array(r.randn(3).astype(onp.float64), ctx=ctx),
        "i64_ndarray": nd.array(onp.arange(4, dtype=onp.int64), ctx=ctx),
        "i32_ndarray": nd.array(onp.arange(4, dtype=onp.int32), ctx=ctx),
        "bool_ndarray": nd.array(onp.array([True, False]), ctx=ctx),
        "u8_ndarray": nd.array(onp.array([1, 200], onp.uint8), ctx=ctx),
        "as_bf16": nd.array([1.0, 2.5, 3.3], ctx=ctx, dtype="bfloat16"),
        "zeros": nd.zeros((3, 4), ctx=ctx),
        "ones_int": nd.ones((2, 3), ctx=ctx, dtype="int32"),
        "full": nd.full((2, 2), 7.0, ctx=ctx),
        "full_int": nd.full((2,), 7.5, ctx=ctx, dtype="int32"),
        "empty": nd.empty((2, 3), ctx=ctx),
        "arange": nd.arange(0, 10, 2, ctx=ctx),
        "arange_stop": nd.arange(5, ctx=ctx),
        "arange_repeat": nd.arange(0, 3, repeat=2, ctx=ctx),
        "arange_int": nd.arange(0, 5, ctx=ctx, dtype="int32"),
        "zeros_like": nd.zeros_like(nd.ones((2, 2), ctx=ctx, dtype="int32")),
        "ones_like": nd.ones_like(nd.zeros((3,), ctx=ctx)),
        "size": nd.zeros((3, 4), ctx=ctx).size,
        "ndim": nd.zeros((3, 4), ctx=ctx).ndim,
    }


def case_arithmetic(nd, ctx):
    r = _rng(1)
    a = nd.array(r.randn(2, 3).astype(onp.float32), ctx=ctx)
    b = nd.array(r.rand(2, 3).astype(onp.float32) + 0.5, ctx=ctx)
    row = nd.array(r.randn(3).astype(onp.float32), ctx=ctx)
    i = nd.array(onp.array([1, 2, 3, -7], onp.int32), ctx=ctx)
    j = nd.array(onp.array([2, 2, 2, 3], onp.int32), ctx=ctx)
    bf = a.astype("bfloat16")
    bo = nd.array(onp.array([True, False, True]), ctx=ctx)
    return {
        "add": a + b, "sub": a - b, "mul": a * b, "div": a / b,
        "broadcast": a * row, "add_scalar": a + 1, "rsub": 1 - a,
        "rmul": 2 * a, "rdiv": 2.0 / b, "pow": a ** 2, "rpow": 2 ** a,
        "mod": a % 0.75, "rmod": 1.5 % b, "neg": -a, "abs": abs(a),
        "int_div_int": i / j, "int_mod_int": i % j, "int_plus_1": i + 1,
        "int_div_2": i / 2, "int_pow_2": i ** 2, "int_neg": -i,
        "int_times_f32": i * nd.array(onp.float32([0.5, 1, 2, 3]), ctx=ctx),
        "bf16_times_scalar": bf * 0.1, "bf16_plus_f32": bf + a,
        "bf16_div_scalar": bf / 3.0,
        "bf16_times_int": bf[0] * nd.array(onp.int32([1, 2, 3]), ctx=ctx),
        "bool_plus_bool": bo + bo, "bool_times_bool": bo * bo,
        "bool_times_2": bo * 2, "bool_times_int": bo * i[:3],
        "plus_ndarray": a + onp.ones((2, 3), onp.float32),
    }


def case_inplace(nd, ctx):
    a = nd.ones((2, 2), ctx=ctx)
    out = {}
    a += 1
    out["iadd"] = a.copy()
    a *= 3
    out["imul"] = a.copy()
    a /= 2
    out["idiv"] = a.copy()
    a -= 0.5
    out["isub"] = a.copy()
    i = nd.array(onp.int32([1, 2]), ctx=ctx)
    i += 1                               # int += scalar becomes float32
    out["int_iadd"] = i
    return out


def case_comparisons(nd, ctx):
    a = nd.array([1.0, 2.0, 3.0], ctx=ctx)
    b = nd.array([2.0, 2.0, 2.0], ctx=ctx)
    i = nd.array(onp.int32([1, 2, 3]), ctx=ctx)
    bf = a.astype("bfloat16")
    bo = nd.array(onp.array([True, False, True]), ctx=ctx)
    return {"gt": a > b, "ge": a >= b, "eq": a == b, "ne": a != b,
            "lt": a < b, "le": a <= b, "gt_scalar": a > 1.5,
            "int_gt_int": i > nd.array(onp.int32([2, 2, 2]), ctx=ctx),
            # the scalar is cast to the array's dtype first: 2.5 -> 2
            "int_eq_float": i == 2.5, "bf16_gt": bf > 1,
            "bool_eq": bo == bo, "and": a.__and__(b - 2), "or": a | (b - 2),
            "xor": a ^ (b - 2), "not": ~bo}


def case_indexing(nd, ctx):
    a = nd.array(onp.arange(24).reshape(2, 3, 4), ctx=ctx)
    out = {"row": a[0], "pair": a[0, 1], "elem": a[1, 2, 3],
           "scalar": float(a[1, 2, 3].asscalar()), "slice": a[:, 1:3],
           "stride": a[0, :, ::2], "negative": a[-1, -2],
           "int_index": a[nd.array([0, 1], ctx=ctx, dtype="int32")],
           "float_index": a[nd.array([1, 0, 1], ctx=ctx)]}
    b = nd.zeros((3, 3), ctx=ctx)
    b[1, 1] = 5.0
    out["set_elem"] = b.copy()
    b[0] = nd.array([1.0, 2.0, 3.0], ctx=ctx)
    out["set_row"] = b.copy()
    b[:, 2] = 7.0
    out["set_column"] = b.copy()
    b[...] = 2.0
    out["set_all"] = b
    f = nd.array([1.0, 2.0, 3.0, 0.5], ctx=ctx)
    out["mask_get"] = f[f > 1.5]
    m = nd.array([[1.0, 2.0], [3.0, 4.0]], ctx=ctx)
    m[m > 2] = 0
    out["mask_set"] = m
    out["len"] = len(a)
    out["iter"] = [float(x.sum().asscalar()) for x in a]
    return out


def case_shapes(nd, ctx):
    a = nd.array(onp.arange(12).reshape(3, 4), ctx=ctx)
    b = nd.zeros((2, 3, 4), ctx=ctx)
    c = nd.array(onp.arange(24, dtype=onp.float32).reshape(2, 3, 4), ctx=ctx)
    return {"reshape": a.reshape(4, 3), "reshape_tuple": a.reshape((2, 6)),
            "reshape_kw": a.reshape(shape=(6, 2)), "flat": a.reshape(-1),
            "T": a.T, "transpose": a.transpose(),
            "transpose_axes": b.transpose(2, 0, 1),
            "transpose_values": c.transpose((1, 2, 0)),
            "swapaxes": c.swapaxes(0, 2), "flatten": c.flatten(),
            "expand_dims": c.expand_dims(0),
            "squeeze": nd.zeros((1, 2, 1), ctx=ctx).squeeze(),
            "squeeze_axis": nd.zeros((1, 2, 1), ctx=ctx).squeeze(axis=2),
            "broadcast_to": nd.array([1.0, 2.0], ctx=ctx).broadcast_to((3, 2)),
            "broadcast_zero": c[:, :1].broadcast_to((0, 5, 0)),
            "code_0": c.reshape(0, -1), "code_2": c.reshape(-2),
            "code_3": c.reshape(-3, 4), "code_4": c.reshape(-4, 1, 2, 3, 4)}


def case_reductions(nd, ctx):
    a = nd.array(_rng(2).randn(3, 4, 5).astype(onp.float32), ctx=ctx)
    i = nd.array(onp.arange(1, 7, dtype=onp.int32).reshape(2, 3), ctx=ctx)
    bo = nd.array(onp.array([True, False, True]), ctx=ctx)
    bf = a.astype("bfloat16")
    return {"sum": a.sum(), "sum0": a.sum(axis=0), "sum12": a.sum(axis=(1, 2)),
            "sum_keep": a.sum(axis=1, keepdims=True),
            "mean": a.mean(), "mean1": a.mean(axis=1),
            "max": a.max(), "max0": a.max(axis=0), "min1": a.min(axis=1),
            "min_keep": a.min(keepdims=True), "prod1": a.prod(axis=1),
            "prod": (a * 0.5 + 1).prod(), "argmax": a.argmax(),
            "argmax2": a.argmax(axis=2),
            "argmax_keep": a.argmax(axis=0, keepdims=True),
            "int_sum": i.sum(), "int_sum1": i.sum(axis=1), "int_mean": i.mean(),
            "int_max": i.max(), "int_prod": i.prod(), "bool_sum": bo.sum(),
            "bool_mean": bo.mean(), "bf16_sum": bf.sum(axis=2),
            "bf16_mean": bf.mean(axis=0)}


def case_dot(nd, ctx):
    r = _rng(3)
    a = nd.array(r.rand(3, 4).astype("f"), ctx=ctx)
    b = nd.array(r.rand(4, 5).astype("f"), ctx=ctx)
    c = nd.array(r.rand(2, 3, 4).astype("f"), ctx=ctx)
    v = nd.array(r.rand(4).astype("f"), ctx=ctx)
    return {"dot": nd.dot(a, b), "dot_ta": nd.dot(a.T, b.T, transpose_a=True,
                                                  transpose_b=True),
            "dot_tb": nd.dot(a, b.T, transpose_b=True),
            "vec": nd.dot(v, v), "mat_vec": nd.dot(a, v), "matmul": a @ b,
            "tensordot": nd.dot(c, b)}


def case_astype_copy(nd, ctx):
    a = nd.array([1.5, 2.5, -0.7], ctx=ctx)
    d = a.copy()
    d += 1
    e = nd.zeros((3,), ctx=ctx)
    a.copyto(e)
    e += 1
    return {"int32": a.astype("int32"), "bf16": a.astype("bfloat16"),
            "f16": a.astype("float16"), "bool": a.astype("bool"),
            "same": a.astype("float32"), "copy": d, "original": a,
            "copyto": e, "copyto_ctx": a.copyto(ctx),
            "int_to_f32": nd.array(onp.int32([3]), ctx=ctx).astype("float32")}


def case_unary(nd, ctx):
    r = _rng(4)
    x = nd.array(r.randn(4, 5).astype(onp.float32), ctx=ctx)
    p = nd.array(r.rand(4, 5).astype(onp.float32) + 0.1, ctx=ctx)
    i = nd.array(onp.int32([-2, 0, 3]), ctx=ctx)
    return {"relu": nd.relu(x), "square": nd.square(x), "abs": nd.abs(x),
            "clip": nd.clip(x, a_min=-0.5, a_max=0.5),
            "clip_int": nd.clip(i, a_min=-1.5, a_max=2.5),
            "int_relu": nd.relu(i), "int_square": nd.square(i),
            "where": nd.where(x > 0, x, p),
            "where_mixed": nd.where(nd.array([1.0, 0.0, 1.0], ctx=ctx),
                                    nd.array([1.0, 2.0, 3.0], ctx=ctx), i)}


def case_transcendental(nd, ctx):
    r = _rng(5)
    x = nd.array(r.randn(4, 5).astype(onp.float32), ctx=ctx)
    p = nd.array(r.rand(4, 5).astype(onp.float32) + 0.1, ctx=ctx)
    return {"sigmoid": nd.sigmoid(x), "exp": nd.exp(x), "log": nd.log(p),
            "tanh": nd.tanh(x), "sqrt": nd.sqrt(p),
            "int_exp": nd.exp(nd.array(onp.int32([0, 1, 2]), ctx=ctx))}


@pytest.mark.parametrize("case, rtol", [
    (case_creation, EXACT), (case_arithmetic, EXACT), (case_inplace, EXACT),
    (case_comparisons, EXACT), (case_indexing, EXACT), (case_shapes, EXACT),
    (case_reductions, SUMS), (case_dot, SUMS), (case_astype_copy, EXACT),
    (case_unary, EXACT), (case_transcendental, TRANSCENDENTAL)],
    ids=lambda v: v.__name__[5:] if callable(v) else None)
def test_port_matches_the_jax_package(case, rtol):
    _run(case, rtol)


def test_wait_and_context():
    a = mt.nd.ones((4, 4), ctx=mt.cpu())
    assert a.wait_to_read() is a
    assert a.context == mt.cpu() and a.ctx == mt.cpu(0)
    assert a.as_in_context(mt.cpu(0)) is a
    mt.nd.waitall()
    with mt.cpu():
        assert mt.nd.zeros((2,)).context == mt.cpu()


def test_default_context_is_the_card():
    """Without a ctx or a ``with cpu():`` scope an array is made on gpu(0),
    which raises on a host without CUDA rather than landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the default context works")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.nd.array([1.0])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.nd.zeros((2,))


def test_numpy_interop():
    with mt.cpu():
        a = mt.nd.array([[1.0, 2.0]])
        assert onp.asarray(a).shape == (1, 2)
        onp.testing.assert_array_equal(a + onp.array([[1.0, 1.0]]),
                                       [[2.0, 3.0]])
        # numpy defers to NDArray's reflected operator
        b = onp.array([[1.0, 1.0]], onp.float32) + a
        assert isinstance(b, mt.nd.NDArray)
        onp.testing.assert_array_equal(b.asnumpy(), [[2.0, 3.0]])
        assert a.sum().asscalar() == 3.0 and float(a[0, 1]) == 2.0
        assert a.sum().item() == 3.0
        with pytest.raises(MXNetError, match="not a scalar"):
            a.asscalar()
        with pytest.raises(MXNetError, match="ambiguous"):
            bool(a)


def test_bf16_reads_back_as_float32():
    with mt.cpu():
        a = mt.nd.array([1.0, 2.5], dtype="bfloat16")
    assert a.dtype == "bfloat16" and str(a.dtype) == "bfloat16"
    assert a.asnumpy().dtype == onp.float32
    assert a.data.dtype == torch.bfloat16


def test_samplers_are_deterministic_per_seed():
    ctx = mt.cpu()
    mt.random.seed(7)
    u = mt.nd.random.uniform(0, 1, shape=(100,), ctx=ctx).asnumpy()
    n = mt.nd.random.normal(shape=(5,), ctx=ctx).asnumpy()
    mt.random.seed(7)
    onp.testing.assert_array_equal(
        mt.nd.random.uniform(0, 1, shape=(100,), ctx=ctx).asnumpy(), u)
    onp.testing.assert_array_equal(
        mt.nd.random.normal(shape=(5,), ctx=ctx).asnumpy(), n)
    mt.random.seed(8)
    assert not onp.array_equal(
        mt.nd.random.uniform(0, 1, shape=(100,), ctx=ctx).asnumpy(), u)
    # seeding one context reseeds only its generator
    mt.random.seed(7)
    mt.nd.random.seed(3, ctx=ctx)
    a = mt.nd.random.uniform(shape=(4,), ctx=ctx).asnumpy()
    mt.random.seed(3, ctx=ctx)
    onp.testing.assert_array_equal(
        mt.random.uniform(shape=(4,), ctx=ctx).asnumpy(), a)


def test_sampler_moments_and_dtypes():
    ctx = mt.cpu()
    mt.random.seed(0)
    u = mt.nd.random.uniform(-1, 3, shape=(200000,), ctx=ctx)
    assert u.dtype == onp.float32 and u.shape == (200000,)
    un = u.asnumpy()
    assert un.min() >= -1 and un.max() < 3
    assert abs(un.mean() - 1.0) < 0.02 and abs(un.var() - 16 / 12) < 0.02
    g = mt.nd.random.normal(2.0, 0.5, shape=(400, 500), ctx=ctx).asnumpy()
    assert abs(g.mean() - 2.0) < 0.005 and abs(g.std() - 0.5) < 0.005
    r = mt.nd.random.randn(300, 400, ctx=ctx).asnumpy()
    assert abs(r.mean()) < 0.01 and abs(r.std() - 1.0) < 0.01
    b = mt.nd.random.normal(shape=(1000,), dtype="bfloat16", ctx=ctx)
    assert b.dtype == "bfloat16"
    k = mt.nd.random.randint(0, 10, shape=(50000,), ctx=ctx)
    assert k.dtype == onp.int32
    kn = k.asnumpy()
    assert kn.min() == 0 and kn.max() == 9 and abs(kn.mean() - 4.5) < 0.05
    assert mt.nd.random.randint(0, 5, ctx=ctx).shape == (1,)
    assert mt.nd.random.uniform(ctx=ctx).shape == ()
    out = mt.nd.zeros((3,), ctx=ctx)
    assert mt.nd.random.normal(shape=(3,), ctx=ctx, out=out) is out


def test_samplers_never_use_the_global_generator():
    torch.manual_seed(0)
    before = torch.get_rng_state()
    mt.nd.random.normal(shape=(10,), ctx=mt.cpu())
    mt.nd.random.randint(0, 3, shape=(10,), ctx=mt.cpu())
    assert torch.equal(torch.get_rng_state(), before)
