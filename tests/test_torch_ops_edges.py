"""The edge matrices of tests/test_operator_edges.py (zero-size shapes,
negative axes, broadcast corners, bf16/f16 and integer dtypes, the cast
matrix, zero-batch layers) run through the port's ``nd`` and the JAX
package's on the CPU, from the same seeded numpy inputs, at the
tolerances of test_torch_ops.py (``tools/op_cases.py``)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.tools.op_cases import (BF16, EXACT, SUMS,
                                            TRANSCENDENTAL, differences,
                                            f32, i32)

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))


def _run(case, tol):
    ref = case(mx.nd, mx.cpu())
    with mt.cpu():
        got = case(mt.nd, mt.cpu())
    diff = differences(ref, got, tol)
    assert not diff, diff


def _r(seed):
    return onp.random.RandomState(seed)


# ---------------------------------------------------------------------------
# the edge matrices of tests/test_operator_edges.py, through both packages
# ---------------------------------------------------------------------------
EDGE_UNARY = ["relu", "sigmoid", "softsign", "exp", "expm1", "log", "log1p",
              "log2", "log10", "sqrt", "rsqrt", "cbrt", "square",
              "reciprocal", "negative", "abs", "sign", "floor", "ceil",
              "trunc", "rint", "sin", "cos", "tan", "arcsin", "arccos",
              "arctan", "sinh", "cosh", "tanh", "arcsinh", "arctanh", "erf",
              "gammaln", "gelu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op", EDGE_UNARY)
def test_edge_unary_dtype_and_zero_size(op, dtype):
    def fn(nd, ctx):
        x = _r(0).uniform(0.25, 2.0, (3, 4)).astype(onp.float32)
        if op in ("arcsin", "arccos", "arctanh"):
            x = x / 3
        f = getattr(nd, op)
        return {"x": f(nd.array(x, ctx=ctx, dtype=dtype)),
                "zero": f(nd.array(onp.zeros((0, 4), onp.float32), ctx=ctx,
                                   dtype=dtype)),
                "degenerate": f(nd.array(x[:1, :1], ctx=ctx, dtype=dtype))}
    _run(fn, TRANSCENDENTAL if dtype == "float32" else BF16)


EDGE_SHAPES = [((2, 1, 3), (1, 4, 1)), ((0, 3), (1, 3)), ((4, 1), (1, 0)),
               ((1,), (5,)), ((2, 3), (2, 3))]
EDGE_BINARY = ["broadcast_add", "broadcast_sub", "broadcast_mul",
               "broadcast_div", "broadcast_maximum", "broadcast_minimum",
               "broadcast_power", "broadcast_equal", "broadcast_greater",
               "broadcast_lesser_equal"]


@pytest.mark.parametrize("shapes", EDGE_SHAPES,
                         ids=[f"{a}x{b}" for a, b in EDGE_SHAPES])
@pytest.mark.parametrize("op", EDGE_BINARY)
def test_edge_binary_broadcast_corners(op, shapes):
    def fn(nd, ctx):
        a = _r(1).uniform(0.25, 2.0, shapes[0]).astype(onp.float32)
        b = _r(2).uniform(0.25, 2.0, shapes[1]).astype(onp.float32)
        return {"x": getattr(nd, op)(nd.array(a, ctx=ctx),
                                     nd.array(b, ctx=ctx))}
    _run(fn, TRANSCENDENTAL)


EDGE_AXES = [None, 0, -1, (0, 2), 1]


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", EDGE_AXES, ids=[str(a) for a in EDGE_AXES])
@pytest.mark.parametrize("op", ["sum", "mean", "prod", "max", "min",
                                "nansum", "nanprod"])
def test_edge_reduction_axes(op, axis, keepdims):
    def fn(nd, ctx):
        x = _r(3).uniform(-2.0, 2.0, (2, 3, 4)).astype(onp.float32)
        X = nd.array(x, ctx=ctx)
        out = {"x": getattr(nd, op)(X, axis=axis, keepdims=keepdims)}
        if op in ("sum", "mean", "prod", "nansum") and axis == 1:
            out["zero_axis"] = getattr(nd, op)(
                nd.array(onp.zeros((3, 0, 2), onp.float32), ctx=ctx), axis=1)
        return out
    _run(fn, SUMS)


@pytest.mark.parametrize("op", ["concat", "stack", "softmax", "log_softmax",
                                "expand_dims", "reverse", "repeat", "cumsum",
                                "take", "split"])
def test_edge_negative_axis(op):
    def fn(nd, ctx):
        x = nd.array(_r(5).randn(2, 3, 4).astype(onp.float32), ctx=ctx)
        calls = {
            "concat": lambda ax: nd.concat(x, x, dim=ax),
            "stack": lambda ax: nd.stack(x, x, axis=ax),
            "softmax": lambda ax: nd.softmax(x, axis=ax),
            "log_softmax": lambda ax: nd.log_softmax(x, axis=ax),
            "expand_dims": lambda ax: nd.expand_dims(x, axis=ax),
            "reverse": lambda ax: nd.reverse(x, axis=ax),
            "repeat": lambda ax: nd.repeat(x, repeats=2, axis=ax),
            "cumsum": lambda ax: nd.cumsum(x, axis=ax),
            "take": lambda ax: nd.take(x, nd.array(f32([1, 0]), ctx=ctx),
                                       axis=ax),
            "split": lambda ax: nd.split(x, num_outputs=2, axis=ax)[0]}
        return {str(ax): calls[op](ax) for ax in (-1, 2, -3, 0)}
    _run(fn, TRANSCENDENTAL)


CAST_DTYPES = ["float32", "float16", "bfloat16", "int32", "int8", "uint8",
               "bool"]


@pytest.mark.parametrize("dst", CAST_DTYPES)
@pytest.mark.parametrize("src", CAST_DTYPES)
def test_edge_cast_matrix(src, dst):
    def fn(nd, ctx):
        x = nd.array(f32([0, 1, 2, 3, 100]), ctx=ctx, dtype=src)
        return {"x": nd.cast(x, dtype=dst)}
    _run(fn, EXACT)


@pytest.mark.parametrize("dtype", ["int32", "int8"])
@pytest.mark.parametrize("op", ["abs", "sign", "clip"])
def test_edge_int_elemwise(op, dtype):
    def fn(nd, ctx):
        x = nd.array(i32([-3, -1, 0, 2, 5]), ctx=ctx, dtype=dtype)
        if op == "clip":
            return {"x": nd.clip(x, a_min=-2, a_max=3)}
        return {"x": getattr(nd, op)(x)}
    _run(fn, EXACT)


def test_edge_zero_batch_layers():
    def fn(nd, ctx):
        x = nd.zeros((0, 3, 5, 5), ctx=ctx)
        return {
            "fc": nd.FullyConnected(nd.zeros((0, 4), ctx=ctx),
                                    nd.ones((2, 4), ctx=ctx), None,
                                    num_hidden=2, no_bias=True),
            "conv": nd.Convolution(x, nd.ones((2, 3, 3, 3), ctx=ctx), None,
                                   kernel=(3, 3), num_filter=2,
                                   no_bias=True),
            "pool": nd.Pooling(x, kernel=(2, 2), pool_type="avg"),
            "act": nd.Activation(x, act_type="relu"),
            "bn": nd.BatchNorm(x, nd.ones((3,), ctx=ctx),
                               nd.zeros((3,), ctx=ctx),
                               nd.zeros((3,), ctx=ctx),
                               nd.ones((3,), ctx=ctx))}
    _run(fn, SUMS)
