"""One call of every registered op, written against a generic ``nd``
module: the op-surface table that ``tests/test_torch_ops.py`` runs
through the port and the JAX package on the CPU, and that phase 9 of
``chip_smoke.py`` runs through the port on the card and on the CPU.

``CASES`` maps an op's name to ``(case, tol)``: ``case(nd, ctx)`` builds
its inputs from seeded numpy arrays on ``ctx`` and returns named results
(one op per case, several calls of it); ``tol`` is its class: EXACT for
data movement, indexing and ordering (sorts get tie-free inputs: a
permutation of distinct values), SUMS (1e-5 relative) for sums and
products, TRANSCENDENTAL (1e-6 relative) for f32 transcendental functions,
F32_ULPS (2^-21: four float32 ulps near 1, relative and absolute) where
the reference's jitted op divides by a constant as a product with its
reciprocal fused into a multiply-add, and the port rounds each operation
as the reference's function does;
bf16/f16 results of a non-exact case take BF16 (2^-7, one bf16 ulp near
1). Each tolerance is also the absolute bound near zero.
:func:`differences` compares two runs' results by those rules.

``SAMPLER_CALLS`` and ``MOMENTS`` are the samplers' table: one call of
each (``nd.random``, the ``_sample_*`` forms) and the first two moments
their draws must show; :func:`moment_errors` checks draws against them.
"""
from __future__ import annotations

import numpy as onp

from ..ops.nn import rnn_param_size

__all__ = ["EXACT", "SUMS", "TRANSCENDENTAL", "BF16", "F32_ULPS", "CASES",
           "differences", "well_posed", "detection_problems", "SAMPLER_CALLS", "MOMENTS", "moment_errors"]

EXACT, SUMS, TRANSCENDENTAL, BF16 = 0.0, 1e-5, 1e-6, 2.0 ** -7
F32_ULPS = 2.0 ** -21


def _values(a):
    v = onp.asarray(a.asnumpy())
    return v.astype(onp.float64) if v.dtype.kind in "fc" or \
        str(a.dtype) == "bfloat16" else v


def _flat(results):
    out = {}
    for k, v in results.items():
        if isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                out[f"{k}[{i}]"] = x
        else:
            out[k] = v
    return out


def differences(ref, got, tol):
    """The results of ``got`` that differ from ``ref``'s (dtype by name,
    shape, values within ``tol`` relative and absolute), as messages;
    empty when they agree."""
    ref, got = _flat(ref), _flat(got)
    if list(ref) != list(got):
        return [f"result names {list(got)} != {list(ref)}"]
    out = []
    for k in ref:
        r, g = ref[k], got[k]
        if not hasattr(r, "asnumpy"):
            if g != r:
                out.append(f"{k}: {g!r} != {r!r}")
            continue
        if str(g.dtype) != str(r.dtype) or g.shape != r.shape:
            out.append(f"{k}: {g.dtype}{g.shape} != {r.dtype}{r.shape}")
            continue
        t = BF16 if str(r.dtype) in ("bfloat16", "float16") and tol else tol
        gv, rv = _values(g), _values(r)
        if t == EXACT:
            ok = onp.array_equal(gv, rv, equal_nan=gv.dtype.kind == "f")
        else:
            ok = onp.allclose(gv, rv, rtol=t, atol=t, equal_nan=True)
        if not ok:
            err = onp.nanmax(onp.abs(gv - rv)) if gv.size else 0.0
            out.append(f"{k}: max |d| {err:.3g} (tol {t})")
    return out


def _r(seed):
    return onp.random.RandomState(seed)


def f32(a):
    return onp.asarray(a, onp.float32)


def i32(a):
    return onp.asarray(a, onp.int32)


CASES = {}


def case(name, tol=EXACT):
    def deco(fn):
        CASES[name] = (fn, tol)
        return fn
    return deco


# ---------------------------------------------------------------------------
# elementwise: unary
# ---------------------------------------------------------------------------
_RANGE = {  # op: (low, high) of its f32 input
    "log": (0.25, 3), "log2": (0.25, 3), "log10": (0.25, 3),
    "sqrt": (0.25, 3), "rsqrt": (0.25, 3), "rcbrt": (0.25, 3),
    "reciprocal": (0.25, 3), "gamma": (0.5, 3), "gammaln": (0.5, 3),
    "digamma": (0.5, 3), "log1p": (-0.5, 2), "arcsin": (-0.9, 0.9),
    "arccos": (-0.9, 0.9), "arctanh": (-0.9, 0.9), "erfinv": (-0.9, 0.9),
    "erf_inv": (-0.9, 0.9), "arccosh": (1.1, 3)}
_EXACT_UNARY = {"identity", "negative", "abs", "sign", "square", "relu",
                "floor", "ceil", "round", "rint", "trunc", "fix",
                "logical_not", "isnan", "isinf", "isfinite"}
_INT_UNARY = _EXACT_UNARY | {"exp", "sqrt", "log", "sin", "tanh", "erf",
                             "gelu", "cbrt", "reciprocal", "degrees"}
_UNARY = ["identity", "negative", "abs", "sign", "exp", "expm1", "log",
          "log2", "log10", "log1p", "sqrt", "rsqrt", "cbrt", "rcbrt",
          "square", "reciprocal", "sin", "cos", "tan", "arcsin", "arccos",
          "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
          "erf", "erfinv", "gamma", "gammaln", "digamma", "floor", "ceil",
          "round", "rint", "trunc", "fix", "logical_not", "isnan", "isinf",
          "isfinite", "relu", "sigmoid", "softsign", "softrelu", "gelu",
          "gelu_tanh", "silu", "mish", "hard_sigmoid", "erf_inv", "degrees",
          "radians"]
_TIES = f32([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -1.51, 3.7, -0.0, 2.0,
             -3.2])
_SPECIAL = f32([0.0, 1.0, -2.0, onp.nan, onp.inf, -onp.inf])


def _unary_case(name):
    lo, hi = _RANGE.get(name, (-3, 3))

    def fn(nd, ctx):
        x = _r(1).uniform(lo, hi, (3, 4)).astype(onp.float32)
        f = getattr(nd, name)
        out = {"f32": f(nd.array(x, ctx=ctx)),
               "bf16": f(nd.array(x, ctx=ctx, dtype="bfloat16")),
               "f16": f(nd.array(x, ctx=ctx, dtype="float16")),
               "zero_size": f(nd.array(onp.zeros((0, 3), onp.float32),
                                       ctx=ctx))}
        if name in ("floor", "ceil", "round", "rint", "trunc", "fix",
                    "sign", "abs"):
            out["ties"] = f(nd.array(_TIES, ctx=ctx))
        if name in ("isnan", "isinf", "isfinite", "logical_not", "relu",
                    "abs", "sign", "negative"):
            out["special"] = f(nd.array(_SPECIAL, ctx=ctx))
        if name in _INT_UNARY:
            out["int"] = f(nd.array(i32([0, 1, 2, 5, 7, 3]), ctx=ctx))
        return out
    return fn


for _name in _UNARY:
    case(_name, EXACT if _name in _EXACT_UNARY else TRANSCENDENTAL)(
        _unary_case(_name))


@case("zeros_like")
def _(nd, ctx):
    return {"f": nd.zeros_like(nd.array(f32([[1, 2]]), ctx=ctx)),
            "i": nd.zeros_like(nd.array(i32([1, 2]), ctx=ctx))}


@case("ones_like")
def _(nd, ctx):
    return {"f": nd.ones_like(nd.array(f32([[1, 2]]), ctx=ctx)),
            "bf": nd.ones_like(nd.array(f32([1, 2]), ctx=ctx,
                                        dtype="bfloat16"))}


@case("clip")
def _(nd, ctx):
    x = nd.array(_r(2).randn(3, 4).astype(onp.float32), ctx=ctx)
    i = nd.array(i32([-3, -1, 0, 2, 4]), ctx=ctx)
    return {"both": nd.clip(x, a_min=-0.5, a_max=0.5),
            "low": nd.clip(x, a_min=0.0), "int": nd.clip(i, a_min=-1.5,
                                                           a_max=2.5)}


@case("cast")
def _(nd, ctx):
    x = nd.array(f32([-2.7, -0.5, 0.0, 1.5, 3.9]), ctx=ctx)
    return {"int": nd.cast(x, dtype="int32"), "bf": nd.cast(x, "bfloat16"),
            "f16": nd.cast(x, dtype="float16"),
            "back": nd.cast(nd.array(i32([1, 2]), ctx=ctx), "float32")}


@case("amp_cast")
def _(nd, ctx):
    return {"f": nd.amp_cast(nd.array(f32([1.1, 2]), ctx=ctx),
                             dtype="float16"),
            "i": nd.amp_cast(nd.array(i32([1, 2]), ctx=ctx),
                             dtype="float16")}


@case("amp_multicast")
def _(nd, ctx):
    a = nd.array(f32([1.1, 2]), ctx=ctx, dtype="float16")
    b = nd.array(f32([3.3, 4]), ctx=ctx)
    c = nd.array(i32([1, 2]), ctx=ctx)
    return {"wide": nd.amp_multicast(a, b, c, num_outputs=3),
            "narrow": nd.amp_multicast(a, b, num_outputs=2,
                                       cast_narrow=True)}


@case("leaky_relu", TRANSCENDENTAL)
def _(nd, ctx):
    x = nd.array(_r(3).randn(3, 4).astype(onp.float32) * 2, ctx=ctx)
    return {t: nd.leaky_relu(x, act_type=t, slope=0.3)
            for t in ("leaky", "elu", "selu", "gelu", "rrelu")}


@case("prelu")
def _(nd, ctx):
    x = nd.array(_r(4).randn(2, 3, 4).astype(onp.float32), ctx=ctx)
    g = nd.array(f32([0.1, 0.2, 0.3]), ctx=ctx)
    return {"nc": nd.prelu(x, g)}


# ---------------------------------------------------------------------------
# elementwise: scalar and broadcast binary ops
# ---------------------------------------------------------------------------
_SCALAR = ["_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
           "_mod_scalar", "_power_scalar", "_maximum_scalar",
           "_minimum_scalar", "_hypot_scalar"]


def _scalar_case(name):
    def fn(nd, ctx):
        f = getattr(nd, name)
        x = nd.array(_r(5).uniform(0.5, 2, (3, 4)).astype(onp.float32),
                     ctx=ctx)
        i = nd.array(i32([1, 2, 3, 4]), ctx=ctx)
        return {"f": f(x, scalar=1.5), "rev": f(x, scalar=1.5, reverse=True),
                "bf": f(x.astype("bfloat16"), scalar=0.7),
                "int_float": f(i, scalar=2.5), "int_int": f(i, scalar=2),
                "int_rev": f(i, scalar=3, reverse=True)}
    return fn


for _name in _SCALAR:
    case(_name, TRANSCENDENTAL)(_scalar_case(_name))

_BINARY = ["broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
           "broadcast_mod", "broadcast_power", "broadcast_maximum",
           "broadcast_minimum", "broadcast_hypot", "broadcast_equal",
           "broadcast_not_equal", "broadcast_greater",
           "broadcast_greater_equal", "broadcast_lesser",
           "broadcast_lesser_equal", "broadcast_logical_and",
           "broadcast_logical_or", "broadcast_logical_xor", "elemwise_add",
           "elemwise_sub", "elemwise_mul", "elemwise_div", "maximum",
           "minimum", "hypot", "arctan2", "ldexp"]
_POSITIVE_B = {"broadcast_div", "broadcast_mod", "elemwise_div"}


def _binary_case(name):
    def fn(nd, ctx):
        r = _r(6)
        f = getattr(nd, name)
        if "power" in name:
            a = r.uniform(0.5, 2, (3, 4))
        elif any(k in name for k in ("equal", "greater", "lesser",
                                     "logical")):
            a = r.randint(-2, 3, (3, 4))
        else:
            a = r.randn(3, 4) * 2
        if name in _POSITIVE_B:
            b = r.uniform(0.5, 2, (1, 4)) * onp.array([1, -1, 1, -1])
        elif name == "ldexp":
            b = r.randint(-3, 4, (1, 4))
        elif any(k in name for k in ("equal", "greater", "lesser",
                                     "logical")):
            b = r.randint(-2, 3, (1, 4))
        else:
            b = r.randn(1, 4)
        A = nd.array(f32(a), ctx=ctx)
        B = nd.array(f32(b), ctx=ctx)
        out = {"f32": f(A, B), "bf16": f(A.astype("bfloat16"),
                                         B.astype("bfloat16")),
               "corner": f(nd.array(f32(onp.ones((2, 1, 3))), ctx=ctx),
                           nd.array(f32(onp.full((1, 4, 1), 2.0)), ctx=ctx)),
               "zero_size": f(nd.array(onp.zeros((0, 3), onp.float32),
                                       ctx=ctx),
                              nd.array(f32(onp.ones((1, 3))), ctx=ctx))}
        if name not in ("broadcast_hypot", "hypot", "arctan2", "ldexp"):
            ia = nd.array(i32([[1, -2, 3, 4], [5, 6, -7, 0]]), ctx=ctx)
            ib = nd.array(i32([[2, 2, 3, 1]]), ctx=ctx)
            out["int"] = f(ia, ib)
        if name in ("broadcast_add", "broadcast_mul", "broadcast_div"):
            out["int_f32"] = f(nd.array(i32([1, 2, 3, 4]), ctx=ctx),
                               nd.array(f32([0.5, 1, 2, 3]), ctx=ctx))
            out["bf16_f32"] = f(A.astype("bfloat16"), B)
        return out
    return fn


for _name in _BINARY:
    case(_name, TRANSCENDENTAL)(_binary_case(_name))


@case("add_n", SUMS)
def _(nd, ctx):
    xs = [nd.array(_r(s).randn(2, 3).astype(onp.float32), ctx=ctx)
          for s in range(3)]
    return {"three": nd.add_n(*xs), "list": nd.add_n(xs[:2])}


@case("smooth_l1", TRANSCENDENTAL)
def _(nd, ctx):
    x = nd.array(_r(7).randn(3, 4).astype(onp.float32) * 2, ctx=ctx)
    return {"1": nd.smooth_l1(x, scalar=1.0), "2": nd.smooth_l1(x, scalar=2.0)}


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _reduce_case(name):
    def fn(nd, ctx):
        f = getattr(nd, name)
        x = _r(8).randn(2, 3, 4).astype(onp.float32)
        if name.startswith("nan"):
            x[0, 1, 2] = onp.nan
        X = nd.array(x, ctx=ctx)
        out = {"all": f(X), "ax1": f(X, axis=1), "keep": f(X, axis=-1,
                                                         keepdims=True),
               "tuple": f(X, axis=(0, 2)),
               "exclude": f(X, axis=1, exclude=True),
               "bf16": f(X.astype("bfloat16"), axis=2)}
        if name not in ("max", "min"):       # no identity: both raise
            out["zero_size"] = f(nd.array(onp.zeros((3, 0, 2), onp.float32),
                                          ctx=ctx), axis=1)
        if not name.startswith("nan"):
            out["int"] = f(nd.array(i32([[1, -2, 3], [4, 5, 6]]), ctx=ctx),
                           axis=1)
        return out
    return fn


for _name in ["sum", "mean", "prod", "max", "min", "nansum", "nanprod",
              "sum_axis"]:
    case(_name, SUMS)(_reduce_case(_name))


def _arg_case(name):
    def fn(nd, ctx):
        f = getattr(nd, name)
        X = nd.array(_r(9).randn(3, 4, 5).astype(onp.float32), ctx=ctx)
        return {"all": f(X), "ax0": f(X, axis=0), "ax-1": f(X, axis=-1),
                "keep": f(X, axis=1, keepdims=True)}
    return fn


case("argmax")(_arg_case("argmax"))
case("argmin")(_arg_case("argmin"))


@case("argmax_channel")
def _(nd, ctx):
    return {"x": nd.argmax_channel(nd.array(_r(10).randn(3, 5).astype(
        onp.float32), ctx=ctx))}


@case("norm", SUMS)
def _(nd, ctx):
    X = nd.array(_r(11).randn(3, 4).astype(onp.float32), ctx=ctx)
    return {"l2": nd.norm(X), "l1": nd.norm(X, ord=1, axis=1),
            "l3": nd.norm(X, ord=3, axis=0, keepdims=True),
            "bf16": nd.norm(X.astype("bfloat16"), axis=1)}


@case("moments", SUMS)
def _(nd, ctx):
    X = nd.array(_r(12).randn(2, 3, 4).astype(onp.float32), ctx=ctx)
    return {"axes": nd.moments(X, axes=(0, 2)),
            "keep": nd.moments(X, axes=(1,), keepdims=True),
            "all": nd.moments(X)}


def _cum_case(name):
    def fn(nd, ctx):
        f = getattr(nd, name)
        X = nd.array(_r(13).uniform(0.5, 1.5, (3, 4)).astype(onp.float32),
                     ctx=ctx)
        return {"flat": f(X), "ax1": f(X, axis=1), "ax-2": f(X, axis=-2),
                "int": f(nd.array(i32([[1, 2, 3], [4, 5, 6]]), ctx=ctx),
                         axis=1),
                "dtype": f(X, axis=0, dtype="float16")}
    return fn


case("cumsum", SUMS)(_cum_case("cumsum"))
case("cumprod", SUMS)(_cum_case("cumprod"))


@case("logsumexp", TRANSCENDENTAL)
def _(nd, ctx):
    X = nd.array(_r(14).randn(3, 4).astype(onp.float32) * 3, ctx=ctx)
    return {"all": nd.logsumexp(X), "ax1": nd.logsumexp(X, axis=1),
            "keep": nd.logsumexp(X, axis=0, keepdims=True)}


# ---------------------------------------------------------------------------
# tensor: shapes
# ---------------------------------------------------------------------------
def _x234(nd, ctx, seed=15):
    return nd.array(_r(seed).randn(2, 3, 4).astype(onp.float32), ctx=ctx)


@case("reshape")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"plain": nd.reshape(X, shape=(4, 6)),
            "copy_infer": nd.reshape(X, shape=(0, -1)),
            "rest": nd.reshape(X, shape=(-2,)),
            "merge": nd.reshape(X, shape=(-3, 4)),
            "split": nd.reshape(X, shape=(-4, 1, 2, -2)),
            "split_infer": nd.reshape(X, shape=(0, -4, -1, 1, 4)),
            "method": X.reshape((6, -1))}


@case("transpose")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"rev": nd.transpose(X), "axes": nd.transpose(X, axes=(1, 0, 2))}


@case("swapaxes")
def _(nd, ctx):
    return {"x": nd.swapaxes(_x234(nd, ctx), dim1=0, dim2=2)}


@case("flatten")
def _(nd, ctx):
    return {"x": nd.flatten(_x234(nd, ctx)),
            "zero": nd.flatten(nd.zeros((2, 0, 3), ctx=ctx))}


@case("expand_dims")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"1": nd.expand_dims(X, axis=1), "-1": nd.expand_dims(X, axis=-1)}


@case("squeeze")
def _(nd, ctx):
    X = nd.array(f32(onp.ones((1, 3, 1, 2))), ctx=ctx)
    return {"all": nd.squeeze(X), "0": nd.squeeze(X, axis=0),
            "tuple": nd.squeeze(X, axis=(0, 2))}


@case("broadcast_to")
def _(nd, ctx):
    X = nd.array(f32([[[1], [2], [3]]]), ctx=ctx)
    return {"x": nd.broadcast_to(X, shape=(2, 3, 4)),
            "keep": nd.broadcast_to(X, shape=(2, 0, 5))}


@case("broadcast_axis")
def _(nd, ctx):
    X = nd.array(f32([[[1], [2], [3]]]), ctx=ctx)
    return {"x": nd.broadcast_axis(X, axis=(0, 2), size=(2, 4))}


@case("concat")
def _(nd, ctx):
    X = _x234(nd, ctx)
    Y = _x234(nd, ctx, 16)
    return {"1": nd.concat(X, Y), "-1": nd.concat(X, Y, dim=-1),
            "list": nd.concat([X, Y], dim=0)}


@case("stack")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"0": nd.stack(X, X), "-1": nd.stack(X, X, axis=-1)}


@case("split")
def _(nd, ctx):
    X = nd.array(_r(17).randn(2, 4, 3).astype(onp.float32), ctx=ctx)
    return {"2": nd.split(X, num_outputs=2, axis=1),
            "squeeze": nd.split(X, num_outputs=4, axis=1, squeeze_axis=True),
            "one": nd.split(X, num_outputs=1, axis=0)}


@case("split_v2")
def _(nd, ctx):
    X = nd.array(_r(18).randn(6, 4).astype(onp.float32), ctx=ctx)
    return {"idx": nd.split_v2(X, indices_or_sections=[1, 3]),
            "n": nd.split_v2(X, indices_or_sections=2, axis=1),
            "squeeze": nd.split_v2(X, indices_or_sections=4, axis=1,
                                   squeeze_axis=True)}


@case("slice")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"x": nd.slice(X, begin=(0, 1), end=(2, 3)),
            "none": nd.slice(X, begin=(None, 1, None), end=(None, None, 3)),
            "step": nd.slice(X, begin=(0, 0, 0), end=(2, 3, 4),
                             step=(1, 2, 2)),
            "neg_step": nd.slice(X, begin=(None, None), end=(None, None),
                                 step=(1, -1)),
            "neg": nd.slice(X, begin=(-1,), end=(None,))}


@case("slice_axis")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"x": nd.slice_axis(X, axis=1, begin=1, end=3),
            "none": nd.slice_axis(X, axis=2, begin=1, end=None),
            "neg": nd.slice_axis(X, axis=-1, begin=-3, end=-1)}


@case("slice_like")
def _(nd, ctx):
    X = nd.array(_r(19).randn(3, 4).astype(onp.float32), ctx=ctx)
    L = nd.zeros((2, 3), ctx=ctx)
    return {"all": nd.slice_like(X, L), "axes": nd.slice_like(X, L,
                                                             axes=(1,))}


@case("_getitem")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"x": nd._getitem(X, key=(slice(0, 2), 1)),
            "ellipsis": nd._getitem(X, key=(Ellipsis, 0)),
            "int": nd._getitem(X, key=1)}


@case("reverse")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"0": nd.reverse(X, axis=0), "tuple": nd.reverse(X, axis=(0, 2))}


@case("tile")
def _(nd, ctx):
    X = nd.array(f32([[1, 2], [3, 4]]), ctx=ctx)
    return {"2d": nd.tile(X, reps=(2, 3)), "1d": nd.tile(X, reps=(2,)),
            "3d": nd.tile(X, reps=(2, 1, 1))}


@case("repeat")
def _(nd, ctx):
    X = nd.array(f32([[1, 2], [3, 4]]), ctx=ctx)
    return {"flat": nd.repeat(X, repeats=2), "1": nd.repeat(X, repeats=3,
                                                           axis=1)}


@case("pad")
def _(nd, ctx):
    X = nd.array(_r(20).randn(1, 2, 4, 5).astype(onp.float32), ctx=ctx)
    w = (0, 0, 0, 0, 1, 2, 2, 1)
    return {"constant": nd.pad(X, mode="constant", pad_width=w,
                               constant_value=1.5),
            "edge": nd.pad(X, mode="edge", pad_width=w),
            "reflect": nd.pad(X, mode="reflect", pad_width=w)}


@case("depth_to_space")
def _(nd, ctx):
    X = nd.array(f32(onp.arange(48).reshape(1, 8, 2, 3)), ctx=ctx)
    return {"x": nd.depth_to_space(X, block_size=2)}


@case("space_to_depth")
def _(nd, ctx):
    X = nd.array(f32(onp.arange(48).reshape(1, 2, 4, 6)), ctx=ctx)
    return {"x": nd.space_to_depth(X, block_size=2)}


@case("diag")
def _(nd, ctx):
    return {"2d": nd.diag(nd.array(f32(onp.arange(12).reshape(3, 4)),
                                   ctx=ctx), k=1),
            "1d": nd.diag(nd.array(f32([1, 2, 3]), ctx=ctx), k=-1),
            "3d": nd.diag(_x234(nd, ctx), k=1)}


@case("shape_array")
def _(nd, ctx):
    return {"x": nd.shape_array(_x234(nd, ctx))}


@case("size_array")
def _(nd, ctx):
    return {"x": nd.size_array(_x234(nd, ctx))}


@case("where")
def _(nd, ctx):
    c = nd.array(f32([[1, 0, 2], [0, 0, 1]]), ctx=ctx)
    a = nd.array(_r(21).randn(2, 3).astype(onp.float32), ctx=ctx)
    b = nd.array(f32([[9, 8, 7]]), ctx=ctx)
    return {"x": nd.where(c, a, nd.broadcast_to(b, shape=(2, 3)))}


# ---------------------------------------------------------------------------
# tensor: indexing
# ---------------------------------------------------------------------------
@case("take")
def _(nd, ctx):
    X = _x234(nd, ctx)
    idx = nd.array(f32([0, 2, -1, 5, 1.7]), ctx=ctx)
    return {"clip": nd.take(X, idx, axis=1),
            "wrap": nd.take(X, idx, axis=2, mode="wrap"),
            "0": nd.take(X, nd.array(f32([[1, 0], [0, 1]]), ctx=ctx)),
            "empty": nd.take(X, nd.array(onp.zeros(0, onp.float32),
                                         ctx=ctx))}


@case("batch_take")
def _(nd, ctx):
    X = nd.array(_r(22).randn(3, 4).astype(onp.float32), ctx=ctx)
    return {"x": nd.batch_take(X, nd.array(i32([0, 3, -1]), ctx=ctx))}


@case("pick")
def _(nd, ctx):
    X = nd.array(_r(23).randn(3, 4).astype(onp.float32), ctx=ctx)
    return {"-1": nd.pick(X, nd.array(f32([0, 3, 1]), ctx=ctx)),
            "keep": nd.pick(X, nd.array(f32([0, 3, 1]), ctx=ctx),
                            keepdims=True),
            "0": nd.pick(X, nd.array(i32([2, 0, 1, 1]), ctx=ctx), axis=0),
            "neg": nd.pick(X, nd.array(f32([-1, -2, 0]), ctx=ctx))}


@case("take_along_axis")
def _(nd, ctx):
    X = nd.array(_r(24).randn(3, 4).astype(onp.float32), ctx=ctx)
    idx = nd.array(i32([[0, 3], [1, -1], [2, 2]]), ctx=ctx)
    return {"1": nd.take_along_axis(X, idx, axis=1),
            "0": nd.take_along_axis(X, nd.array(i32([[2, 0, 1, 1]]),
                                                ctx=ctx), axis=0)}


@case("gather_nd")
def _(nd, ctx):
    X = nd.array(_r(25).randn(3, 4, 2).astype(onp.float32), ctx=ctx)
    return {"2": nd.gather_nd(X, nd.array(i32([[0, 2, 1], [3, 1, -1]]),
                                          ctx=ctx)),
            "1": nd.gather_nd(X, nd.array(f32([[2, 0]]), ctx=ctx))}


_SCATTER_IDX = i32([[0, 2, 1], [3, 1, 0]])


@case("scatter_nd")
def _(nd, ctx):
    d = nd.array(f32([1, 2, 3]), ctx=ctx)
    return {"x": nd.scatter_nd(d, nd.array(_SCATTER_IDX, ctx=ctx),
                               shape=(3, 4))}


@case("_scatter_set_nd")
def _(nd, ctx):
    lhs = nd.array(_r(26).randn(3, 4).astype(onp.float32), ctx=ctx)
    return {"x": nd._scatter_set_nd(lhs, nd.array(f32([7, 8, 9]), ctx=ctx),
                                    nd.array(_SCATTER_IDX, ctx=ctx))}


@case("index_add", SUMS)
def _(nd, ctx):
    lhs = nd.array(_r(27).randn(3, 4).astype(onp.float32), ctx=ctx)
    idx = nd.array(i32([[0, 2, 0, 1], [3, 1, 3, 0]]), ctx=ctx)
    return {"repeats": nd.index_add(lhs, nd.array(f32([1, 2, 3, 4]),
                                                  ctx=ctx), idx)}


@case("index_copy")
def _(nd, ctx):
    old = nd.array(_r(28).randn(4, 3).astype(onp.float32), ctx=ctx)
    new = nd.array(f32(onp.ones((2, 3))), ctx=ctx)
    return {"x": nd.index_copy(old, nd.array(i32([0, 2]), ctx=ctx), new)}


@case("one_hot")
def _(nd, ctx):
    idx = nd.array(f32([0, 2, -1, 5, 1]), ctx=ctx)
    return {"f": nd.one_hot(idx, depth=4),
            "int": nd.one_hot(idx, depth=3, dtype="int32"),
            "onoff": nd.one_hot(idx, depth=4, on_value=2.0, off_value=-1.0)}


@case("boolean_mask_dense")
def _(nd, ctx):
    d = nd.array(_r(29).randn(4, 3).astype(onp.float32), ctx=ctx)
    return {"0": nd.boolean_mask_dense(d, nd.array(f32([1, 0, 1, 0]),
                                                   ctx=ctx)),
            "1": nd.boolean_mask_dense(d, nd.array(f32([0, 1, 1]), ctx=ctx),
                                       axis=1)}


def _seq(nd, ctx):
    return (nd.array(_r(30).randn(5, 3, 2).astype(onp.float32), ctx=ctx),
            nd.array(f32([1, 3, 5]), ctx=ctx))


@case("sequence_mask")
def _(nd, ctx):
    d, sl = _seq(nd, ctx)
    return {"off": nd.sequence_mask(d),
            "0": nd.SequenceMask(d, sl, use_sequence_length=True),
            "value": nd.SequenceMask(d, sl, use_sequence_length=True,
                                     value=-1.0),
            "1": nd.SequenceMask(nd.swapaxes(d, dim1=0, dim2=1), sl,
                                 use_sequence_length=True, axis=1)}


@case("sequence_last")
def _(nd, ctx):
    d, sl = _seq(nd, ctx)
    return {"off": nd.SequenceLast(d),
            "0": nd.SequenceLast(d, sl, use_sequence_length=True),
            "1": nd.SequenceLast(nd.swapaxes(d, dim1=0, dim2=1), sl,
                                 use_sequence_length=True, axis=1)}


@case("sequence_reverse")
def _(nd, ctx):
    d, sl = _seq(nd, ctx)
    return {"off": nd.SequenceReverse(d),
            "0": nd.SequenceReverse(d, sl, use_sequence_length=True)}


# ---------------------------------------------------------------------------
# tensor: ordering (tie-free inputs: a permutation of distinct values)
# ---------------------------------------------------------------------------
def _distinct(nd, ctx, shape=(3, 5)):
    v = _r(31).permutation(int(onp.prod(shape))).reshape(shape) * 0.5 - 3
    return nd.array(f32(v), ctx=ctx)


@case("sort")
def _(nd, ctx):
    X = _distinct(nd, ctx)
    return {"asc": nd.sort(X), "desc": nd.sort(X, is_ascend=False),
            "0": nd.sort(X, axis=0)}


@case("argsort")
def _(nd, ctx):
    X = _distinct(nd, ctx)
    return {"asc": nd.argsort(X), "desc": nd.argsort(X, is_ascend=False),
            "int": nd.argsort(X, axis=0, dtype="int32")}


@case("topk")
def _(nd, ctx):
    X = _distinct(nd, ctx)
    return {"idx": nd.topk(X, k=2), "value": nd.topk(X, k=2,
                                                     ret_typ="value"),
            "both": nd.topk(X, k=3, ret_typ="both", is_ascend=True),
            "mask": nd.topk(X, k=2, ret_typ="mask"),
            "0": nd.topk(X, axis=0, k=2, dtype="int32")}


@case("unique")
def _(nd, ctx):
    return {"x": nd.unique(nd.array(f32([3, 1, 2, 3, 1]), ctx=ctx)),
            "2d": nd.unique(nd.array(f32([[4, 4], [2, 5]]), ctx=ctx))}


@case("arange_like")
def _(nd, ctx):
    X = _x234(nd, ctx)
    return {"axis": nd.arange_like(X, start=1.0, step=0.5, axis=1),
            "int": nd.arange_like(nd.array(i32([[1, 2]]), ctx=ctx), axis=1)}


# ---------------------------------------------------------------------------
# products and linear algebra
# ---------------------------------------------------------------------------
def _m(nd, ctx, shape, seed):
    return nd.array(_r(seed).randn(*shape).astype(onp.float32), ctx=ctx)


@case("einsum", SUMS)
def _(nd, ctx):
    return {"mm": nd.einsum(_m(nd, ctx, (2, 3), 1), _m(nd, ctx, (3, 4), 2),
                            subscripts="ij,jk->ik"),
            "trace": nd.einsum(_m(nd, ctx, (3, 3), 3), subscripts="ii")}


@case("dot", SUMS)
def _(nd, ctx):
    a, b = _m(nd, ctx, (2, 3), 1), _m(nd, ctx, (3, 4), 2)
    return {"2d": nd.dot(a, b),
            "ta": nd.dot(_m(nd, ctx, (3, 2), 3), b, transpose_a=True),
            "tb": nd.dot(a, _m(nd, ctx, (4, 3), 4), transpose_b=True),
            "1d": nd.dot(_m(nd, ctx, (3,), 5), _m(nd, ctx, (3,), 6)),
            "3d": nd.dot(_m(nd, ctx, (2, 2, 3), 7), b),
            "zero_k": nd.dot(nd.zeros((2, 0), ctx=ctx),
                             nd.zeros((0, 3), ctx=ctx))}


@case("batch_dot", SUMS)
def _(nd, ctx):
    a, b = _m(nd, ctx, (2, 3, 4), 1), _m(nd, ctx, (2, 4, 5), 2)
    return {"x": nd.batch_dot(a, b),
            "tt": nd.batch_dot(b, a, transpose_a=True, transpose_b=True)}


@case("matmul", SUMS)
def _(nd, ctx):
    return {"x": nd.matmul(_m(nd, ctx, (2, 3, 4), 1),
                           _m(nd, ctx, (4, 5), 2))}


@case("khatri_rao", SUMS)
def _(nd, ctx):
    return {"x": nd.khatri_rao(_m(nd, ctx, (2, 3), 1), _m(nd, ctx, (4, 3), 2),
                               _m(nd, ctx, (2, 3), 3))}


@case("linalg_gemm2", SUMS)
def _(nd, ctx):
    a, b = _m(nd, ctx, (2, 3, 4), 1), _m(nd, ctx, (2, 4, 5), 2)
    return {"x": nd.linalg_gemm2(a, b, alpha=0.5),
            "t": nd.linalg_gemm2(b, a, transpose_a=True, transpose_b=True)}


@case("linalg_gemm", SUMS)
def _(nd, ctx):
    a, b = _m(nd, ctx, (3, 4), 1), _m(nd, ctx, (4, 5), 2)
    return {"x": nd.linalg_gemm(a, b, _m(nd, ctx, (3, 5), 3), alpha=2.0,
                                beta=0.5)}


def _spd(nd, ctx, seed=40):
    m = _r(seed).randn(2, 3, 3)
    return nd.array(f32(m @ m.transpose(0, 2, 1) + 3 * onp.eye(3)), ctx=ctx)


def _lower(nd, ctx, seed=41):
    m = onp.tril(_r(seed).randn(2, 3, 3)) + 3 * onp.eye(3)
    return nd.array(f32(m), ctx=ctx)


@case("linalg_potrf", SUMS)
def _(nd, ctx):
    return {"x": nd.linalg_potrf(_spd(nd, ctx))}


@case("linalg_trsm", SUMS)
def _(nd, ctx):
    a, b = _lower(nd, ctx), _m(nd, ctx, (2, 3, 4), 2)
    bt = _m(nd, ctx, (2, 4, 3), 3)
    return {"x": nd.linalg_trsm(a, b, alpha=2.0),
            "t": nd.linalg_trsm(a, b, transpose=True),
            "upper": nd.linalg_trsm(nd.swapaxes(a, dim1=1, dim2=2), b,
                                    lower=False),
            "right": nd.linalg_trsm(a, bt, rightside=True),
            "right_t": nd.linalg_trsm(a, bt, rightside=True, transpose=True)}


@case("linalg_trmm", SUMS)
def _(nd, ctx):
    a, b = _m(nd, ctx, (2, 3, 3), 1), _m(nd, ctx, (2, 3, 4), 2)
    return {"x": nd.linalg_trmm(a, b, alpha=2.0),
            "t": nd.linalg_trmm(a, b, transpose=True, lower=False),
            "right": nd.linalg_trmm(a, _m(nd, ctx, (2, 4, 3), 3),
                                    rightside=True)}


@case("linalg_syrk", SUMS)
def _(nd, ctx):
    a = _m(nd, ctx, (2, 3, 4), 1)
    return {"x": nd.linalg_syrk(a), "t": nd.linalg_syrk(a, transpose=True,
                                                        alpha=0.5)}


@case("linalg_sumlogdiag", TRANSCENDENTAL)
def _(nd, ctx):
    return {"x": nd.linalg_sumlogdiag(_spd(nd, ctx))}


@case("linalg_extractdiag")
def _(nd, ctx):
    a = _m(nd, ctx, (2, 3, 3), 1)
    return {"0": nd.linalg_extractdiag(a), "1": nd.linalg_extractdiag(
        a, offset=1)}


@case("linalg_makediag")
def _(nd, ctx):
    return {"1d": nd.linalg_makediag(_m(nd, ctx, (3,), 1), offset=1),
            "2d": nd.linalg_makediag(_m(nd, ctx, (2, 3), 2))}


@case("linalg_svd", SUMS)
def _(nd, ctx):
    a = _m(nd, ctx, (2, 3, 4), 1)
    u, s, vt = nd.linalg_svd(a)
    # singular vectors up to sign: compare u diag(s) vt and |u|, |vt|
    rebuilt = nd.batch_dot(u * nd.expand_dims(s, axis=1), vt)
    return {"s": s, "rebuilt": rebuilt, "abs_u": nd.abs(u),
            "abs_vt": nd.abs(vt)}


@case("linalg_inverse", SUMS)
def _(nd, ctx):
    return {"x": nd.linalg_inverse(_spd(nd, ctx))}


@case("linalg_det", SUMS)
def _(nd, ctx):
    return {"x": nd.linalg_det(_m(nd, ctx, (2, 3, 3), 1))}


@case("linalg_slogdet", SUMS)
def _(nd, ctx):
    return {"x": nd.linalg_slogdet(_m(nd, ctx, (2, 3, 3), 1))}


@case("linalg_potri", SUMS)
def _(nd, ctx):
    return {"x": nd.linalg_potri(_lower(nd, ctx))}


@case("linalg_syevd", SUMS)
def _(nd, ctx):
    u, w = nd.linalg_syevd(_spd(nd, ctx))
    return {"w": w, "abs_u": nd.abs(u)}


@case("linalg_gelqf", SUMS)
def _(nd, ctx):
    l_, q = nd.linalg_gelqf(_m(nd, ctx, (2, 3, 4), 1))
    return {"abs_l": nd.abs(l_), "abs_q": nd.abs(q),
            "rebuilt": nd.batch_dot(l_, q)}


@case("linalg_extracttrian")
def _(nd, ctx):
    a = _m(nd, ctx, (2, 3, 3), 1)
    return {"low": nd.linalg_extracttrian(a),
            "up1": nd.linalg_extracttrian(a, offset=1, lower=False)}


@case("linalg_maketrian")
def _(nd, ctx):
    return {"low": nd.linalg_maketrian(_m(nd, ctx, (2, 6), 1)),
            "up1": nd.linalg_maketrian(_m(nd, ctx, (3,), 2), offset=1,
                                       lower=False)}


# ---------------------------------------------------------------------------
# tensor: the rest
# ---------------------------------------------------------------------------
@case("histogram", SUMS)
def _(nd, ctx):
    x = nd.array(f32(_r(50).uniform(-2.2, 2.2, 200)), ctx=ctx)
    return {"cnt": nd.histogram(x, bin_cnt=5, range=(-2.0, 2.0)),
            "edges": nd.histogram(x, nd.array(f32([-2, -0.5, 0, 1.5, 2]),
                                              ctx=ctx))}


@case("broadcast_like")
def _(nd, ctx):
    a = nd.array(f32([[1], [2]]), ctx=ctx)
    b = nd.zeros((2, 3), ctx=ctx)
    return {"x": nd.broadcast_like(a, b),
            "axes": nd.broadcast_like(a, nd.zeros((4, 5), ctx=ctx),
                                      lhs_axes=(1,), rhs_axes=(0,))}


@case("reshape_like")
def _(nd, ctx):
    a = _x234(nd, ctx)
    return {"x": nd.reshape_like(a, nd.zeros((6, 4), ctx=ctx)),
            "window": nd.reshape_like(a, nd.zeros((5, 6, 7), ctx=ctx),
                                      lhs_begin=0, lhs_end=2, rhs_begin=1,
                                      rhs_end=2)}


@case("ravel_multi_index")
def _(nd, ctx):
    d = nd.array(f32([[0, 2, 1], [3, 1, 0]]), ctx=ctx)
    return {"x": nd.ravel_multi_index(d, shape=(3, 4))}


@case("unravel_index")
def _(nd, ctx):
    return {"x": nd.unravel_index(nd.array(f32([0, 5, 11]), ctx=ctx),
                                  shape=(3, 4))}


@case("slice_assign")
def _(nd, ctx):
    lhs = nd.array(_r(51).randn(3, 4).astype(onp.float32), ctx=ctx)
    rhs = nd.array(f32([[1, 2], [3, 4]]), ctx=ctx)
    return {"x": nd.slice_assign(lhs, rhs, begin=(0, 1), end=(2, 3)),
            "step": nd.slice_assign(lhs, rhs, begin=(0, 0), end=(3, 4),
                                    step=(2, 2))}


@case("slice_assign_scalar")
def _(nd, ctx):
    lhs = nd.array(_r(52).randn(3, 4).astype(onp.float32), ctx=ctx)
    return {"x": nd.slice_assign_scalar(lhs, scalar=7.0, begin=(1, None),
                                        end=(3, None))}


@case("im2col")
def _(nd, ctx):
    x = nd.array(_r(53).randn(1, 2, 5, 5).astype(onp.float32), ctx=ctx)
    return {"x": nd.im2col(x, kernel=(3, 3), pad=(1, 1)),
            "stride": nd.im2col(x, kernel=(2, 2), stride=(2, 2),
                                dilate=(1, 1))}


@case("col2im", SUMS)
def _(nd, ctx):
    cols = nd.array(_r(54).randn(1, 18, 25).astype(onp.float32), ctx=ctx)
    return {"x": nd.col2im(cols, output_size=(5, 5), kernel=(3, 3),
                           pad=(1, 1))}


@case("BlockGrad")
def _(nd, ctx):
    return {"x": nd.BlockGrad(_x234(nd, ctx))}


# ---------------------------------------------------------------------------
# nn
# ---------------------------------------------------------------------------
@case("FullyConnected", SUMS)
def _(nd, ctx):
    x, w, b = _m(nd, ctx, (2, 3, 4), 1), _m(nd, ctx, (5, 12), 2), \
        _m(nd, ctx, (5,), 3)
    return {"flat": nd.FullyConnected(x, w, b, num_hidden=5),
            "noflat": nd.FullyConnected(x, _m(nd, ctx, (5, 4), 4), b,
                                        num_hidden=5, flatten=False),
            "nobias": nd.FullyConnected(x, w, None, num_hidden=5,
                                        no_bias=True)}


@case("Convolution", SUMS)
def _(nd, ctx):
    return {
        "2d": nd.Convolution(_m(nd, ctx, (2, 4, 7, 6), 1),
                             _m(nd, ctx, (6, 2, 3, 3), 2),
                             _m(nd, ctx, (6,), 3), kernel=(3, 3),
                             stride=(2, 1), pad=(1, 2), dilate=(1, 2),
                             num_filter=6, num_group=2),
        "1d": nd.Convolution(_m(nd, ctx, (2, 3, 9), 4),
                             _m(nd, ctx, (4, 3, 3), 5), None, kernel=(3,),
                             num_filter=4, no_bias=True, pad=(1,)),
        "3d": nd.Convolution(_m(nd, ctx, (1, 2, 4, 5, 6), 6),
                             _m(nd, ctx, (3, 2, 2, 3, 2), 7),
                             _m(nd, ctx, (3,), 8), kernel=(2, 3, 2),
                             num_filter=3, stride=(1, 2, 1))}


@case("Deconvolution", SUMS)
def _(nd, ctx):
    return {
        "2d": nd.Deconvolution(_m(nd, ctx, (2, 4, 5, 4), 1),
                               _m(nd, ctx, (4, 3, 3, 3), 2),
                               _m(nd, ctx, (3,), 3), kernel=(3, 3),
                               stride=(2, 2), pad=(1, 1), adj=(1, 0),
                               num_filter=3),
        "groups": nd.Deconvolution(_m(nd, ctx, (1, 4, 5, 4), 4),
                                   _m(nd, ctx, (4, 2, 2, 2), 5), None,
                                   kernel=(2, 2), stride=(2, 2),
                                   num_filter=4, num_group=2, no_bias=True),
        "1d": nd.Deconvolution(_m(nd, ctx, (2, 3, 6), 6),
                               _m(nd, ctx, (3, 2, 3), 7), None, kernel=(3,),
                               num_filter=2, no_bias=True, dilate=(2,))}


@case("Pooling", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 7, 6), 1)
    P = nd.Pooling
    return {
        "max": P(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
        "max_full": P(x, kernel=(3, 3), stride=(2, 2),
                      pooling_convention="full"),
        "max_bigpad": P(x, kernel=(2, 2), pad=(1, 1)),
        "avg": P(x, kernel=(3, 3), pool_type="avg", stride=(2, 2),
                 pad=(1, 1)),
        "avg_nopad": P(x, kernel=(3, 3), pool_type="avg", stride=(2, 2),
                       pad=(1, 1), count_include_pad=False),
        "avg_full": P(x, kernel=(2, 2), pool_type="avg", stride=(2, 2),
                      pooling_convention="full"),
        "sum": P(x, kernel=(2, 3), pool_type="sum"),
        "lp": P(x, kernel=(2, 2), pool_type="lp"),
        "gmax": P(x, pool_type="max", global_pool=True),
        "gavg": P(x, pool_type="avg", global_pool=True),
        "gsum": P(x, pool_type="sum", global_pool=True),
        "1d": P(_m(nd, ctx, (2, 3, 9), 2), kernel=(3,), pool_type="avg",
                stride=(2,)),
        "3d": P(_m(nd, ctx, (1, 2, 4, 5, 6), 3), kernel=(2, 2, 2)),
        "bf16": P(x.astype("bfloat16"), kernel=(2, 2))}


@case("UpSampling", TRANSCENDENTAL)
def _(nd, ctx):
    x = _m(nd, ctx, (1, 2, 3, 4), 1)
    return {"nearest": nd.UpSampling(x, scale=2),
            "bilinear": nd.UpSampling(x, scale=2, sample_type="bilinear")}


@case("BilinearResize2D", TRANSCENDENTAL)
def _(nd, ctx):
    x = _m(nd, ctx, (1, 2, 6, 8), 1)
    return {"up": nd.BilinearResize2D(x, height=9, width=11),
            "scale": nd.BilinearResize2D(x, scale_height=1.5,
                                         scale_width=2.0),
            "same": nd.BilinearResize2D(x, height=6, width=8)}


@case("Activation", TRANSCENDENTAL)
def _(nd, ctx):
    x = _m(nd, ctx, (3, 4), 1) * 3
    return {t: nd.Activation(x, act_type=t) for t in (
        "relu", "sigmoid", "tanh", "softrelu", "softsign", "log_sigmoid",
        "mish", "gelu", "silu")}


def _softmax_family(name):
    def fn(nd, ctx):
        f = getattr(nd, name)
        x = _m(nd, ctx, (3, 5), 1) * 3
        out = {"-1": f(x), "0": f(x, axis=0), "t": f(x, temperature=2.0),
               "bf16": f(x.astype("bfloat16")),
               "3d": f(_m(nd, ctx, (2, 3, 4), 2), axis=1)}
        if name != "softmin":
            out["length"] = f(x, nd.array(f32([2, 5, 0]), ctx=ctx),
                              use_length=True)
        return out
    return fn


for _name in ("softmax", "log_softmax", "softmin"):
    case(_name, TRANSCENDENTAL)(_softmax_family(_name))


@case("masked_softmax", TRANSCENDENTAL)
def _(nd, ctx):
    x = _m(nd, ctx, (3, 5), 1)
    mask = nd.array(f32([[1, 1, 0, 1, 0], [0, 0, 0, 0, 1],
                         [1, 1, 1, 1, 1]]), ctx=ctx)
    return {"x": nd.masked_softmax(x, mask),
            "t": nd.masked_softmax(x, mask, temperature=0.5)}


@case("SoftmaxActivation", TRANSCENDENTAL)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 4), 1)
    return {"instance": nd.SoftmaxActivation(x),
            "channel": nd.SoftmaxActivation(x, mode="channel")}


@case("SoftmaxOutput", TRANSCENDENTAL)
def _(nd, ctx):
    x = _m(nd, ctx, (3, 5), 1)
    return {"x": nd.SoftmaxOutput(x, nd.array(f32([0, 4, 2]), ctx=ctx)),
            "multi": nd.SoftmaxOutput(_m(nd, ctx, (2, 3, 4), 2),
                                      nd.array(f32(onp.zeros((2, 4))),
                                               ctx=ctx),
                                      multi_output=True)}


@case("softmax_cross_entropy", TRANSCENDENTAL)
def _(nd, ctx):
    return {"x": nd.softmax_cross_entropy(_m(nd, ctx, (3, 5), 1),
                                          nd.array(f32([0, 4, 2]), ctx=ctx))}


def _bn_args(nd, ctx):
    x = _m(nd, ctx, (2, 3, 4, 5), 1) * 2 + 1
    g, b = _m(nd, ctx, (3,), 2), _m(nd, ctx, (3,), 3)
    mm = nd.array(f32([0.1, -0.2, 0.3]), ctx=ctx)
    mv = nd.array(f32([1.5, 0.5, 2.0]), ctx=ctx)
    return x, g, b, mm, mv


@case("BatchNorm", SUMS)
def _(nd, ctx):
    x, g, b, mm, mv = _bn_args(nd, ctx)
    return {"eval": nd.BatchNorm(x, g, b, mm, mv, fix_gamma=False),
            "bf16": nd.BatchNorm(x.astype("bfloat16"), g, b, mm, mv)}


@case("BatchNorm_v1", SUMS)
def _(nd, ctx):
    x, g, b, mm, mv = _bn_args(nd, ctx)
    return {"eval": nd.BatchNorm_v1(x, g, b, mm, mv)}


@case("LayerNorm", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 4), 1)
    g, b = _m(nd, ctx, (4,), 2), _m(nd, ctx, (4,), 3)
    return {"x": nd.LayerNorm(x, g, b),
            "mean_var": nd.LayerNorm(x, g, b, output_mean_var=True),
            "axis1": nd.LayerNorm(x, _m(nd, ctx, (3,), 4),
                                  _m(nd, ctx, (3,), 5), axis=1, eps=1e-3)}


@case("RMSNorm", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 4), 1)
    return {"x": nd.RMSNorm(x, _m(nd, ctx, (4,), 2)),
            "bf16": nd.RMSNorm(x.astype("bfloat16"), _m(nd, ctx, (4,), 2))}


@case("GroupNorm", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 4, 3, 3), 1)
    return {"x": nd.GroupNorm(x, _m(nd, ctx, (4,), 2), _m(nd, ctx, (4,), 3),
                              num_groups=2)}


@case("InstanceNorm", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 4, 5), 1)
    return {"x": nd.InstanceNorm(x, _m(nd, ctx, (3,), 2),
                                 _m(nd, ctx, (3,), 3))}


@case("L2Normalization", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 4), 1)
    return {m: nd.L2Normalization(x, mode=m)
            for m in ("instance", "channel", "spatial")}


@case("LRN", SUMS)
def _(nd, ctx):
    return {"x": nd.LRN(_m(nd, ctx, (2, 6, 3, 3), 1), nsize=3, alpha=0.1)}


@case("Dropout")
def _(nd, ctx):
    x = _m(nd, ctx, (3, 4), 1)
    return {"eval": nd.Dropout(x, p=0.5), "p0": nd.Dropout(x, p=0.0)}


@case("Embedding")
def _(nd, ctx):
    w = _m(nd, ctx, (5, 3), 1)
    return {"x": nd.Embedding(nd.array(f32([[0, 4], [2, 1]]), ctx=ctx), w,
                              input_dim=5, output_dim=3),
            "int": nd.Embedding(nd.array(i32([3, 3]), ctx=ctx), w,
                                input_dim=5, output_dim=3)}


@case("RNN", SUMS)
def _(nd, ctx):
    T, N, I, H = 4, 2, 3, 5
    size = rnn_param_size("lstm", 2, I, H, True)
    p = nd.array(f32(_r(2).uniform(-0.3, 0.3, size)), ctx=ctx)
    x = _m(nd, ctx, (T, N, I), 1)
    h0 = nd.zeros((4, N, H), ctx=ctx)
    return {"lstm": nd.RNN(x, p, h0, h0, state_size=H, num_layers=2,
                           bidirectional=True, mode="lstm")}


def _qkv(nd, ctx, L=6, N=2, heads=2, D=4, seed=1):
    return _m(nd, ctx, (L, N, 3 * heads * D), seed)


@case("_contrib_interleaved_matmul_selfatt_qk", SUMS)
def _(nd, ctx):
    return {"x": nd._contrib_interleaved_matmul_selfatt_qk(_qkv(nd, ctx),
                                                           heads=2)}


@case("_contrib_interleaved_matmul_selfatt_valatt", SUMS)
def _(nd, ctx):
    att = nd.softmax(_m(nd, ctx, (4, 6, 6), 2))
    return {"x": nd._contrib_interleaved_matmul_selfatt_valatt(
        _qkv(nd, ctx), att, heads=2)}


@case("_contrib_interleaved_matmul_encdec_qk", SUMS)
def _(nd, ctx):
    return {"x": nd._contrib_interleaved_matmul_encdec_qk(
        _m(nd, ctx, (5, 2, 8), 1), _m(nd, ctx, (6, 2, 16), 2), heads=2)}


@case("_contrib_interleaved_matmul_encdec_valatt", SUMS)
def _(nd, ctx):
    att = nd.softmax(_m(nd, ctx, (4, 5, 6), 3))
    return {"x": nd._contrib_interleaved_matmul_encdec_valatt(
        _m(nd, ctx, (6, 2, 16), 2), att, heads=2)}


@case("_contrib_div_sqrt_dim", TRANSCENDENTAL)
def _(nd, ctx):
    return {"x": nd._contrib_div_sqrt_dim(_m(nd, ctx, (2, 3, 16), 1))}


@case("multi_head_attention", SUMS)
def _(nd, ctx):
    q, k, v = (_m(nd, ctx, (2, 8, 32), s) for s in (1, 2, 3))
    mask = nd.array(f32(_r(4).rand(2, 1, 8, 8) > 0.3), ctx=ctx)
    # one head of D = 32 (a head dim K1 takes) unmasked, two heads masked
    return {"plain": nd.multi_head_attention(q, k, v, heads=1),
            "causal": nd.multi_head_attention(q, k, v, heads=1, causal=True),
            "cross": nd.multi_head_attention(q[:, :5], k, v, heads=2,
                                             causal=True),
            "mask": nd.multi_head_attention(q, k, v, mask, heads=2)}


@case("CTCLoss", SUMS)
def _(nd, ctx):
    data = _m(nd, ctx, (6, 3, 5), 1)
    first = nd.array(f32([[1, 2, 0], [3, 3, 4], [2, 0, 0]]), ctx=ctx)
    last = nd.array(f32([[0, 1, -1], [2, 2, 3], [1, -1, -1]]), ctx=ctx)
    return {"first": nd.CTCLoss(data, first),
            "last": nd.CTCLoss(data, last, blank_label="last"),
            "lengths": nd.CTCLoss(data, first, nd.array(f32([6, 4, 5]),
                                                        ctx=ctx),
                                  nd.array(f32([2, 3, 1]), ctx=ctx),
                                  use_data_lengths=True,
                                  use_label_lengths=True)}


def _head_case(name):
    def fn(nd, ctx):
        x = _m(nd, ctx, (3, 4), 1)
        lab = nd.array(f32([1, 0, 3]), ctx=ctx) if name == "SVMOutput" \
            else _m(nd, ctx, (3, 4), 2)
        f = getattr(nd, name)
        return {"x": f(x, lab) if name not in ("MakeLoss", "make_loss")
                else f(x)}
    return fn


for _name in ("LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput", "MakeLoss", "make_loss", "SVMOutput"):
    case(_name, TRANSCENDENTAL)(_head_case(_name))


# ---------------------------------------------------------------------------
# attention registry ops (ops/pallas/flash_attention.py)
# ---------------------------------------------------------------------------
@case("flash_attention", SUMS)
def _(nd, ctx):
    q, k, v = (_m(nd, ctx, (2, 2, 8, 32), s) for s in (1, 2, 3))
    # D = 32 at equal lengths is K1's (two launches on the card); D = 16
    # and a cross length take the dense path
    return {"plain": nd.flash_attention(q, k, v),
            "causal": nd.flash_attention(q, k, v, causal=True, sm_scale=0.3,
                                         block_q=64, block_k=64),
            "d16": nd.flash_attention(*(_m(nd, ctx, (1, 2, 8, 16), s)
                                        for s in (4, 5, 6))),
            "cross": nd.flash_attention(q[:, :, :5], k, v, causal=True)}


@case("single_query_attention", SUMS)
def _(nd, ctx):
    B, L, heads, D = 2, 6, 2, 4
    q, kn, vn = (_m(nd, ctx, (B, heads * D), s) for s in (1, 2, 3))
    kc, vc = (_m(nd, ctx, (B, L, heads * D), s) for s in (4, 5))
    lengths = nd.array(i32([2, 5]), ctx=ctx)
    return {"x": nd.single_query_attention(q, kc, vc, kn, vn, lengths,
                                           heads=heads),
            "scale": nd.single_query_attention(q, kc, vc, kn, vn, lengths,
                                               heads=1, sm_scale=0.2)}


# ---------------------------------------------------------------------------
# nn: the spatial transformer family and the correlation layer
# ---------------------------------------------------------------------------
_IDENT = f32([[1, 0, 0, 0, 1, 0], [0.8, 0.3, 0.1, -0.2, 0.9, -0.1]])


@case("GridGenerator", SUMS)
def _(nd, ctx):
    return {"affine": nd.GridGenerator(nd.array(_IDENT, ctx=ctx),
                                       transform_type="affine",
                                       target_shape=(4, 5)),
            "warp": nd.GridGenerator(_m(nd, ctx, (2, 2, 3, 4), 1),
                                     transform_type="warp")}


@case("BilinearSampler", SUMS)
def _(nd, ctx):
    grid = nd.array(f32(_r(2).uniform(-1.2, 1.2, (2, 2, 4, 3))), ctx=ctx)
    return {"x": nd.BilinearSampler(_m(nd, ctx, (2, 3, 5, 6), 1), grid)}


@case("SpatialTransformer", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 5, 6), 1)
    return {"x": nd.SpatialTransformer(x, nd.array(_IDENT, ctx=ctx),
                                       target_shape=(4, 3),
                                       transform_type="affine",
                                       sampler_type="bilinear")}


@case("Correlation", SUMS)
def _(nd, ctx):
    a, b = _m(nd, ctx, (1, 3, 7, 8), 1), _m(nd, ctx, (1, 3, 7, 8), 2)
    return {"k1": nd.Correlation(a, b, kernel_size=1, max_displacement=2),
            "k3": nd.Correlation(a, b, kernel_size=3, max_displacement=2,
                                 stride1=2, stride2=2, pad_size=2),
            "abs": nd.Correlation(a, b, kernel_size=1, max_displacement=1,
                                  is_multiply=False)}


# ---------------------------------------------------------------------------
# image ops (nd.image). A random form runs at a draw that fixes its result
# (min_factor == max_factor, alpha_std 0) and, where it draws freely, is
# checked by its outcome: a flip is the image or its mirror (the product
# of the two distances is 0), a brightness factor is one ratio within its
# range, lighting adds one constant per channel (each 1.0 when it holds).
# ---------------------------------------------------------------------------
def _img(nd, ctx, shape=(5, 6, 3), seed=1):
    return nd.array(f32(_r(seed).uniform(1, 255, shape)), ctx=ctx)


def _u8(nd, ctx, shape=(5, 6, 3), seed=2):
    return nd.array(_r(seed).randint(0, 256, shape).astype(onp.uint8),
                    ctx=ctx, dtype="uint8")


def _holds(nd, *preds):
    out = preds[0]
    for p in preds[1:]:
        out = out * p
    return out


@case("_image_to_tensor")
def _(nd, ctx):
    return {"hwc": nd.image.to_tensor(_u8(nd, ctx)),
            "nhwc": nd.image.to_tensor(_u8(nd, ctx, (2, 5, 6, 3))),
            "f32": nd.image.to_tensor(_img(nd, ctx))}


@case("_image_normalize", SUMS)
def _(nd, ctx):
    chw = _img(nd, ctx, (3, 5, 6)) / 255.0
    return {"chw": nd.image.normalize(chw, (0.4, 0.5, 0.6), (0.2, 0.3, 0.4)),
            "nchw": nd.image.normalize(_img(nd, ctx, (2, 3, 4, 5)) / 255.0,
                                       (0.4, 0.5, 0.6), (0.2, 0.3, 0.4)),
            "scalar": nd.image.normalize(chw, 0.5, 0.25)}


@case("_image_resize", SUMS)
def _(nd, ctx):
    x = _img(nd, ctx, (9, 7, 3))
    return {"shrink": nd.image.imresize(x, 4, 5),
            "grow": nd.image.resize(x, (11, 13)),
            "nearest": nd.image.resize(x, (11, 4), interp=0),
            "keep_ratio": nd.image.resize(x, 5, keep_ratio=True),
            "u8_nearest": nd.image.resize(_u8(nd, ctx), (9, 3), interp=0),
            "nhwc": nd.image.resize(_img(nd, ctx, (2, 6, 5, 3)), (3, 4))}


@case("_image_crop")
def _(nd, ctx):
    return {"hwc": nd.image.crop(_u8(nd, ctx), 1, 2, 4, 3),
            "nhwc": nd.image.fixed_crop(_img(nd, ctx, (2, 5, 6, 3)), 0, 1,
                                        5, 2)}


@case("_image_flip_left_right")
def _(nd, ctx):
    return {"hwc": nd.image.flip_left_right(_u8(nd, ctx)),
            "nhwc": nd.image.flip_left_right(_img(nd, ctx, (2, 4, 5, 3)))}


@case("_image_flip_top_bottom")
def _(nd, ctx):
    return {"hwc": nd.image.flip_top_bottom(_u8(nd, ctx)),
            "nhwc": nd.image.flip_top_bottom(_img(nd, ctx, (2, 4, 5, 3)))}


def _flip_outcome(nd, ctx, random_flip, flip):
    out = {}
    for k, shape in (("hwc", (5, 6, 3)), ("nhwc", (2, 4, 5, 3))):
        x = _img(nd, ctx, shape)
        y = random_flip(x)
        out[k] = nd.sum(nd.abs(y - x)) * nd.sum(nd.abs(y - flip(x)))
        out[k + "_shape"] = y.shape
    return out


@case("_image_random_flip_left_right")
def _(nd, ctx):
    return _flip_outcome(nd, ctx, nd.image.random_flip_left_right,
                         nd.image.flip_left_right)


@case("_image_random_flip_top_bottom")
def _(nd, ctx):
    return _flip_outcome(nd, ctx, nd.image.random_flip_top_bottom,
                         nd.image.flip_top_bottom)


@case("_image_random_brightness", SUMS)
def _(nd, ctx):
    x = _img(nd, ctx)
    ratio = nd.image.random_brightness(x, 0.5, 1.5) / x
    lo, hi = nd.min(ratio), nd.max(ratio)
    return {"fixed": nd.image.random_brightness(_u8(nd, ctx), 1.3, 1.3),
            "drawn": _holds(nd, hi - lo < 1e-5, lo >= 0.5, hi <= 1.5)}


@case("_image_random_contrast", SUMS)
def _(nd, ctx):
    return {"hwc": nd.image.random_contrast(_img(nd, ctx), 0.7, 0.7),
            "nhwc": nd.image.random_contrast(_img(nd, ctx, (2, 4, 5, 3)),
                                             1.4, 1.4),
            "one_channel": nd.image.random_contrast(_img(nd, ctx, (4, 5, 1)),
                                                    0.6, 0.6)}


@case("_image_random_saturation", SUMS)
def _(nd, ctx):
    return {"hwc": nd.image.random_saturation(_img(nd, ctx), 0.3, 0.3),
            "nhwc": nd.image.random_saturation(_img(nd, ctx, (2, 4, 5, 3)),
                                               1.6, 1.6)}


@case("_image_random_hue", SUMS)
def _(nd, ctx):
    return {"hwc": nd.image.random_hue(_img(nd, ctx), 0.25, 0.25),
            "nhwc": nd.image.random_hue(_img(nd, ctx, (2, 4, 5, 3)), -0.1,
                                        -0.1)}


@case("_image_random_color_jitter", SUMS)
def _(nd, ctx):
    x = _img(nd, ctx)
    ratio = nd.image.random_color_jitter(x, brightness=0.3) / x
    lo, hi = nd.min(ratio), nd.max(ratio)
    return {"none": nd.image.random_color_jitter(_u8(nd, ctx)),
            "drawn": _holds(nd, hi - lo < 1e-5, lo >= 0.7, hi <= 1.3)}


@case("_image_adjust_lighting", SUMS)
def _(nd, ctx):
    return {"hwc": nd.image.adjust_lighting(_img(nd, ctx), (0.1, -0.2, 0.3)),
            "u8": nd.image.adjust_lighting(_u8(nd, ctx), (-0.5, 0.0, 0.25))}


@case("_image_random_lighting", SUMS)
def _(nd, ctx):
    x = _img(nd, ctx)
    d = nd.image.random_lighting(x, 0.5) - x
    spread = nd.max(d, axis=(0, 1)) - nd.min(d, axis=(0, 1))
    return {"fixed": nd.image.random_lighting(x, 0.0),
            "drawn": nd.max(spread) < 1e-3}


# ---------------------------------------------------------------------------
# contrib: boxes, NMS and the MultiBox family. Inputs are tie-free (scores
# a permutation of distinct values) and away from the thresholds (every
# candidate pair's IoU at least 1e-3 from the NMS threshold), which
# _well_posed checks in f64 on the host.
# ---------------------------------------------------------------------------
def _iou_np(a, b):
    ix = onp.clip(onp.minimum(a[:, None, 2], b[None, :, 2])
                  - onp.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = onp.clip(onp.minimum(a[:, None, 3], b[None, :, 3])
                  - onp.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    area = lambda c: (c[:, 2] - c[:, 0]) * (c[:, 3] - c[:, 1])  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def well_posed(boxes, scores, thresh, margin=1e-3):
    """Raise unless no two boxes' IoU lies within ``margin`` of ``thresh``
    and the scores are distinct (one image: boxes (N, 4), scores (N,))."""
    b = onp.asarray(boxes, onp.float64)
    iou = _iou_np(b, b)[onp.triu_indices(len(b), 1)]
    if (onp.abs(iou - thresh) < margin).any():
        raise ValueError(f"an IoU lies within {margin} of {thresh}")
    if len(onp.unique(scores)) != len(scores):
        raise ValueError("tied scores")


def detection_problems(cls_preds, loc_preds, anchors, threshold,
                       nms_threshold, topk, score_margin=1e-6,
                       iou_margin=1e-4):
    """What makes ``MultiBoxDetection`` (after a softmax over classes)
    ill posed on these predictions (numpy: cls_preds (B, C, N), loc_preds
    (B, N * 4), anchors (1, N, 4)), recomputed in f64: a score within
    ``score_margin`` of ``threshold``, two of the top-``topk`` candidates'
    scores within it of each other, or a same-class candidate pair's IoU
    within ``iou_margin`` of ``nms_threshold``. Empty when well posed."""
    c = onp.asarray(cls_preds, onp.float64)
    prob = onp.exp(c - c.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    a = onp.asarray(anchors, onp.float64)[0]
    ac = onp.stack([(a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2,
                    a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]], 1)
    out = []
    for b in range(c.shape[0]):
        d = onp.asarray(loc_preds[b], onp.float64).reshape(-1, 4) * \
            [0.1, 0.1, 0.2, 0.2]
        cx, cy = d[:, 0] * ac[:, 2] + ac[:, 0], d[:, 1] * ac[:, 3] + ac[:, 1]
        w, h = onp.exp(d[:, 2]) * ac[:, 2], onp.exp(d[:, 3]) * ac[:, 3]
        boxes = onp.clip(onp.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2], 1), 0, 1)
        p = prob[b, 1:]
        cls, score = p.argmax(0), p.max(0)
        if onp.abs(score - threshold).min() <= score_margin:
            out.append(f"image {b}: a score at the threshold")
        order = onp.argsort(-score, kind="stable")[:topk]
        order = order[score[order] > threshold]
        if len(order) > 1 and onp.diff(onp.sort(score[order])).min() <= \
                score_margin:
            out.append(f"image {b}: two candidates' scores tie")
        same = onp.triu(cls[order][:, None] == cls[order][None, :], 1)
        iou = _iou_np(boxes[order], boxes[order])[same]
        if iou.size and onp.abs(iou - nms_threshold).min() <= iou_margin:
            out.append(f"image {b}: an IoU at the NMS threshold")
    return out


def _boxes(r, n, lo=0.0, hi=1.0):
    xy = r.uniform(lo, hi - 0.35, (n, 2))
    wh = r.uniform(0.1, 0.35, (n, 2))
    return onp.concatenate([xy, xy + wh], 1)


def _nms_rows(seed, B=2, N=12):
    r = _r(seed)
    rows = onp.zeros((B, N, 6), onp.float32)
    for b in range(B):
        rows[b, :, 0] = r.randint(0, 3, N)
        rows[b, :, 1] = (r.permutation(N) + 0.5) / N
        rows[b, :, 2:] = _boxes(r, N)
        well_posed(rows[b, :, 2:], rows[b, :, 1], 0.5)
    return rows


@case("_contrib_box_iou", SUMS)
def _(nd, ctx):
    r = _r(60)
    a = nd.array(f32(_boxes(r, 4)), ctx=ctx)
    b = nd.array(f32(_boxes(r, 5)), ctx=ctx)
    ab = nd.array(f32(_boxes(r, 6).reshape(2, 3, 4)), ctx=ctx)
    bb = nd.array(f32(_boxes(r, 10).reshape(2, 5, 4)), ctx=ctx)
    return {"corner": nd.contrib.box_iou(a, b),
            "center": nd.contrib.box_iou(a, b, format="center"),
            "batched": nd.contrib.box_iou(ab, bb)}


@case("_contrib_box_nms")
def _(nd, ctx):
    x = nd.array(_nms_rows(61), ctx=ctx)
    f = nd.contrib.box_nms
    # topk and valid_thresh cut mid-array: the loop runs over the rows
    # before the cut only
    return {"plain": f(x, overlap_thresh=0.5),
            "cut": f(x, overlap_thresh=0.5, valid_thresh=0.3, topk=7),
            "force": f(x, overlap_thresh=0.5, force_suppress=True),
            "background": f(x, overlap_thresh=0.5, background_id=0),
            "no_ids": f(x, overlap_thresh=0.5, id_index=-1),
            "center": f(x, overlap_thresh=0.5, in_format="center"),
            "none_valid": f(x, overlap_thresh=0.5, valid_thresh=2.0),
            "2d": f(x[0], overlap_thresh=0.5)}


@case("_contrib_box_encode", SUMS)
def _(nd, ctx):
    r = _r(62)
    B, N, M = 2, 5, 3
    samples = nd.array(f32(r.randint(0, 2, (B, N))), ctx=ctx)
    matches = nd.array(f32(r.randint(0, M, (B, N))), ctx=ctx)
    anchors = nd.array(f32(_boxes(r, B * N).reshape(B, N, 4)), ctx=ctx)
    refs = nd.array(f32(_boxes(r, B * M).reshape(B, M, 4)), ctx=ctx)
    return {"x": nd.contrib.box_encode(samples, matches, anchors, refs),
            "stds": nd.contrib.box_encode(samples, matches, anchors, refs,
                                          means=(0.1, 0., 0., -0.1),
                                          stds=(0.2, 0.2, 0.1, 0.1))}


@case("_contrib_box_decode", SUMS)
def _(nd, ctx):
    r = _r(63)
    data = nd.array(f32(r.uniform(-1, 1, (2, 6, 4))), ctx=ctx)
    anchors = nd.array(f32(_boxes(r, 6)[None]), ctx=ctx)
    f = nd.contrib.box_decode
    return {"corner": f(data, anchors), "clip": f(data, anchors, clip=0.1),
            "center": f(data, anchors, format="center", std0=0.2)}


@case("MultiBoxPrior", SUMS)
def _(nd, ctx):
    # SUMS, not EXACT: the JAX package's jitted op may round a corner once
    # (a fused multiply-add) where the port rounds twice, an f32 ulp; the
    # port is bitwise the reference's function op by op (test_torch_ssd.py)
    x = nd.zeros((1, 3, 4, 5), ctx=ctx)
    f = nd.contrib.MultiBoxPrior
    return {"x": f(x, sizes=(0.3, 0.2), ratios=(1, 2, 0.5)),
            "clip": f(x, sizes=(0.75,), ratios=(1, 3.0), clip=True),
            "steps": f(x, sizes=(0.1,), steps=(0.3, 0.2),
                       offsets=(0.25, 0.75))}


def _multibox_inputs(nd, ctx):
    """Anchors of a 4 x 4 map, and labels whose IoUs with every anchor are
    distinct and away from 0.5 (so argmax and the threshold are well
    posed); image 1's first label's best anchor is anchor 0 and a padding
    label follows it."""
    anchors = nd.contrib.MultiBoxPrior(nd.zeros((1, 3, 4, 4), ctx=ctx),
                                       sizes=(0.3, 0.45), ratios=(1, 2))
    label = f32([[[1, 0.52, 0.11, 0.83, 0.47], [0, 0.07, 0.58, 0.41, 0.96],
                  [2, 0.31, 0.33, 0.69, 0.71]],
                 [[2, 0.01, 0.02, 0.16, 0.14], [-1, 0, 0, 0, 0],
                  [-1, 0, 0, 0, 0]]])
    a = anchors.asnumpy()[0]
    for b in range(2):
        iou = _iou_np(a.astype(onp.float64), label[b, :, 1:].astype(
            onp.float64))[:, label[b, :, 0] >= 0]
        if (onp.abs(iou - 0.5) < 1e-3).any():
            raise ValueError("an anchor's IoU lies at the threshold")
    return anchors, nd.array(label, ctx=ctx)


@case("MultiBoxTarget", SUMS)
def _(nd, ctx):
    anchors, label = _multibox_inputs(nd, ctx)
    cls = nd.zeros((2, 4, anchors.shape[1]), ctx=ctx)
    return {"x": nd.contrib.MultiBoxTarget(anchors, label, cls),
            "low": nd.contrib.MultiBoxTarget(anchors, label, cls,
                                             overlap_threshold=0.3,
                                             variances=(0.2, 0.2, 0.1,
                                                        0.1))}


@case("MultiBoxDetection", SUMS)
def _(nd, ctx):
    r = _r(64)
    N, C = 12, 4
    a = _boxes(r, N)
    loc = r.uniform(-0.3, 0.3, (2, N, 4))
    # decoded boxes (f64) well posed for each image, scores distinct
    ac = onp.stack([(a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2,
                    a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]], 1)
    d = loc * [0.1, 0.1, 0.2, 0.2]
    cx, cy = d[..., 0] * ac[:, 2] + ac[:, 0], d[..., 1] * ac[:, 3] + ac[:, 1]
    w, h = onp.exp(d[..., 2]) * ac[:, 2], onp.exp(d[..., 3]) * ac[:, 3]
    dec = onp.clip(onp.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                              cy + h / 2], -1), 0, 1)
    logits = r.randn(2, C, N) * 2
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    for b in range(2):
        well_posed(dec[b], prob[b, 1:].max(0), 0.45)
    cls_prob = nd.array(f32(prob), ctx=ctx)
    loc_pred = nd.array(f32(loc.reshape(2, -1)), ctx=ctx)
    anchor = nd.array(f32(a[None]), ctx=ctx)
    f = nd.contrib.MultiBoxDetection
    return {"x": f(cls_prob, loc_pred, anchor, threshold=0.05,
                   nms_threshold=0.45),
            "topk": f(cls_prob, loc_pred, anchor, threshold=0.05,
                      nms_threshold=0.45, nms_topk=5, force_suppress=True),
            "noclip": f(cls_prob, loc_pred, anchor, clip=False,
                        threshold=0.05, nms_threshold=0.45)}


# ---------------------------------------------------------------------------
# contrib: ROI ops
# ---------------------------------------------------------------------------
_ROIS = f32([[0, 0.6, 1.2, 4.3, 3.7], [1, -1.4, 0.3, 2.2, 5.6],
             [0, 2.1, 2.4, 2.7, 2.9], [1, 3.3, -0.8, 7.9, 6.4]])


@case("_contrib_ROIAlign", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 6, 7), 1)
    rois = nd.array(_ROIS, ctx=ctx)
    f = nd.contrib.ROIAlign
    return {"x": f(x, rois, pooled_size=(2, 3)),
            "scale": f(x, rois, pooled_size=(3, 2), spatial_scale=0.5,
                       sample_ratio=3),
            "aligned": f(x, rois, pooled_size=(2, 2), aligned=True)}


@case("ROIPooling", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 6, 7), 1)
    rois = nd.array(_ROIS, ctx=ctx)
    return {"x": nd.ROIPooling(x, rois, pooled_size=(2, 3)),
            "scale": nd.ROIPooling(x, rois, pooled_size=(2, 2),
                                   spatial_scale=0.7)}


@case("_contrib_RROIAlign", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 3, 8, 8), 1)
    rois = nd.array(f32([[0, 4.2, 3.9, 4.4, 3.1, 30.0],
                         [1, 2.7, 5.1, 3.3, 5.2, -75.0],
                         [0, 6.5, 1.3, 2.4, 1.8, 200.0]]), ctx=ctx)
    f = nd.contrib.RROIAlign
    return {"x": f(x, rois, pooled_size=2, spatial_scale=1.0),
            "scale": f(x, rois, pooled_size=(3, 2), spatial_scale=0.5,
                       sampling_ratio=3)}


@case("_contrib_mrcnn_mask_target", SUMS)
def _(nd, ctx):
    r = _r(65)
    rois = nd.array(f32(_boxes(r, 6).reshape(2, 3, 4) * 8), ctx=ctx)
    masks = nd.array(f32(r.rand(2, 2, 8, 8) > 0.5), ctx=ctx)
    matches = nd.array(f32([[0, 1, 1], [1, 0, 0]]), ctx=ctx)
    cls = nd.array(f32([[2, 0, 1], [1, 2, 0]]), ctx=ctx)
    f = nd.contrib.mrcnn_mask_target
    return {"x": f(rois, masks, matches, cls, num_rois=3, num_classes=3,
                   mask_size=(4, 4)),
            "aligned": f(rois, masks, matches, cls, num_rois=3,
                         num_classes=3, mask_size=(3, 5), sample_ratio=1,
                         aligned=True)}


@case("DeformableConvolution", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (2, 4, 6, 6), 1)
    off = nd.array(f32(_r(2).uniform(-1.5, 1.5, (2, 2 * 9 * 2, 4, 4))),
                   ctx=ctx)
    w, b = _m(nd, ctx, (4, 2, 3, 3), 3), _m(nd, ctx, (4,), 4)
    off1 = nd.array(f32(_r(5).uniform(-1.5, 1.5, (2, 2 * 4, 4, 4))),
                    ctx=ctx)
    return {"groups": nd.DeformableConvolution(
                x, off, w, b, kernel=(3, 3), num_filter=4, num_group=2,
                num_deformable_group=2),
            "strided": nd.DeformableConvolution(
                x, off1, _m(nd, ctx, (3, 4, 2, 2), 6), None, kernel=(2, 2),
                num_filter=3, stride=(2, 2), pad=(1, 1), dilate=(1, 1),
                no_bias=True)}


@case("Proposal", SUMS)
def _(nd, ctx):
    r = _r(66)
    n, na, fh, fw = 2, 3, 4, 5
    cls_prob = nd.array(f32(r.rand(n, 2 * na, fh, fw)), ctx=ctx)
    bbox = nd.array(f32(r.uniform(-0.3, 0.3, (n, 4 * na, fh, fw))), ctx=ctx)
    im_info = nd.array(f32([[64, 80, 1.0], [60, 70, 0.5]]), ctx=ctx)
    return {"x": nd.Proposal(cls_prob, bbox, im_info, rpn_pre_nms_top_n=40,
                             rpn_post_nms_top_n=10, threshold=0.7,
                             rpn_min_size=8, scales=(2, 4, 8), ratios=(1,),
                             output_score=True),
            "rois": nd.Proposal(cls_prob, bbox, im_info,
                                rpn_pre_nms_top_n=20, rpn_post_nms_top_n=8,
                                threshold=0.5, rpn_min_size=4,
                                scales=(4,), ratios=(0.5, 1, 2))}


# ---------------------------------------------------------------------------
# contrib: multi-tensor helpers, FFT, sketches and the rest
# ---------------------------------------------------------------------------
@case("multi_sum_sq", SUMS)
def _(nd, ctx):
    a, b = _x234(nd, ctx), _m(nd, ctx, (5,), 1)
    return {"x": nd.contrib.multi_sum_sq(a, b, num_arrays=2),
            "bf16": nd.contrib.multi_sum_sq(a.astype("bfloat16"),
                                            num_arrays=1)}


@case("all_finite")
def _(nd, ctx):
    return {"ok": nd.contrib.all_finite(_x234(nd, ctx)),
            "inf": nd.contrib.all_finite(nd.array(_SPECIAL, ctx=ctx))}


@case("multi_all_finite")
def _(nd, ctx):
    x = _x234(nd, ctx)
    bad = nd.array(_SPECIAL, ctx=ctx)
    return {"ok": nd.contrib.multi_all_finite(x, x, num_arrays=2),
            "bad": nd.contrib.multi_all_finite(x, bad, num_arrays=2)}


@case("reset_arrays")
def _(nd, ctx):
    return {"x": nd.contrib.reset_arrays(
        _x234(nd, ctx), nd.array(i32([1, 2]), ctx=ctx), num_arrays=2)}


@case("_contrib_fft", SUMS)
def _(nd, ctx):
    return {"x": nd.contrib.fft(_m(nd, ctx, (2, 8), 1)),
            "3d": nd.contrib.fft(_m(nd, ctx, (3, 2, 5), 2))}


@case("_contrib_ifft", SUMS)
def _(nd, ctx):
    return {"x": nd.contrib.ifft(_m(nd, ctx, (2, 16), 1)),
            "3d": nd.contrib.ifft(_m(nd, ctx, (2, 3, 10), 2))}


@case("_contrib_count_sketch", SUMS)
def _(nd, ctx):
    h = nd.array(f32([0, 3, 1, 3, 2, 0]), ctx=ctx)
    s = nd.array(f32([1, -1, -1, 1, 1, -1]), ctx=ctx)
    return {"x": nd.contrib.count_sketch(_m(nd, ctx, (3, 6), 1), h, s,
                                         out_dim=4)}


def _hawkes_case(name):
    def fn(nd, ctx):
        # B = K = 3: the reference's expressions broadcast lda (K,) against
        # the (B,) marked intensity (ROADMAP Queue 3)
        r = _r(67)
        arr = lambda a: nd.array(f32(a), ctx=ctx)  # noqa: E731
        return {"x": getattr(nd, name)(
            arr(r.uniform(0.2, 1.0, 3)), arr(r.uniform(0.1, 0.5, 3)),
            arr(r.uniform(0.5, 2.0, 3)), arr(r.uniform(0, 0.5, (3, 3))),
            arr(r.uniform(0.1, 1.0, (3, 4))), arr(r.randint(0, 3, (3, 4))),
            arr([4, 2, 3]), arr([5.0, 3.0, 4.0]))}
    return fn


for _name in ("_contrib_hawkes_ll", "_contrib_hawkesll"):
    case(_name, SUMS)(_hawkes_case(_name))


@case("_contrib_quadratic", SUMS)
def _(nd, ctx):
    return {"x": nd.contrib.quadratic(_x234(nd, ctx), a=0.5, b=-2.0, c=1.5)}


@case("_contrib_index_copy")
def _(nd, ctx):
    old = _m(nd, ctx, (5, 3), 1)
    return {"x": nd.contrib.index_copy(old, nd.array(i32([4, 0, 2]),
                                                     ctx=ctx),
                                       _m(nd, ctx, (3, 3), 2))}


@case("_contrib_index_array")
def _(nd, ctx):
    x = _x234(nd, ctx)
    return {"all": nd.contrib.index_array(x),
            "axes": nd.contrib.index_array(x, axes=(0, 2))}


@case("_contrib_getnnz")
def _(nd, ctx):
    x = nd.array(f32([[0, 1, 0, 2], [3, 0, 0, 0], [0, 0, 5, 6]]), ctx=ctx)
    return {"all": nd.contrib.getnnz(x), "0": nd.contrib.getnnz(x, axis=0),
            "1": nd.contrib.getnnz(x, axis=1)}


@case("_contrib_gradientmultiplier")
def _(nd, ctx):
    return {"x": nd.contrib.gradientmultiplier(_x234(nd, ctx), scalar=0.5)}


@case("_contrib_round_ste")
def _(nd, ctx):
    return {"x": nd.contrib.round_ste(nd.array(_TIES, ctx=ctx))}


@case("_contrib_sign_ste")
def _(nd, ctx):
    return {"x": nd.contrib.sign_ste(nd.array(_TIES, ctx=ctx))}


def _raises(fn):
    try:
        fn()
    except Exception as e:        # the two packages' MXNetError
        return f"{type(e).__name__}: {e}"
    return "no error"


@case("_npx_constraint_check")
def _(nd, ctx):
    ok = nd.array(f32([1, 2, 3]), ctx=ctx)
    bad = nd.array(f32([1, 0, 3]), ctx=ctx)
    return {"ok": nd._npx_constraint_check(ok),
            "raises": _raises(lambda: nd._npx_constraint_check(
                bad, msg="lengths must be positive"))}


@case("BatchNormWithReLU", SUMS)
def _(nd, ctx):
    x, g, b, mm, mv = _bn_args(nd, ctx)
    return {"x": nd.BatchNormWithReLU(x, g, b, mm, mv, fix_gamma=False)}


@case("AdaptiveAvgPooling2D", SUMS)
def _(nd, ctx):
    x = _m(nd, ctx, (1, 2, 7, 5), 1)
    return {"grid": nd.AdaptiveAvgPooling2D(x, output_size=(3, 2)),
            "global": nd.AdaptiveAvgPooling2D(x),
            "square": nd.AdaptiveAvgPooling2D(x, output_size=4)}


@case("allclose")
def _(nd, ctx):
    a = _x234(nd, ctx)
    return {"same": nd.allclose(a, a + 1e-7),
            "far": nd.allclose(a, a + 1e-3),
            "tol": nd.allclose(a, a + 1e-3, atol=1e-2),
            "nan": nd.allclose(nd.array(_SPECIAL, ctx=ctx),
                               nd.array(_SPECIAL, ctx=ctx), equal_nan=True)}


@case("bipartite_matching")
def _(nd, ctx):
    d = nd.array(f32(_r(68).permutation(20).reshape(4, 5) / 20), ctx=ctx)
    db = nd.array(f32(_r(69).permutation(24).reshape(2, 3, 4) / 24),
                  ctx=ctx)
    f = nd.bipartite_matching
    return {"x": f(d, threshold=0.3), "ascend": f(d, threshold=0.6,
                                                  is_ascend=True),
            "topk": f(d, threshold=0.1, topk=2),
            "batched": f(db, threshold=0.2)}


# a CSR graph of 6 vertices: 0->{1, 2, 4}, 1->{2}, 2->{}, 3->{0, 5},
# 4->{1, 3, 5}, 5->{0}; edge data = 10 + edge id
_INDPTR = f32([0, 3, 4, 4, 6, 9, 10])
_INDICES = f32([1, 2, 4, 2, 0, 5, 1, 3, 5, 0])
_EDATA = f32(10 + onp.arange(10))


def _graph(nd, ctx):
    return (nd.array(_INDPTR, ctx=ctx), nd.array(_INDICES, ctx=ctx),
            nd.array(_EDATA, ctx=ctx))


@case("edge_id")
def _(nd, ctx):
    ip, ind, dat = _graph(nd, ctx)
    u = nd.array(f32([0, 0, 1, 2, 3, 4, 5, 4]), ctx=ctx)
    v = nd.array(f32([1, 4, 2, 0, 5, 3, 0, 0]), ctx=ctx)
    return {"x": nd.edge_id(ip, ind, dat, u, v)}


@case("dgl_adjacency")
def _(nd, ctx):
    ip, ind, _ = _graph(nd, ctx)
    return {"x": nd.dgl_adjacency(ip, ind)}


@case("dgl_csr_neighbor_uniform_sample")
def _(nd, ctx):
    ip, ind, _ = _graph(nd, ctx)
    seeds = nd.array(f32([0, 4]), ctx=ctx)
    f = nd.dgl_csr_neighbor_uniform_sample
    return {"x": f(ip, ind, seeds, num_neighbor=2, max_num_vertices=8,
                   seed=3),
            "cap": f(ip, ind, seeds, num_neighbor=3, max_num_vertices=4,
                     seed=5)}


@case("dgl_csr_neighbor_non_uniform_sample")
def _(nd, ctx):
    ip, ind, _ = _graph(nd, ctx)
    prob = nd.array(f32([0.5, 0.1, 0.0, 0.9, 0.3, 0.2]), ctx=ctx)
    seeds = nd.array(f32([0, 3, 4]), ctx=ctx)
    return {"x": nd.dgl_csr_neighbor_non_uniform_sample(
        prob, ip, ind, seeds, num_neighbor=2, max_num_vertices=8, seed=7)}


@case("dgl_subgraph")
def _(nd, ctx):
    ip, ind, dat = _graph(nd, ctx)
    vids = nd.array(f32([0, 1, 4, 5]), ctx=ctx)
    return {"x": nd.dgl_subgraph(ip, ind, dat, vids),
            "mapping": nd.dgl_subgraph(ip, ind, dat, vids,
                                       return_mapping=True)}


@case("dgl_graph_compact")
def _(nd, ctx):
    ip = nd.array(f32([0, 2, 3, 5, 5, 5]), ctx=ctx)
    ind = nd.array(f32([1, 4, -1, 0, 2]), ctx=ctx)
    dat = nd.array(f32([7, 8, 9, 10, 11]), ctx=ctx)
    return {"x": nd.dgl_graph_compact(ip, ind, dat, graph_sizes=3),
            "mapping": nd.dgl_graph_compact(ip, ind, dat, graph_sizes=4,
                                            return_mapping=True)}


@case("IdentityAttachKLSparseReg", SUMS)
def _(nd, ctx):
    x = nd.array(f32(_r(70).uniform(0.05, 0.95, (8, 4))), ctx=ctx)
    prev = nd.array(f32([0.5, 0.2, 0.7, 0.4]), ctx=ctx)
    f = nd.IdentityAttachKLSparseReg
    return {"x": f(x, sparseness_target=0.2, penalty=0.01),
            "ema": f(x, prev, momentum=0.8)}


# ---------------------------------------------------------------------------
# the optimizer update ops (ops/optimizer_ops.py): (3, 4) weights, seeded
# gradients and states (second moments positive), a clip that bites, the
# multi-precision forms on fp16 weights over f32 masters
# ---------------------------------------------------------------------------
_OPT = dict(rescale_grad=0.5, clip_gradient=0.4)


def _wg(nd, ctx, seed=40, n=2):
    return [_m(nd, ctx, (3, 4), seed + i) for i in range(n)]


def _pos(nd, ctx, seed):
    return nd.array(_r(seed).uniform(0.1, 1.0, (3, 4)).astype(onp.float32),
                    ctx=ctx)


def _half(nd, ctx, w):
    return nd.array(w.asnumpy(), ctx=ctx, dtype="float16")


@case("sgd_update", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    return {"wd": nd.sgd_update(w, g, lr=0.1, wd=0.01, **_OPT),
            "plain": nd.sgd_update(w, g, lr=0.1)}


@case("sgd_mom_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"mom": nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, wd=0.01,
                                     **_OPT)}


@case("mp_sgd_update", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    return {"mp": nd.mp_sgd_update(_half(nd, ctx, w), _half(nd, ctx, g), w,
                                   lr=0.1, wd=0.01, **_OPT)}


@case("mp_sgd_mom_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"mp": nd.mp_sgd_mom_update(_half(nd, ctx, w), _half(nd, ctx, g),
                                       m, w, lr=0.1, momentum=0.9, wd=0.01,
                                       **_OPT)}


@case("nag_mom_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"nag": nd.nag_mom_update(w, g, m, lr=0.1, momentum=0.9, wd=0.01,
                                     **_OPT)}


@case("mp_nag_mom_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"mp": nd.mp_nag_mom_update(_half(nd, ctx, w), _half(nd, ctx, g),
                                       m, w, lr=0.1, momentum=0.9, wd=0.01,
                                       **_OPT)}


@case("signsgd_update", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    return {"sign": nd.signsgd_update(w, g, lr=0.1, wd=0.01, **_OPT)}


@case("signum_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"signum": nd.signum_update(w, g, m, lr=0.1, momentum=0.9,
                                       wd=0.01, wd_lh=0.02, **_OPT)}


@case("adam_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"adam": nd.adam_update(w, g, m, _pos(nd, ctx, 50), lr=0.01,
                                   wd=0.01, **_OPT)}


@case("adamw_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"adamw": nd.adamw_update(w, g, m, _pos(nd, ctx, 50), lr=0.01,
                                     eta=0.5, wd=0.01, **_OPT)}


@case("mp_adamw_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"mp": nd.mp_adamw_update(_half(nd, ctx, w), _half(nd, ctx, g), m,
                                     _pos(nd, ctx, 50), w, lr=0.01, eta=0.5,
                                     wd=0.01, **_OPT)}


@case("rmsprop_update", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    return {"rms": nd.rmsprop_update(w, g, _pos(nd, ctx, 50), lr=0.01,
                                     wd=0.01, clip_weights=1.5, **_OPT)}


@case("rmspropalex_update", SUMS)
def _(nd, ctx):
    w, g, ga, delta = _wg(nd, ctx, n=4)
    n = nd.array(_r(51).uniform(2.0, 3.0, (3, 4)).astype(onp.float32),
                 ctx=ctx)
    return {"alex": nd.rmspropalex_update(w, g, n, ga * 0.1, delta, lr=0.01,
                                          wd=0.01, clip_weights=1.5, **_OPT)}


@case("ftrl_update", SUMS)
def _(nd, ctx):
    w, g, z = _wg(nd, ctx, n=3)
    return {"ftrl": nd.ftrl_update(w, g, z, _pos(nd, ctx, 50), lr=0.1,
                                   lamda1=0.05, wd=0.01, **_OPT)}


@case("ftml_update", SUMS)
def _(nd, ctx):
    w, g, z = _wg(nd, ctx, n=3)
    return {"ftml": nd.ftml_update(w, g, _pos(nd, ctx, 52),
                                   _pos(nd, ctx, 50), z, lr=0.1, t=3,
                                   wd=0.01, rescale_grad=0.5, clip_grad=0.4)}


@case("lamb_update_phase1", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"bc": nd.lamb_update_phase1(w, g, m, _pos(nd, ctx, 50), t=3,
                                        wd=0.01, **_OPT),
            "raw": nd.lamb_update_phase1(w, g, m, _pos(nd, ctx, 50), t=3,
                                         bias_correction=False)}


@case("lamb_update_phase2", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    r1, r2 = nd.array(f32([2.0]), ctx=ctx), nd.array(f32([0.5]), ctx=ctx)
    return {"ratio": nd.lamb_update_phase2(w, g, r1, r2, lr=0.1),
            "bounded": nd.lamb_update_phase2(w, g, r1, r2, lr=0.1,
                                             lower_bound=2.5,
                                             upper_bound=3.0)}


@case("mp_lamb_update_phase1", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"mp": nd.mp_lamb_update_phase1(
        _half(nd, ctx, w), _half(nd, ctx, g), m, _pos(nd, ctx, 50), w, t=3,
        wd=0.01, **_OPT)}


@case("mp_lamb_update_phase2", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    r1, r2 = nd.array(f32([2.0]), ctx=ctx), nd.array(f32([0.5]), ctx=ctx)
    return {"mp": nd.mp_lamb_update_phase2(_half(nd, ctx, w), g, r1, r2, w,
                                           lr=0.1)}


@case("group_adagrad_update", SUMS)
def _(nd, ctx):
    w, g = _wg(nd, ctx)
    h = nd.array(_r(53).uniform(0.1, 1.0, (3, 1)).astype(onp.float32),
                 ctx=ctx)
    return {"group": nd.group_adagrad_update(w, g, h, lr=0.1,
                                             rescale_grad=0.5,
                                             clip_gradient=0.4)}


@case("sparse_adagrad_update", SUMS)
def _(nd, ctx):
    w = _m(nd, ctx, (6, 4), 40)
    rows = _m(nd, ctx, (2, 4), 41)
    idx = nd.array(i32([1, 4]), ctx=ctx)
    h = nd.array(_r(50).uniform(0.1, 1.0, (6, 4)).astype(onp.float32),
                 ctx=ctx)
    return {"lazy": nd.sparse_adagrad_update(w, rows, idx, h, lr=0.1,
                                             **_OPT)}


def _groups(nd, ctx, per, n=3, half=False):
    """n interleaved groups of ``per`` (3, 4) tensors: (w, g, states...),
    with the master last and the weight and gradient fp16 when ``half``."""
    out = []
    for i in range(n):
        ts = _wg(nd, ctx, seed=60 + 10 * i, n=per)
        if half:
            ts = [_half(nd, ctx, ts[0]), _half(nd, ctx, ts[1])] + ts[2:-1] \
                + [ts[0]]
        out += ts
    return out


_LRS, _WDS = [0.1, 0.05, 0.2], [0.0, 0.01, 0.02]


@case("multi_sgd_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.multi_sgd_update(*_groups(nd, ctx, 2), lrs=_LRS,
                                         wds=_WDS, num_weights=3, **_OPT)}


@case("multi_sgd_mom_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.multi_sgd_mom_update(
        *_groups(nd, ctx, 3), lrs=_LRS, wds=_WDS, num_weights=3,
        momentum=0.9, **_OPT)}


@case("multi_mp_sgd_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.multi_mp_sgd_update(
        *_groups(nd, ctx, 3, half=True), lrs=_LRS, wds=_WDS, num_weights=3,
        **_OPT)}


@case("multi_mp_sgd_mom_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.multi_mp_sgd_mom_update(
        *_groups(nd, ctx, 4, half=True), lrs=_LRS, wds=_WDS, num_weights=3,
        momentum=0.9, **_OPT)}


def _lrs_wds(nd, ctx):
    return nd.array(f32(_LRS), ctx=ctx), nd.array(f32(_WDS), ctx=ctx)


@case("preloaded_multi_sgd_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.preloaded_multi_sgd_update(
        *_groups(nd, ctx, 2), *_lrs_wds(nd, ctx), num_weights=3, **_OPT)}


@case("preloaded_multi_sgd_mom_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.preloaded_multi_sgd_mom_update(
        *_groups(nd, ctx, 3), *_lrs_wds(nd, ctx), num_weights=3,
        momentum=0.9, **_OPT)}


@case("preloaded_multi_mp_sgd_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.preloaded_multi_mp_sgd_update(
        *_groups(nd, ctx, 3, half=True), *_lrs_wds(nd, ctx), num_weights=3,
        **_OPT)}


@case("preloaded_multi_mp_sgd_mom_update", SUMS)
def _(nd, ctx):
    return {"multi": nd.preloaded_multi_mp_sgd_mom_update(
        *_groups(nd, ctx, 4, half=True), *_lrs_wds(nd, ctx), num_weights=3,
        momentum=0.9, **_OPT)}


@case("multi_lars", SUMS)
def _(nd, ctx):
    lrs, wds = _lrs_wds(nd, ctx)
    wsq = nd.array(f32([4.0, 0.0, 2.5]), ctx=ctx)
    gsq = nd.array(f32([1.0, 3.0, 0.5]), ctx=ctx)
    return {"rates": nd.multi_lars(lrs, wsq, gsq, wds, eta=0.01, eps=1e-8,
                                   rescale_grad=0.5)}


@case("multi_adamw_update", SUMS)
def _(nd, ctx):
    ts = _groups(nd, ctx, 4)
    for i in range(3):   # the second moments positive
        ts[4 * i + 3] = _pos(nd, ctx, 70 + i)
    return {"multi": nd.multi_adamw_update(
        *ts, lrs=_LRS, etas=[1.0, 0.5, 0.25], wds=_WDS, num_weights=3,
        **_OPT)}


@case("multi_lamb_update", SUMS)
def _(nd, ctx):
    ts = _groups(nd, ctx, 4)
    for i in range(3):
        ts[4 * i + 3] = _pos(nd, ctx, 70 + i)
    return {"multi": nd.multi_lamb_update(
        *ts, lrs=_LRS, wds=_WDS, num_weights=3, step_count=[1, 2, 3],
        lower_bound=0.1, upper_bound=10.0, **_OPT)}


@case("lars_update", SUMS)
def _(nd, ctx):
    w, g, m = _wg(nd, ctx, n=3)
    return {"lars": nd.lars_update(w, g, m, lr=0.1, eta=0.01, momentum=0.9,
                                   wd=0.01, **_OPT)}


@case("multi_mp_adamw_update", SUMS)
def _(nd, ctx):
    ts = _groups(nd, ctx, 5, half=True)
    for i in range(3):
        ts[5 * i + 3] = _pos(nd, ctx, 70 + i)
    return {"multi": nd.multi_mp_adamw_update(
        *ts, lrs=_LRS, etas=[1.0, 0.5, 0.25], wds=_WDS, num_weights=3,
        **_OPT)}


@case("multi_mp_lamb_update", SUMS)
def _(nd, ctx):
    ts = _groups(nd, ctx, 5, half=True)
    for i in range(3):
        ts[5 * i + 3] = _pos(nd, ctx, 70 + i)
    return {"multi": nd.multi_mp_lamb_update(
        *ts, lrs=_LRS, wds=_WDS, num_weights=3, step_count=[1, 2, 3],
        **_OPT)}


@case("_contrib_SparseEmbedding")
def _(nd, ctx):
    w = _m(nd, ctx, (5, 3), 1)
    return {"x": nd._contrib_SparseEmbedding(
        nd.array(i32([[0, 4], [2, 4]]), ctx=ctx), w, input_dim=5,
        output_dim=3, deterministic=True)}


# ---------------------------------------------------------------------------
# Custom: a Python operator registered in the package ``nd`` belongs to
# ---------------------------------------------------------------------------
def _register_square_plus(nd):
    """Register ``op_cases_square_plus`` (y = x * x + x, dy = (2 x + 1)
    dout) with the ``operator`` module of the package ``nd`` comes from
    (already imported: it is the caller's)."""
    import sys
    op = sys.modules[nd.__name__.partition(".")[0]].operator

    @op.register("op_cases_square_plus")
    class _Prop(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class _Op(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    self.assign(out_data[0], req[0], x * x + x)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                (2 * in_data[0] + 1) * out_grad[0])
            return _Op()


@case("Custom", SUMS)
def _custom(nd, ctx):
    _register_square_plus(nd)
    x = nd.array(_r(41).uniform(-2, 2, (6, 7)).astype(onp.float32), ctx=ctx)
    return {"y": nd.Custom(x, op_type="op_cases_square_plus")}


# ---------------------------------------------------------------------------
# quantization (ops/quantization.py): seeded float32 inputs quantized by the
# op under test or by quantize_v2; codes, int32 accumulators and ranges
# exact. The products take K past 1,040 (127 * 127 * K > 2^24), a grouped
# dilated strided convolution and rows fewer than 17.
# ---------------------------------------------------------------------------
def _q8(nd, ctx, a, **kw):
    return nd.contrib.quantize_v2(nd.array(f32(a), ctx=ctx), **kw)


@case("_contrib_quantize_v2")
def _(nd, ctx):
    r = _r(60)
    x = r.randn(6, 7).astype(onp.float32) * 3
    ties = f32([-1.5, -0.5, 0.5, 1.5, 2.5, 127.0, 300.0, -300.0])
    return {"int8": _q8(nd, ctx, x), "uint8": _q8(nd, ctx, x + 4,
                                                 out_type="uint8"),
            "calib": _q8(nd, ctx, x, min_calib_range=-2.0,
                         max_calib_range=1.5),
            "ties": _q8(nd, ctx, ties, min_calib_range=-127.0,
                        max_calib_range=127.0),
            "zero": _q8(nd, ctx, onp.zeros((3,), onp.float32))}


@case("_contrib_dequantize", F32_ULPS)
def _(nd, ctx):
    r = _r(61)
    x = r.randn(5, 6).astype(onp.float32)
    q, mn, mx = _q8(nd, ctx, x)
    u, umn, umx = _q8(nd, ctx, x, out_type="uint8")
    acc = nd.array(r.randint(-2 ** 30, 2 ** 30, (4, 3)).astype(onp.int32),
                   ctx=ctx, dtype="int32")
    return {"int8": nd.contrib.dequantize(q, mn, mx),
            "uint8": nd.contrib.dequantize(u, umn, umx),
            "int32": nd.contrib.dequantize(acc, mn * 1000, mx * 1000)}


@case("_contrib_requantize")
def _(nd, ctx):
    r = _r(62)
    acc = nd.array(r.randint(-2 ** 24, 2 ** 24, (6, 5)).astype(onp.int32),
                   ctx=ctx, dtype="int32")
    mn = nd.array(f32(-1.7e5), ctx=ctx)
    mx = nd.array(f32(1.7e5), ctx=ctx)
    return {"own": nd.contrib.requantize(acc, mn, mx),
            "calib": nd.contrib.requantize(acc, mn, mx,
                                           min_calib_range=-0.5,
                                           max_calib_range=0.75)}


@case("_contrib_quantized_fully_connected")
def _(nd, ctx):
    r = _r(63)
    out = {}
    for name, xs, ws, flat in (("small", (5, 20), (9, 20), True),
                               ("k1500", (19, 1500), (12, 1500), True),
                               ("flatten", (3, 4, 5), (6, 20), True),
                               ("last_axis", (2, 3, 5), (7, 5), False)):
        q, qmn, qmx = _q8(nd, ctx, r.randn(*xs))
        w, wmn, wmx = _q8(nd, ctx, r.randn(*ws) * 0.1)
        out[name] = nd.contrib.quantized_fully_connected(
            q, w, qmn, qmx, wmn, wmx, num_hidden=ws[0], flatten=flat)
    return out


@case("_contrib_quantized_conv")
def _(nd, ctx):
    r = _r(64)
    out = {}
    for name, xs, ws, kw in (
            ("pad", (2, 3, 8, 8), (4, 3, 3, 3), dict(pad=(1, 1))),
            ("group_dilate_stride", (2, 4, 11, 9), (6, 2, 3, 3),
             dict(num_group=2, dilate=(2, 2), stride=(2, 1), pad=(2, 1))),
            ("k1152", (1, 128, 5, 5), (8, 128, 3, 3), dict(pad=(1, 1))),
            ("conv1d", (2, 3, 10), (5, 3, 3), dict(stride=(2,))),
            ("pointwise", (2, 16, 4, 4), (24, 16, 1, 1), {})):
        q, qmn, qmx = _q8(nd, ctx, r.randn(*xs))
        w, wmn, wmx = _q8(nd, ctx, r.randn(*ws) * 0.1)
        out[name] = nd.contrib.quantized_conv(
            q, w, qmn, qmx, wmn, wmx, kernel=ws[2:], num_filter=ws[0], **kw)
    return out


@case("_contrib_calibrate_entropy", TRANSCENDENTAL)
def _(nd, ctx):
    r = _r(65)
    a = r.randn(20000).astype(onp.float32)
    a[:20] *= 12
    hist, edges = onp.histogram(a, bins=401, range=(-40, 40))
    th, div = nd.contrib.calibrate_entropy(
        nd.array(hist.astype(onp.float32), ctx=ctx),
        nd.array(edges.astype(onp.float32), ctx=ctx), num_quantized_bins=63)
    return {"threshold": th, "divergence": div}


@case("_contrib_quantized_pooling")
def _(nd, ctx):
    r = _r(66)
    q, mn, mx = _q8(nd, ctx, r.uniform(-1, 1, (2, 3, 7, 7)))
    u, umn, umx = _q8(nd, ctx, r.uniform(0, 2, (1, 2, 6, 6)),
                      out_type="uint8")
    pool = nd.contrib.quantized_pooling
    return {"max": pool(q, mn, mx, kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1), pool_type="max"),
            "avg": pool(q, mn, mx, kernel=(2, 2), stride=(2, 2),
                        pool_type="avg"),
            "avg3": pool(q, mn, mx, kernel=(3, 3), stride=(1, 1),
                         pool_type="avg"),
            "global": pool(q, mn, mx, global_pool=True, pool_type="avg"),
            "uint8_max": pool(u, umn, umx, kernel=(2, 2), pool_type="max")}


@case("_contrib_quantized_act")
def _(nd, ctx):
    r = _r(67)
    q, mn, mx = _q8(nd, ctx, r.uniform(-1, 1, (4, 6)))
    x = r.uniform(-2, 3, (32,)).astype(onp.float32)
    arr = lambda v: nd.array(f32([v]), ctx=ctx)  # noqa: E731
    u, umn, umx = nd.contrib.quantize(nd.array(x, ctx=ctx), arr(-2.0),
                                      arr(3.0))
    p, pmn, pmx = nd.contrib.quantize(
        nd.array(onp.linspace(1.0, 3.0, 16).astype(onp.float32), ctx=ctx),
        arr(1.0), arr(3.0))
    act = nd.contrib.quantized_act
    return {"int8": act(q, mn, mx, act_type="relu"),
            "uint8": act(u, umn, umx), "uint8_positive_min": act(p, pmn, pmx)}


@case("_contrib_quantized_flatten")
def _(nd, ctx):
    q, mn, mx = _q8(nd, ctx, _r(68).randn(2, 3, 4, 5))
    return {"flat": nd.contrib.quantized_flatten(q, mn, mx)}


@case("_contrib_quantized_concat")
def _(nd, ctx):
    r = _r(69)
    parts = [_q8(nd, ctx, r.randn(2, c, 3) * s)
             for c, s in ((3, 0.5), (2, 2.0), (4, 1.0))]
    xs, mins, maxs = zip(*parts)
    return {"dim1": nd.contrib.quantized_concat(*xs, *mins, *maxs, dim=1,
                                                num_args=3)}


@case("_contrib_quantized_elemwise_add")
def _(nd, ctx):
    r = _r(70)
    a, amn, amx = _q8(nd, ctx, r.randn(5, 6) * 0.7)
    b, bmn, bmx = _q8(nd, ctx, r.randn(5, 6) * 2.3)
    return {"sum": nd.contrib.quantized_elemwise_add(a, b, amn, amx,
                                                     bmn, bmx)}


@case("_contrib_quantize")
def _(nd, ctx):
    r = _r(71)
    x = nd.array(r.uniform(-2, 3, (4, 5)).astype(onp.float32), ctx=ctx)
    mn, mx = nd.array(f32([-2.0]), ctx=ctx), nd.array(f32([3.0]), ctx=ctx)
    return {"uint8": nd.contrib.quantize(x, mn, mx),
            "int8": nd.contrib.quantize(x, mn, mx, out_type="int8")}


@case("_contrib_quantized_batch_norm")
def _(nd, ctx):
    r = _r(72)
    q, mn, mx = _q8(nd, ctx, r.uniform(-1, 1, (2, 3, 4, 4)))
    arr = lambda v: nd.array(f32(v), ctx=ctx)  # noqa: E731
    return {"bn": nd.contrib.quantized_batch_norm(
        q, arr(r.rand(3) + 0.5), arr(r.randn(3) * 0.1),
        arr(r.randn(3) * 0.1), arr(r.rand(3) + 0.5), mn, mx,
        min_calib_range=-1.9, max_calib_range=2.3)}


@case("_contrib_quantized_elemwise_mul")
def _(nd, ctx):
    r = _r(73)
    a, amn, amx = _q8(nd, ctx, r.uniform(-1, 1, (16,)))
    b, bmn, bmx = _q8(nd, ctx, r.uniform(-2, 2, (16,)))
    mul = nd.contrib.quantized_elemwise_mul
    return {"int32": mul(a, b, amn, amx, bmn, bmx),
            "float": mul(a, b, amn, amx, bmn, bmx, enable_float_output=True),
            "calib": mul(a, b, amn, amx, bmn, bmx, min_calib_range=-1.5,
                         max_calib_range=1.25)}


@case("_contrib_quantized_embedding")
def _(nd, ctx):
    r = _r(74)
    w, wmn, wmx = _q8(nd, ctx, r.uniform(-1, 1, (10, 4)))
    idx = nd.array(f32([1, 3, 7, 3, 0]), ctx=ctx)
    return {"rows": nd.contrib.quantized_embedding(idx, w, wmn, wmx,
                                                   input_dim=10,
                                                   output_dim=4)}


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------
def SAMPLER_CALLS(nd, ctx, key=()):
    """name -> ``draw(n)``: one call of each sampler on ``ctx`` drawing
    about n values (``key``: the leading key input the JAX package's
    ``_sample_unique_zipfian`` takes)."""
    def arr(v):
        return nd.array(onp.asarray(v, onp.float32), ctx=ctx)
    r = nd.random
    return {
        "_random_uniform": lambda n: r.uniform(-1, 3, shape=(n,), ctx=ctx),
        "_random_normal": lambda n: r.normal(2.0, 0.5, shape=(n,), ctx=ctx),
        "_random_gamma": lambda n: r.gamma(2.0, 1.5, shape=(n,), ctx=ctx),
        "_random_exponential": lambda n: r.exponential(2.0, shape=(n,),
                                                       ctx=ctx),
        "_random_poisson": lambda n: r.poisson(3.0, shape=(n,), ctx=ctx),
        "_random_negative_binomial": lambda n: r.negative_binomial(
            3, 0.4, shape=(n,), ctx=ctx),
        "_random_generalized_negative_binomial":
            lambda n: r.generalized_negative_binomial(2.0, 0.5, shape=(n,),
                                                      ctx=ctx),
        "_random_randint": lambda n: r.randint(0, 10, shape=(n,), ctx=ctx),
        "_random_bernoulli": lambda n: r.bernoulli(0.3, shape=(n,),
                                                   ctx=ctx),
        "_random_dirichlet": lambda n: r.dirichlet(
            arr([1.0, 2.0, 3.0]), shape=(n // 10,), ctx=ctx),
        "_sample_multinomial": lambda n: r.multinomial(
            arr([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]]), shape=(n // 10,)),
        "_shuffle": lambda n: r.shuffle(arr(onp.arange(n // 10 * 2)
                                            .reshape(-1, 2))),
        "_sample_unique_zipfian": lambda n: nd._sample_unique_zipfian(
            *key, range_max=1000, shape=(n,)),
        "_sample_uniform": lambda n: r.sample_uniform(
            arr([0.0, 2.0]), arr([1.0, 6.0]), shape=(n // 10,)),
        "_sample_normal": lambda n: nd.sample_normal(
            arr([0.0, 5.0]), arr([1.0, 2.0]), shape=(n // 10,)),
        "_sample_gamma": lambda n: r.sample_gamma(
            arr([2.0, 0.5]), arr([1.0, 3.0]), shape=(n // 10,)),
        "_sample_exponential": lambda n: r.sample_exponential(
            arr([1.0, 0.25]), shape=(n // 10,)),
        "_sample_poisson": lambda n: r.sample_poisson(
            arr([1.0, 6.0]), shape=(n // 10,)),
        "_sample_negative_binomial": lambda n: r.sample_negative_binomial(
            arr([3.0, 5.0]), arr([0.4, 0.7]), shape=(n // 10,)),
        "_sample_generalized_negative_binomial":
            lambda n: r.sample_generalized_negative_binomial(
                arr([2.0, 4.0]), arr([0.5, 0.1]), shape=(n // 10,)),
    }


# (mean, var) of each draw, per parameter row for the _sample_ forms
MOMENTS = {
    "_random_uniform": (1.0, 16 / 12),
    "_random_normal": (2.0, 0.25),
    "_random_gamma": (3.0, 4.5),
    "_random_exponential": (2.0, 4.0),
    "_random_poisson": (3.0, 3.0),
    "_random_negative_binomial": (4.5, 11.25),
    "_random_generalized_negative_binomial": (2.0, 4.0),
    "_random_randint": (4.5, 8.25),
    "_random_bernoulli": (0.3, 0.21),
    "_sample_uniform": ([0.5, 4.0], [1 / 12, 16 / 12]),
    "_sample_normal": ([0.0, 5.0], [1.0, 4.0]),
    "_sample_gamma": ([2.0, 1.5], [2.0, 4.5]),
    "_sample_exponential": ([1.0, 4.0], [1.0, 16.0]),
    "_sample_poisson": ([1.0, 6.0], [1.0, 6.0]),
    "_sample_negative_binomial": ([4.5, 5 * 0.3 / 0.7],
                                  [11.25, 5 * 0.3 / 0.49]),
    "_sample_generalized_negative_binomial": ([2.0, 4.0], [4.0, 5.6]),
}


def moment_errors(name, draws):
    """What ``draws`` (numpy, from ``SAMPLER_CALLS[name]``) get wrong:
    the mean within five standard errors and the variance within five
    (approximate) standard errors plus 2% of the formula's, or the
    sampler's own property (sums to 1, frequencies, a permutation, the
    Zipfian mass at 0). Empty when they hold."""
    x = onp.asarray(draws, onp.float64)
    n = x.shape[-1] if x.ndim else 1
    errs = []
    if name in MOMENTS:
        mean, var = (onp.asarray(v, onp.float64) for v in MOMENTS[name])
        m, v = x.mean(-1), x.var(-1)
        if not (onp.abs(m - mean) < 5 * onp.sqrt(var / n) + 1e-9).all():
            errs.append(f"mean {m} (want {mean})")
        if not (onp.abs(v - var) < 5 * onp.sqrt(8 * var ** 2 / n)
                + 0.02 * var).all():
            errs.append(f"var {v} (want {var})")
    elif name == "_random_dirichlet":
        if not onp.allclose(x.sum(-1), 1.0, rtol=1e-5) or \
                (onp.abs(x.mean(0) - [1 / 6, 1 / 3, 1 / 2]) > 5e-3).any():
            errs.append(f"rows sum to 1, mean {x.mean(0)}")
    elif name == "_sample_multinomial":
        for row, p in zip(x, ([0.1, 0.2, 0.7], [0.5, 0.25, 0.25])):
            freq = onp.bincount(row.astype(int), minlength=3) / row.size
            p = onp.asarray(p)
            if (onp.abs(freq - p) > 5 * onp.sqrt(p * (1 - p) /
                                                 row.size)).any():
                errs.append(f"frequencies {freq} (want {p})")
    elif name == "_shuffle":
        first = onp.arange(0, x.size, 2)
        if onp.array_equal(x[:, 0], first) or \
                not onp.array_equal(onp.sort(x[:, 0]), first) or \
                (x[:, 1] - x[:, 0] != 1).any():
            errs.append("not a permutation of the rows")
    elif name == "_sample_unique_zipfian":
        p0 = onp.log(2.0) / onp.log(1001.0)
        if x.min() < 0 or x.max() >= 1000 or \
                abs((x == 0).mean() - p0) >= 5 * onp.sqrt(p0 / n):
            errs.append(f"range [{x.min()}, {x.max()}], P(0) "
                        f"{(x == 0).mean()} (want {p0:.4f})")
    else:
        errs.append("no check")
    return errs
