"""Gradients of the port's differentiable ops through ``mt.autograd``
against the JAX package's through ``mx.autograd``, both on the CPU, from
the same seeded numpy inputs: the output of each op is contracted with a
seeded head gradient, and every array input marked differentiable gets
its gradient compared, within 1e-5 relative (1e-4 for the recurrences
that sum over many steps). The heads whose gradient the reference defines
rather than derives (``SoftmaxOutput``, the regression outputs,
``MakeLoss``, ``SVMOutput``) ignore the head gradient; ``CTCLoss``'s
gradient comes from its recursion in both packages."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

TOL = 1e-5


def _r(seed):
    return onp.random.RandomState(seed)


def _n(shape, seed, lo=None, hi=None):
    r = _r(seed)
    a = r.randn(*shape) if lo is None else r.uniform(lo, hi, shape)
    return onp.asarray(a, dtype=onp.float32)


GRADS = {}


def grad_case(name, tol=TOL):
    def deco(fn):
        GRADS[name] = (fn, tol)
        return fn
    return deco


def _run(name):
    fn, tol = GRADS[name]
    inputs, diff, call = fn()
    results = []
    for pkg in (mx, mt):
        ctx = pkg.cpu()
        with ctx:
            arrs = {k: pkg.nd.array(v, ctx=ctx, dtype=v.dtype)
                    for k, v in inputs.items()}
            for k in diff:
                arrs[k].attach_grad()
            with pkg.autograd.record():
                out = call(pkg.nd, arrs)
                if isinstance(out, (list, tuple)):
                    out = out[0]
            head = pkg.nd.array(_n(out.shape, 99), ctx=ctx)
            out.backward(head)
            results.append({k: arrs[k].grad.asnumpy() for k in diff})
    ref, got = results
    for k in diff:
        assert got[k].dtype == ref[k].dtype, k
        onp.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol,
                                    err_msg=f"{name}: d{k}")


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
_UNARY = {"exp": None, "log": (0.3, 3), "sqrt": (0.3, 3), "rsqrt": (0.3, 3),
          "tanh": None, "sigmoid": None, "sin": None, "arctan": None,
          "erf": None, "gelu": None, "gelu_tanh": None, "softrelu": None,
          "softsign": None, "silu": None, "mish": None, "relu": None,
          "square": None, "reciprocal": (0.3, 3), "cbrt": (0.3, 3),
          "log1p": (0, 2), "expm1": None, "arcsinh": None,
          "arccosh": (1.2, 3), "gammaln": (0.5, 3), "abs": None,
          "hard_sigmoid": None}


def _unary_grad(name):
    lo_hi = _UNARY[name]

    def fn():
        x = _n((3, 4), 1, *(lo_hi or (-2, 2)))
        return {"x": x}, ["x"], lambda nd, a: getattr(nd, name)(a["x"])
    return fn


for _name in _UNARY:
    grad_case(_name)(_unary_grad(_name))


def _binary_grad(name, lo=-2, hi=2):
    def fn():
        return ({"a": _n((3, 4), 1, lo, hi), "b": _n((1, 4), 2, lo, hi)},
                ["a", "b"], lambda nd, a: getattr(nd, name)(a["a"], a["b"]))
    return fn


for _name in ("broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
              "arctan2"):
    grad_case(_name)(_binary_grad(_name))
grad_case("broadcast_div")(_binary_grad("broadcast_div", 0.5, 2))
grad_case("broadcast_power")(_binary_grad("broadcast_power", 0.5, 2))


@grad_case("_scalar_ops")
def _():
    def call(nd, a):
        x = a["x"]
        return (x + 1.5) * 2 - 3 / x + x ** 2 + 2 ** x + \
            nd._hypot_scalar(x, scalar=1.5) + nd._maximum_scalar(x, scalar=1)
    return {"x": _n((3, 4), 1, 0.5, 2)}, ["x"], call


@grad_case("clip")
def _():
    return {"x": _n((3, 4), 1)}, ["x"], \
        lambda nd, a: nd.clip(a["x"], a_min=-0.5, a_max=0.5)


@grad_case("leaky_relu")
def _():
    def call(nd, a):
        return nd.add_n(*[nd.leaky_relu(a["x"], act_type=t, slope=0.3)
                          for t in ("leaky", "elu", "selu", "gelu")])
    return {"x": _n((3, 4), 1) * 2}, ["x"], call


@grad_case("prelu")
def _():
    return ({"x": _n((2, 3, 4), 1), "g": _n((3,), 2)}, ["x", "g"],
            lambda nd, a: nd.prelu(a["x"], a["g"]))


@grad_case("smooth_l1")
def _():
    return {"x": _n((3, 4), 1) * 2}, ["x"], \
        lambda nd, a: nd.smooth_l1(a["x"], scalar=1.5)


@grad_case("where")
def _():
    c = (_r(3).rand(3, 4) > 0.5).astype(onp.float32)
    return ({"c": c, "a": _n((3, 4), 1), "b": _n((3, 4), 2)}, ["a", "b"],
            lambda nd, a: nd.where(a["c"], a["a"], a["b"]))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
@grad_case("reductions")
def _():
    def call(nd, a):
        x = a["x"]
        return nd.sum(x, axis=1) + nd.mean(x, axis=1) + \
            nd.prod(x, axis=1) * 0.1 + nd.max(x, axis=1) + \
            nd.min(x, axis=1) + nd.norm(x, axis=1) + \
            nd.logsumexp(x, axis=1) + nd.sum(x, axis=0, exclude=True)
    return {"x": _n((3, 4), 1, 0.5, 2)}, ["x"], call


@grad_case("cumsum")
def _():
    return {"x": _n((3, 4), 1)}, ["x"], \
        lambda nd, a: nd.cumsum(a["x"], axis=1) + nd.cumprod(a["x"], axis=1)


@grad_case("moments")
def _():
    def call(nd, a):
        m, v = nd.moments(a["x"], axes=(1,))
        return m + v
    return {"x": _n((3, 4), 1)}, ["x"], call


# ---------------------------------------------------------------------------
# tensor
# ---------------------------------------------------------------------------
@grad_case("shapes")
def _():
    def call(nd, a):
        x = a["x"]
        y = nd.transpose(nd.reshape(x, shape=(0, -1)), axes=(1, 0))
        y = nd.flatten(nd.swapaxes(nd.expand_dims(y, axis=0), dim1=0,
                                   dim2=1))
        z = nd.concat(nd.slice(x, begin=(0, 1), end=(2, 3)),
                      nd.slice_axis(x, axis=1, begin=0, end=2), dim=0)
        parts = nd.split(x, num_outputs=3, axis=1)
        w = nd.tile(nd.repeat(parts[0], repeats=2, axis=1), reps=(1, 2))
        return nd.sum(y) + nd.sum(z * z) + nd.sum(w * w) + \
            nd.sum(nd.reverse(x, axis=0) * x) + \
            nd.sum(nd.broadcast_to(nd.sum(x, axis=(1,), keepdims=True),
                                   shape=(2, 3, 4)))
    return {"x": _n((2, 3, 4), 1)}, ["x"], call


@grad_case("pad")
def _():
    def call(nd, a):
        w = (0, 0, 0, 0, 1, 2, 2, 1)
        return nd.pad(a["x"], mode="edge", pad_width=w) + \
            nd.pad(a["x"], mode="reflect", pad_width=w) + \
            nd.pad(a["x"], mode="constant", pad_width=w)
    return {"x": _n((1, 2, 4, 5), 1)}, ["x"], call


@grad_case("indexing")
def _():
    def call(nd, a):
        x = a["x"]
        t = nd.take(x, a["idx"], axis=1)
        p = nd.pick(x, a["pidx"])
        g = nd.gather_nd(x, a["gidx"])
        ta = nd.take_along_axis(x, a["aidx"], axis=1)
        bt = nd.batch_take(x, a["pidx"])
        return nd.sum(t * t) + nd.sum(p) + nd.sum(g * 3) + nd.sum(ta) + \
            nd.sum(bt) + nd.sum(nd.one_hot(a["pidx"], depth=4) * x)
    return ({"x": _n((3, 4), 1), "idx": onp.float32([0, 2, 2, 3]),
             "pidx": onp.float32([1, 3, 0]),
             "gidx": onp.int32([[0, 2, 2], [3, 1, 3]]),
             "aidx": onp.int32([[0, 0], [3, 1], [2, 2]])}, ["x"], call)


@grad_case("scatter")
def _():
    def call(nd, a):
        s = nd.scatter_nd(a["d"], a["idx"], shape=(3, 4))
        i = nd.index_add(a["lhs"], a["d"], a["idx"])
        c = nd.index_copy(a["lhs"], a["cidx"], a["new"])
        sa = nd.slice_assign(a["lhs"], a["new"][:, :2], begin=(0, 1),
                             end=(2, 3))
        return s + i * i + c + sa
    return ({"d": _n((3,), 1), "lhs": _n((3, 4), 2),
             "idx": onp.int32([[0, 2, 1], [3, 1, 0]]),
             "cidx": onp.int32([0, 2]), "new": _n((2, 4), 3)},
            ["d", "lhs", "new"], call)


@grad_case("sequence_ops")
def _():
    def call(nd, a):
        d, sl = a["d"], a["sl"]
        return nd.sum(nd.SequenceMask(d, sl, use_sequence_length=True) *
                      d) + nd.sum(nd.SequenceLast(
                          d, sl, use_sequence_length=True) ** 2) + \
            nd.sum(nd.SequenceReverse(d, sl, use_sequence_length=True) *
                   nd.arange_like(d, axis=0).reshape((5, 1, 1)))
    return ({"d": _n((5, 3, 2), 1), "sl": onp.float32([1, 3, 5])}, ["d"],
            call)


@grad_case("sort")
def _():
    x = (_r(2).permutation(12).reshape(3, 4) * 0.5).astype(onp.float32)
    return {"x": x}, ["x"], \
        lambda nd, a: nd.sort(a["x"]) * nd.sort(a["x"], axis=0,
                                                is_ascend=False)


@grad_case("products")
def _():
    def call(nd, a):
        return nd.sum(nd.dot(a["a"], a["b"])) + \
            nd.sum(nd.batch_dot(a["c"], a["d"], transpose_b=True) ** 2) + \
            nd.sum(nd.linalg_gemm2(a["c"], a["d"], transpose_b=True,
                                   alpha=0.5)) + \
            nd.sum(nd.einsum(a["a"], a["b"], subscripts="ij,jk->ik") ** 2) + \
            nd.sum(nd.khatri_rao(a["a"], a["b"].T) ** 2)
    return ({"a": _n((2, 3), 1), "b": _n((3, 4), 2), "c": _n((2, 3, 4), 3),
             "d": _n((2, 5, 4), 4)}, ["a", "b", "c", "d"], call)


@grad_case("linalg")
def _():
    m = _r(5).randn(3, 3)
    spd = (m @ m.T + 3 * onp.eye(3)).astype(onp.float32)
    low = (onp.tril(_r(6).randn(3, 3)) + 3 * onp.eye(3)).astype(onp.float32)

    def call(nd, a):
        return nd.sum(nd.linalg_potrf(a["spd"])) + \
            nd.sum(nd.linalg_trsm(a["low"], a["b"])) + \
            nd.sum(nd.linalg_inverse(a["spd"])) + \
            nd.linalg_det(a["spd"]) * 0.01 + \
            nd.linalg_sumlogdiag(a["spd"]) + \
            nd.sum(nd.linalg_syrk(a["b"]))
    return ({"spd": spd, "low": low, "b": _n((3, 4), 7)},
            ["spd", "low", "b"], call)


@grad_case("im2col")
def _():
    return {"x": _n((1, 2, 5, 5), 1)}, ["x"], \
        lambda nd, a: nd.im2col(a["x"], kernel=(3, 3), pad=(1, 1)) ** 2


# ---------------------------------------------------------------------------
# nn
# ---------------------------------------------------------------------------
@grad_case("FullyConnected")
def _():
    return ({"x": _n((2, 3, 4), 1), "w": _n((5, 12), 2), "b": _n((5,), 3)},
            ["x", "w", "b"],
            lambda nd, a: nd.FullyConnected(a["x"], a["w"], a["b"],
                                            num_hidden=5))


@grad_case("Convolution")
def _():
    return ({"x": _n((2, 4, 7, 6), 1), "w": _n((6, 2, 3, 3), 2),
             "b": _n((6,), 3)}, ["x", "w", "b"],
            lambda nd, a: nd.Convolution(a["x"], a["w"], a["b"],
                                         kernel=(3, 3), stride=(2, 1),
                                         pad=(1, 1), num_filter=6,
                                         num_group=2))


@grad_case("Pooling")
def _():
    def call(nd, a):
        x = a["x"]
        P = nd.Pooling
        return nd.sum(P(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1)) ** 2) + \
            nd.sum(P(x, kernel=(3, 3), pool_type="avg", stride=(2, 2),
                     pad=(1, 1), count_include_pad=False) ** 2) + \
            nd.sum(P(x, kernel=(2, 2), pool_type="lp") ** 2) + \
            nd.sum(P(x, kernel=(2, 2), pooling_convention="full",
                     stride=(2, 2)) ** 2) + \
            nd.sum(P(x, pool_type="avg", global_pool=True) ** 2)
    return {"x": _n((2, 3, 7, 6), 1)}, ["x"], call


@grad_case("UpSampling")
def _():
    return {"x": _n((1, 2, 3, 4), 1)}, ["x"], \
        lambda nd, a: nd.UpSampling(a["x"], scale=2) ** 2 + \
        nd.UpSampling(a["x"], scale=2, sample_type="bilinear")


@grad_case("Activation")
def _():
    def call(nd, a):
        return nd.add_n(*[nd.Activation(a["x"], act_type=t) for t in (
            "relu", "sigmoid", "tanh", "softrelu", "softsign", "log_sigmoid",
            "mish", "gelu", "silu")])
    return {"x": _n((3, 4), 1) * 2}, ["x"], call


@grad_case("softmax")
def _():
    def call(nd, a):
        x = a["x"]
        return nd.softmax(x) + nd.log_softmax(x, axis=0) + \
            nd.softmax(x, a["len"], use_length=True) + \
            nd.log_softmax(x, temperature=2.0) + nd.softmin(x) + \
            nd.masked_softmax(x, a["mask"]) + nd.SoftmaxActivation(x)
    return ({"x": _n((3, 5), 1), "len": onp.float32([2, 5, 1]),
             "mask": (_r(3).rand(3, 5) > 0.3).astype(onp.float32)}, ["x"],
            call)


@grad_case("normalization")
def _():
    def call(nd, a):
        x = a["x"]
        return nd.sum(nd.LayerNorm(x, a["g"], a["b"], axis=1) ** 2) + \
            nd.sum(nd.GroupNorm(x, a["g4"], a["b4"], num_groups=2) ** 2) + \
            nd.sum(nd.InstanceNorm(x, a["g4"], a["b4"]) ** 2) + \
            nd.sum(nd.RMSNorm(x, a["g"], axis=1) ** 2) + \
            nd.sum(nd.L2Normalization(x, mode="channel") ** 2) + \
            nd.sum(nd.LRN(x, nsize=3) ** 2)
    return ({"x": _n((2, 4, 3, 3), 1), "g": _n((4,), 2), "b": _n((4,), 3),
             "g4": _n((4,), 4), "b4": _n((4,), 5)},
            ["x", "g", "b", "g4", "b4"], call)


@grad_case("BatchNorm")
def _():
    def call(nd, a):
        autograd = mx.autograd if nd is mx.nd else mt.autograd
        with autograd.train_mode():
            return nd.BatchNorm(a["x"], a["g"], a["b"], a["mm"], a["mv"],
                                fix_gamma=False)
    return ({"x": _n((2, 3, 4, 5), 1) * 2 + 1, "g": _n((3,), 2),
             "b": _n((3,), 3), "mm": onp.zeros(3, onp.float32),
             "mv": onp.ones(3, onp.float32)}, ["x", "g", "b"], call)


@grad_case("Embedding")
def _():
    return ({"i": onp.float32([[0, 4], [2, 4]]), "w": _n((5, 3), 1)}, ["w"],
            lambda nd, a: nd.Embedding(a["i"], a["w"], input_dim=5,
                                       output_dim=3))


@grad_case("interleaved_attention")
def _():
    def call(nd, a):
        qk = nd._contrib_interleaved_matmul_selfatt_qk(a["qkv"], heads=2)
        att = nd.softmax(qk)
        out = nd._contrib_interleaved_matmul_selfatt_valatt(a["qkv"], att,
                                                            heads=2)
        eqk = nd._contrib_interleaved_matmul_encdec_qk(a["q"], a["kv"],
                                                       heads=2)
        eout = nd._contrib_interleaved_matmul_encdec_valatt(
            a["kv"], nd.softmax(eqk), heads=2)
        return nd.sum(out ** 2) + nd.sum(eout ** 2) + \
            nd.sum(nd._contrib_div_sqrt_dim(a["q"]))
    return ({"qkv": _n((6, 2, 24), 1), "q": _n((5, 2, 8), 2),
             "kv": _n((6, 2, 16), 3)}, ["qkv", "q", "kv"], call)


@grad_case("multi_head_attention")
def _():
    mask = (_r(4).rand(2, 1, 8, 8) > 0.3).astype(onp.float32)

    def call(nd, a):
        return nd.multi_head_attention(a["q"], a["k"], a["v"], heads=2,
                                       causal=True) + \
            nd.multi_head_attention(a["q"], a["k"], a["v"], a["mask"],
                                    heads=2)
    return ({"q": _n((2, 8, 32), 1), "k": _n((2, 8, 32), 2),
             "v": _n((2, 8, 32), 3), "mask": mask}, ["q", "k", "v"], call)


@grad_case("CTCLoss", 1e-4)
def _():
    return ({"data": _n((6, 3, 5), 1),
             "label": onp.float32([[1, 2, 0], [3, 3, 4], [2, 0, 0]])},
            ["data"], lambda nd, a: nd.CTCLoss(a["data"], a["label"]))


@grad_case("CTCLoss_lengths", 1e-4)
def _():
    return ({"data": _n((6, 3, 5), 2),
             "label": onp.float32([[0, 1, -1], [2, 2, 3], [1, -1, -1]]),
             "dl": onp.float32([6, 4, 5]), "ll": onp.float32([2, 3, 1])},
            ["data"], lambda nd, a: nd.CTCLoss(
                a["data"], a["label"], a["dl"], a["ll"],
                use_data_lengths=True, use_label_lengths=True,
                blank_label="last"))


# the heads with a defined gradient (the head gradient is ignored)
@grad_case("SoftmaxOutput")
def _():
    return ({"x": _n((4, 5), 1), "l": onp.float32([0, 4, 2, -1])}, ["x"],
            lambda nd, a: nd.SoftmaxOutput(a["x"], a["l"], grad_scale=0.5,
                                           use_ignore=True,
                                           normalization="valid"))


@grad_case("SoftmaxOutput_multi")
def _():
    return ({"x": _n((2, 3, 4), 1), "l": onp.float32([[0, 1, 2, 1],
                                                      [2, 2, 0, 1]])},
            ["x"], lambda nd, a: nd.SoftmaxOutput(
                a["x"], a["l"], multi_output=True, normalization="batch",
                smooth_alpha=0.1))


def _regression(name):
    def fn():
        return ({"x": _n((3, 4), 1), "l": _n((3, 4), 2)}, ["x"],
                lambda nd, a: getattr(nd, name)(a["x"], a["l"],
                                                grad_scale=2.0))
    return fn


for _name in ("LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput"):
    grad_case(_name)(_regression(_name))


@grad_case("MakeLoss")
def _():
    return {"x": _n((3, 4), 1)}, ["x"], \
        lambda nd, a: nd.MakeLoss(a["x"], grad_scale=0.5,
                                  normalization="valid") + \
        nd.make_loss(a["x"], normalization="batch")


@grad_case("SVMOutput")
def _():
    return ({"x": _n((4, 5), 1), "l": onp.float32([0, 4, 2, 1])}, ["x"],
            lambda nd, a: nd.SVMOutput(a["x"], a["l"], margin=0.5) +
            nd.SVMOutput(a["x"], a["l"], use_linear=True,
                         regularization_coefficient=2.0))


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradient_matches_the_jax_package(name):
    _run(name)


def test_block_grad_and_non_differentiable_ops_stop_the_gradient():
    with mt.cpu():
        x = mt.nd.array(_n((3, 4), 1))
        x.attach_grad()
        with mt.autograd.record():
            y = mt.nd.BlockGrad(x * 2) + x * mt.nd.floor(x) + \
                mt.nd.argmax(x, axis=1).reshape((3, 1))
        y.backward()
        onp.testing.assert_array_equal(x.grad.asnumpy(),
                                       onp.floor(x.asnumpy()))
