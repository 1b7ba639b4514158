"""The contrib slice of the port (``mxnet_tpu_torch/ops/contrib.py``, the
spatial-transformer and correlation ops of ``ops/nn.py``, the attention
registry ops and ``nd.contrib``) against the JAX package, both on the CPU,
from the same seeded numpy inputs.

The forward of every op is a case of ``tools/op_cases.py`` (run by
tests/test_torch_ops.py); here: the gradients of the differentiable ops
(each output contracted with a seeded head gradient, every differentiable
input's gradient within 1e-5 relative and absolute; 1e-4 for the Hawkes
recurrence and the deformable convolution, whose sums run over many
terms), NMS's reduction to the valid prefix, the two faults of the
reference this slice found (ROADMAP Queue 3) shown in both packages, and
``nd.contrib``'s control flow and aliases.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import contrib as jax_contrib

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import contrib
from mxnet_tpu_torch.tools import op_cases

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
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


def _grads(name):
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
            out.backward(pkg.nd.array(_n(out.shape, 99), ctx=ctx))
            results.append({k: arrs[k].grad.asnumpy() for k in diff})
    return results, diff, tol


@grad_case("box_iou")
def _():
    r = _r(1)
    return ({"a": op_cases.f32(op_cases._boxes(r, 4)),
             "b": op_cases.f32(op_cases._boxes(r, 5))}, ["a", "b"],
            lambda nd, a: nd.contrib.box_iou(a["a"], a["b"]))


@grad_case("box_nms")
def _():
    return ({"x": op_cases._nms_rows(61)}, ["x"],
            lambda nd, a: nd.contrib.box_nms(a["x"], overlap_thresh=0.5,
                                             valid_thresh=0.3, topk=7))


@grad_case("box_encode")
def _():
    r = _r(2)
    return ({"s": op_cases.f32(r.randint(0, 2, (2, 5))),
             "m": op_cases.f32(r.randint(0, 3, (2, 5))),
             "a": op_cases.f32(op_cases._boxes(r, 10).reshape(2, 5, 4)),
             "g": op_cases.f32(op_cases._boxes(r, 6).reshape(2, 3, 4))},
            ["a", "g"], lambda nd, a: nd.contrib.box_encode(
                a["s"], a["m"], a["a"], a["g"]))


@grad_case("box_decode")
def _():
    r = _r(3)
    return ({"d": _n((2, 6, 4), 4, -1, 1),
             "a": op_cases.f32(op_cases._boxes(r, 6)[None])}, ["d", "a"],
            lambda nd, a: nd.contrib.box_decode(a["d"], a["a"], clip=0.5))


@grad_case("ROIAlign")
def _():
    return ({"x": _n((2, 3, 6, 7), 5), "r": op_cases._ROIS}, ["x", "r"],
            lambda nd, a: nd.contrib.ROIAlign(a["x"], a["r"],
                                              pooled_size=(2, 3)))


@grad_case("ROIPooling")
def _():
    return ({"x": _n((2, 3, 6, 7), 6), "r": op_cases._ROIS[:3]}, ["x"],
            lambda nd, a: nd.ROIPooling(a["x"], a["r"], pooled_size=(2, 2)))


@grad_case("hawkes_ll", 1e-4)
def _():
    r = _r(7)
    ins = {"lda": r.uniform(0.2, 1.0, 3), "alpha": r.uniform(0.1, 0.5, 3),
           "beta": r.uniform(0.5, 2.0, 3), "state": r.uniform(0, 0.5, (3, 3)),
           "lags": r.uniform(0.1, 1.0, (3, 4)),
           "marks": r.randint(0, 3, (3, 4)), "vl": [4, 2, 3],
           "mt": [5.0, 3.0, 4.0]}
    ins = {k: op_cases.f32(v) for k, v in ins.items()}
    return ins, ["lda", "alpha", "beta", "state", "lags"], \
        lambda nd, a: nd.contrib.hawkes_ll(*(a[k] for k in ins))


@grad_case("quadratic")
def _():
    return {"x": _n((3, 4), 8)}, ["x"], \
        lambda nd, a: nd.contrib.quadratic(a["x"], a=0.5, b=-2.0, c=1.0)


@grad_case("index_copy")
def _():
    return ({"old": _n((5, 3), 9), "i": op_cases.i32([4, 0, 2]),
             "new": _n((3, 3), 10)}, ["old", "new"],
            lambda nd, a: nd.contrib.index_copy(a["old"], a["i"], a["new"]))


@grad_case("gradientmultiplier")
def _():
    return {"x": _n((3, 4), 11)}, ["x"], \
        lambda nd, a: nd.contrib.gradientmultiplier(a["x"], scalar=0.3)


@grad_case("BatchNormWithReLU")
def _():
    x = _n((2, 3, 4, 5), 12) * 2 + 0.5
    return ({"x": x, "g": _n((3,), 13), "b": _n((3,), 14),
             "mm": op_cases.f32([0.1, -0.2, 0.3]),
             "mv": op_cases.f32([1.5, 0.5, 2.0])}, ["x", "g", "b"],
            lambda nd, a: nd.BatchNormWithReLU(a["x"], a["g"], a["b"],
                                               a["mm"], a["mv"],
                                               fix_gamma=False))


@grad_case("AdaptiveAvgPooling2D")
def _():
    return {"x": _n((1, 2, 7, 5), 15)}, ["x"], \
        lambda nd, a: nd.AdaptiveAvgPooling2D(a["x"], output_size=(3, 2))


@grad_case("DeformableConvolution", 1e-4)
def _():
    return ({"x": _n((2, 4, 6, 6), 16),
             "off": _n((2, 2 * 9 * 2, 4, 4), 17, -1.5, 1.5),
             "w": _n((4, 2, 3, 3), 18), "b": _n((4,), 19)},
            ["x", "off", "w", "b"],
            lambda nd, a: nd.DeformableConvolution(
                a["x"], a["off"], a["w"], a["b"], kernel=(3, 3),
                num_filter=4, num_group=2, num_deformable_group=2))


@grad_case("IdentityAttachKLSparseReg")
def _():
    return ({"x": _n((8, 4), 20, 0.05, 0.95),
             "avg": op_cases.f32([0.5, 0.2, 0.7, 0.4])}, ["x"],
            lambda nd, a: nd.IdentityAttachKLSparseReg(
                a["x"], a["avg"], sparseness_target=0.2, penalty=0.01))


@grad_case("straight_through")
def _():
    return {"x": _n((3, 4), 21) * 2}, ["x"], \
        lambda nd, a: nd.contrib.round_ste(a["x"]) * 2 + \
        nd.contrib.sign_ste(a["x"] * 3)


@grad_case("GridGenerator")
def _():
    return ({"theta": op_cases._IDENT, "flow": _n((2, 2, 3, 4), 22)},
            ["theta", "flow"],
            lambda nd, a: nd.GridGenerator(
                a["theta"], transform_type="affine",
                target_shape=(3, 4)) + nd.GridGenerator(
                    a["flow"], transform_type="warp"))


@grad_case("BilinearSampler")
def _():
    return ({"x": _n((2, 3, 5, 6), 23),
             "grid": _n((2, 2, 4, 3), 24, -1.2, 1.2)}, ["x", "grid"],
            lambda nd, a: nd.BilinearSampler(a["x"], a["grid"]))


@grad_case("SpatialTransformer")
def _():
    return ({"x": _n((2, 3, 5, 6), 25), "loc": op_cases._IDENT},
            ["x", "loc"],
            lambda nd, a: nd.SpatialTransformer(a["x"], a["loc"],
                                                target_shape=(4, 3)))


@grad_case("Correlation")
def _():
    return ({"a": _n((1, 3, 7, 8), 26), "b": _n((1, 3, 7, 8), 27)},
            ["a", "b"],
            lambda nd, a: nd.Correlation(a["a"], a["b"], kernel_size=3,
                                         max_displacement=2, stride1=2,
                                         stride2=2, pad_size=2))


@grad_case("flash_attention")
def _():
    return ({k: _n((2, 2, 8, 32), s) for k, s in (("q", 28), ("k", 29),
                                                   ("v", 30))},
            ["q", "k", "v"],
            lambda nd, a: nd.flash_attention(a["q"], a["k"], a["v"],
                                             causal=True))


@grad_case("single_query_attention")
def _():
    ins = {"q": _n((2, 8), 31), "kc": _n((2, 6, 8), 32),
           "vc": _n((2, 6, 8), 33), "kn": _n((2, 8), 34),
           "vn": _n((2, 8), 35), "len": op_cases.i32([2, 5])}
    return ins, ["q", "kc", "vc", "kn", "vn"], \
        lambda nd, a: nd.single_query_attention(*(a[k] for k in ins),
                                                heads=2)


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradient_matches_the_jax_package(name):
    (ref, got), diff, tol = _grads(name)
    for k in diff:
        assert got[k].dtype == ref[k].dtype, k
        onp.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol,
                                    err_msg=f"{name}: d{k}")


# ---------------------------------------------------------------------------
# NMS over the valid prefix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topk,valid_thresh", [
    (-1, 0.0), (7, 0.0), (-1, 0.42), (5, 0.3), (1, 0.0), (-1, 0.99)])
def test_box_nms_over_the_valid_prefix_equals_the_reference(topk,
                                                            valid_thresh):
    """The port loops over the sorted rows before the last valid one
    only; cuts by topk and by valid_thresh mid-array (and none, one, all
    but one row) give the reference's result over all N rows, bitwise."""
    rows = op_cases._nms_rows(71, B=3, N=40)
    kw = dict(overlap_thresh=0.5, valid_thresh=valid_thresh, topk=topk)
    want = onp.asarray(jax_contrib.box_nms(rows, **kw))
    got = contrib.box_nms(torch.from_numpy(rows), **kw).numpy()
    onp.testing.assert_array_equal(got, want)
    kept = (got[..., 0] >= 0).sum()
    assert kept == (want[..., 0] >= 0).sum()


# ---------------------------------------------------------------------------
# faults of the reference, matched (ROADMAP Queue 3)
# ---------------------------------------------------------------------------
def test_multibox_target_padding_label_undoes_a_forced_match_at_anchor_0():
    """A padding label (cls -1) has IoU 0 with every anchor, so its best
    anchor is anchor 0, and the reference's scatter of the forced matches
    lets the last label win: a valid label whose best anchor is anchor 0,
    followed by padding, loses its forced match (here its IoU is under
    the 0.5 threshold, so anchor 0 ends up background). The port computes
    the same winner (the largest label index) deterministically."""
    anchors = onp.float32([[[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.9, 0.9],
                            [0.3, 0.3, 0.6, 0.6]]])
    label = onp.float32([[[1, 0.0, 0.0, 0.3, 0.35], [-1, 0, 0, 0, 0]],
                         [[1, 0.0, 0.0, 0.3, 0.35], [0, 0.5, 0.5, 0.95,
                                                     0.95]]])
    cls = onp.zeros((2, 3, 3), onp.float32)
    want = [onp.asarray(a) for a in jax_contrib.multibox_target(
        anchors, label, cls)]
    got = [a.numpy() for a in contrib.multibox_target(
        *(torch.from_numpy(a) for a in (anchors, label, cls)))]
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # image 0: the padding label undid label 0's forced match at anchor 0
    assert want[2][0, 0] == 0 and got[2][0, 0] == 0
    # image 1: no padding after it, label 0 keeps anchor 0 (class 1 + 1)
    assert want[2][1, 0] == 2 and got[2][1, 0] == 2


def test_hawkes_ll_adds_lda_whole_as_the_reference():
    """The reference adds ``lda`` (K,) whole to the (B,) marked intensity
    instead of ``lda[mark]``: it runs only where K broadcasts against B.
    The port computes the same expressions; at B = K = 3 they agree
    (tests/test_torch_ops.py), at B = 2, K = 3 both refuse."""
    r = _r(72)
    args = [r.uniform(0.2, 1.0, 3), r.uniform(0.1, 0.5, 3),
            r.uniform(0.5, 2.0, 3), onp.zeros((2, 3)),
            r.uniform(0.1, 1.0, (2, 4)), r.randint(0, 3, (2, 4)),
            onp.float32([4, 2]), onp.float32([5.0, 3.0])]
    args = [onp.asarray(a, onp.float32) for a in args]
    with pytest.raises(Exception):
        jax_contrib.hawkes_ll(*args)
    with pytest.raises(RuntimeError):
        contrib.hawkes_ll(*(torch.from_numpy(a) for a in args))


# ---------------------------------------------------------------------------
# nd.contrib
# ---------------------------------------------------------------------------
def test_nd_contrib_names_equal_the_reference():
    """Every op alias of the reference's nd.contrib (the _contrib_ ops
    without their prefix and the seven unprefixed contrib ops) is in the
    port's nd.contrib: the port registers each of their ops."""
    from mxnet_tpu.ops import registry as jax_registry
    ref_ops = set(jax_registry.list_ops())
    port_ops = set(mt.ops.list_ops())
    left = []
    for n in dir(mx.nd.contrib):
        op = f"_contrib_{n}" if f"_contrib_{n}" in ref_ops else n
        if n.startswith("_") or op not in ref_ops:
            continue
        if op in port_ops:
            assert callable(getattr(mt.nd.contrib, n, None)), n
        else:
            left.append(op)
    assert not left, left
    for n in ("foreach", "while_loop", "cond", "boolean_mask"):
        assert callable(getattr(mt.nd.contrib, n)), n


def _control_flow(nd, ctx):
    x = nd.array(_n((5, 3), 40), ctx=ctx)

    def body(xt, states):
        s = states + xt
        return [s * 2, s.sum()], s

    outs, final = nd.contrib.foreach(body, x, nd.zeros((3,), ctx=ctx))

    def body2(xt, states):
        a, b = states
        return a * xt, [a + xt, b * 0.5]

    outs2, final2 = nd.contrib.foreach(body2, x, [nd.ones((3,), ctx=ctx),
                                                  nd.ones((3,), ctx=ctx)])
    wl_out, wl_vars = nd.contrib.while_loop(
        lambda i, s: i < 3, lambda i, s: (s * 2, [i + 1, s + i]),
        [nd.array(op_cases.f32([0.0]), ctx=ctx),
         nd.array(op_cases.f32([1.0]), ctx=ctx)], max_iterations=5)
    none_out, none_vars = nd.contrib.while_loop(
        lambda i: i > 10, lambda i: (i * 3, i + 1),
        nd.array(op_cases.f32([0.0]), ctx=ctx), max_iterations=2)
    c1 = nd.contrib.cond(x.sum() > 0, lambda: x * 2, lambda: x - 1)
    c2 = nd.contrib.cond(x.sum() < 0, lambda a: (a, a * 3),
                         lambda a: (a + 1, a - 1), inputs=[x])
    bm = nd.contrib.boolean_mask(x, nd.array(op_cases.f32([1, 0, 1, 1, 0]),
                                             ctx=ctx))
    return {"foreach": outs, "final": final, "foreach2": outs2,
            "final2": final2, "while": wl_out, "while_vars": wl_vars,
            "while_none": none_out, "while_none_vars": none_vars,
            "cond": c1, "cond2": c2, "boolean_mask": bm}


def test_nd_contrib_control_flow_matches_the_jax_package():
    ref = _control_flow(mx.nd, mx.cpu())
    with mt.cpu():
        got = _control_flow(mt.nd, mt.cpu())
    assert not op_cases.differences(ref, got, op_cases.SUMS)


def test_boolean_mask_gradient_is_takes():
    results = []
    for pkg in (mx, mt):
        with pkg.cpu():
            x = pkg.nd.array(_n((5, 3), 41))
            x.attach_grad()
            with pkg.autograd.record():
                y = pkg.nd.contrib.boolean_mask(
                    x, pkg.nd.array(op_cases.f32([0, 1, 1, 0, 1])))
            y.backward(pkg.nd.array(_n((3, 3), 42)))
            results.append(x.grad.asnumpy())
    onp.testing.assert_array_equal(results[1], results[0])


def test_constraint_check_raises_the_message_eagerly():
    with mt.cpu():
        with pytest.raises(mt.MXNetError, match="lengths must be positive"):
            mt.nd._npx_constraint_check(mt.nd.array([1.0, 0.0]),
                                        msg="lengths must be positive")
        assert bool(mt.nd._npx_constraint_check(
            mt.nd.array([1.0, 2.0])).asnumpy())
