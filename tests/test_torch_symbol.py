"""The port's symbolic frontend (``mxnet_tpu_torch.symbol``, ``name``,
``attribute``, ``contrib.symbol``) and its ``Executor`` against the JAX
package's, both on the CPU. Oracles: tests/test_symbol_module.py and the
reference modules themselves.

Graphs are built with the same calls in both packages (auto-created names
under a fresh ``NameManager`` in each): arguments, auxiliary states,
outputs and inferred shapes must be equal, a graph's JSON from either
package must load in the other to the same arguments and op sequence, and
bound graphs fed the same numpy inputs and weights must agree: forward
outputs and every argument gradient within f32 1e-5 x max(1, max|ref|)
(sums in another order). The symbolic BERT is the 2-layer, 64-unit,
S = 16, vocab-100 encoder of ``tools/symbol_bert.py`` with 2 heads, so
that its head dim (32) is one the attention kernels take and its
attention runs their plain versions (with 4 heads, D = 16 would take the
dense path).
"""
import json

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.tools.symbol_bert import (encoder_output,
                                               encoder_output_name,
                                               symbol_bert)

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

TOL = 1e-5                  # f32, sums in another order
SMALL = dict(layers=2, units=64, heads=2, ffn=128, seq=16, vocab=100,
             classes=3, dropout=0.0)
B, S = 4, 16


def _both(build):
    """``build(sym)`` in each package under a fresh NameManager."""
    with mx.name.NameManager():
        ref = build(mx.sym)
    with mt.name.NameManager():
        got = build(mt.sym)
    return ref, got


def _mlp(sym):
    data = sym.var("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _auto_named(sym, p=0.3):
    """Auto-created node and parameter names, BatchNorm's auxiliary
    states, a multi-output split, scalar and broadcast arithmetic."""
    x = sym.var("x")
    h = sym.BatchNorm(x, fix_gamma=False)
    h = sym.FullyConnected(h, num_hidden=8)
    a, b = sym.split(h, num_outputs=2, axis=1)[0], \
        sym.split(h, num_outputs=2, axis=1)[1]
    h = sym.tanh(a * 2.0 + b) - 1.0
    h = sym.Dropout(h, p=p)
    return sym.Group([sym.FullyConnected(h, num_hidden=3, no_bias=True), h])


def _bert(sym):
    return symbol_bert(sym, **SMALL)


def _prefixed(sym):
    with (mx if sym is mx.sym else mt).name.Prefix("net_"):
        return _auto_named(sym)


GRAPHS = {"mlp": (_mlp, dict(data=(8, 32), softmax_label=(8,))),
          "auto_named": (_auto_named, dict(x=(5, 7))),
          "prefixed": (_prefixed, dict(x=(5, 7))),
          "bert": (_bert, dict(data=(B, S), softmax_label=(B,)))}


def _ops(s):
    return [(n.op, n.name) for n in s._topo()]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graph_lists_and_shapes_equal_the_references(graph):
    build, shapes = GRAPHS[graph]
    ref, got = _both(build)
    assert got.list_arguments() == ref.list_arguments()
    assert got.list_auxiliary_states() == ref.list_auxiliary_states()
    assert got.list_outputs() == ref.list_outputs()
    assert _ops(got) == _ops(ref)
    assert got.infer_shape(**shapes) == ref.infer_shape(**shapes)
    assert got.list_outputs() == ref.list_outputs()   # after inference too
    internals = (got.get_internals().list_outputs(),
                 ref.get_internals().list_outputs())
    assert internals[0] == internals[1]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partial_inference_equals_the_references(graph):
    """With the first input's shape unknown: the reference returns Nones
    from infer_shape and what it can from infer_shape_partial."""
    build, shapes = GRAPHS[graph]
    ref, got = _both(build)
    some = dict(list(shapes.items())[1:])
    assert got.infer_shape(**some) == ref.infer_shape(**some)
    assert got.infer_shape_partial(**some) == ref.infer_shape_partial(**some)


def test_auto_names_follow_the_name_managers():
    with mx.name.Prefix("mynet_"):
        r = mx.sym.exp(mx.sym.Variable("x"))
    with mt.name.Prefix("mynet_"):
        g = mt.sym.exp(mt.sym.Variable("x"))
    assert g.name == r.name and g.name.startswith("mynet_")
    names = []
    for pkg in (mx, mt):
        mgr = pkg.name.NameManager()
        with mgr:
            a = pkg.sym.exp(pkg.sym.Variable("y"))
            b = pkg.sym.exp(pkg.sym.Variable("z"))
            assert pkg.name.NameManager.current() is mgr
        names.append((a.name, b.name))
        assert pkg.name.NameManager.current() is not mgr
    assert names[0] == names[1] and names[1][0] != names[1][1]


def test_attr_scopes_merge_as_the_references():
    got = []
    for pkg in (mx, mt):
        with pkg.AttrScope(ctx_group="dev1", lr_mult=2):
            outer = pkg.attribute.current_attrs()
            with pkg.AttrScope(ctx_group="dev2"):
                inner = pkg.attribute.current_attrs()
        got.append((outer, inner, pkg.attribute.current_attrs(),
                    pkg.AttrScope(a=1).get({"b": "2"})))
    assert got[1] == got[0]
    assert got[1][1] == {"ctx_group": "dev2", "lr_mult": "2"}


def test_var_attributes_equal_the_references():
    kw = dict(shape=(3, 4), lr_mult=0.5, wd_mult=0.0, dtype="float32",
              attr={"k": "v"})
    r, g = mx.sym.var("w", **kw), mt.sym.var("w", **kw)
    assert g._node.attrs == r._node.attrs
    assert g.attr("__lr_mult__") == 0.5 and g.attr("__shape__") == (3, 4)
    y = mt.sym.FullyConnected(g, num_hidden=2, name="fc")
    assert y.infer_shape()[0][0] == (3, 4)


def test_composition_substitutes_variables_as_the_reference():
    def build(sym):
        net = _mlp(sym)
        x = sym.var("x")
        return net(data=sym.exp(x, name="pre"))
    ref, got = _both(build)
    assert got.list_arguments() == ref.list_arguments()
    assert _ops(got) == _ops(ref)
    assert got.infer_shape(x=(2, 3), softmax_label=(2,)) == \
        ref.infer_shape(x=(2, 3), softmax_label=(2,))


def test_positional_names_equal_the_references():
    """Every registered op composes with the reference's array slots (the
    PRNG ``key`` slot included) but one, whose slot the port's sampler
    calls ``k``."""
    from mxnet_tpu.symbol.symbol import _positional_names as ref_names
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.symbol.symbol import _positional_names
    differ = {op: (_positional_names(op), ref_names(op))
              for op in registry.list_ops()
              if _positional_names(op) != ref_names(op)}
    assert differ == {"_sample_negative_binomial": (
        (["k", "p", "key"], False), (["k_param", "p", "key"], False))}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_json_crosses_between_the_packages(graph):
    build, shapes = GRAPHS[graph]
    ref, got = _both(build)
    assert json.loads(got.tojson()) == json.loads(ref.tojson())
    for src, dst in ((got, mx.sym), (ref, mt.sym)):
        back = dst.load_json(src.tojson())
        assert back.list_arguments() == src.list_arguments()
        assert back.list_auxiliary_states() == src.list_auxiliary_states()
        assert [op for op, _ in _ops(back)] == [op for op, _ in _ops(src)]
        assert back.infer_shape(**shapes) == src.infer_shape(**shapes)


def test_the_references_json_fixture_loads():
    """MXNet-exported JSON (three-entry inputs and heads, arg_nodes and
    node_row_ptr, legacy "param" attributes), the reference test's
    fixture."""
    ref_json = json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "fc_weight", "inputs": []},
            {"op": "null", "name": "fc_bias", "inputs": []},
            {"op": "FullyConnected", "name": "fc",
             "attrs": {"num_hidden": "4"},
             "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
        ],
        "arg_nodes": [0, 1, 2],
        "node_row_ptr": [0, 1, 2, 3, 4],
        "heads": [[3, 0, 0]],
    })
    for pkg in (mx, mt):
        s = pkg.sym.load_json(ref_json)
        assert s.list_arguments() == ["data", "fc_weight", "fc_bias"]
        # no "arg_names" in MXNet's nodes: the bias slot's shape is not
        # inferred (the reference's hook reads the names), so it is given
        assert s.infer_shape(data=(2, 5)) == (None, None, None)
        assert s.infer_shape(data=(2, 5), fc_bias=(4,))[1] == [(2, 4)]
        legacy = json.loads(ref_json)
        legacy["nodes"][3]["param"] = legacy["nodes"][3].pop("attrs")
        s2 = pkg.sym.load_json(json.dumps(legacy))
        assert s2.list_arguments() == s.list_arguments()


def test_save_and_load_files_cross(tmp_path):
    ref, got = _both(_bert)
    got.save(str(tmp_path / "port-symbol.json"))
    ref.save(str(tmp_path / "ref-symbol.json"))
    assert (tmp_path / "port-symbol.json").read_text() == \
        (tmp_path / "ref-symbol.json").read_text()
    s = mt.sym.load(str(tmp_path / "ref-symbol.json"))
    assert _ops(s) == _ops(got)


def test_inference_errors_are_the_references():
    """An op that cannot run on meta tensors (``unique`` has no meta
    implementation; ``_contrib_box_nms`` reads values) fails inference with
    the reference's MXNetError text naming the node, and leaves its shape
    unknown under partial inference; it never runs on data. (The
    reference's XLA tracing gives both a static shape.) Under-specified
    graphs return Nones, and a genuine shape clash raises."""
    for op in ("unique", "_contrib_box_nms"):
        shape = (6,) if op == "unique" else (1, 10, 6)
        ref = getattr(mx.sym, op)(mx.sym.var("x"), name="n")
        assert ref.infer_shape(x=shape)[1] == [shape]
        got = getattr(mt.sym, op)(mt.sym.var("x"), name="n")
        with pytest.raises(MXNetError, match=f"infer_shape failed at node "
                                             rf"n \({op}\)"):
            got.infer_shape(x=shape)
        assert got.infer_shape_partial(x=shape) == ([shape], [None], [])
        assert got.infer_shape() == ref.infer_shape() == (None, None, None)
    for pkg in (mx, mt):
        a = pkg.sym.FullyConnected(pkg.sym.var("x"), num_hidden=3, name="f")
        b = pkg.sym.FullyConnected(pkg.sym.var("y"), num_hidden=2, name="g")
        with pytest.raises(pkg.MXNetError, match="infer_shape failed"):
            (a + b).infer_shape(x=(2, 4), y=(2, 4))


def test_contrib_symbol_finds_the_contrib_wrappers():
    from mxnet_tpu.contrib import symbol as jcs
    from mxnet_tpu_torch.contrib import symbol as tcs
    for name in ("box_nms", "div_sqrt_dim", "arange_like"):
        assert getattr(tcs, name).__name__ == getattr(jcs, name).__name__
    with pytest.raises(AttributeError):
        tcs.no_such_op


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
def _inputs(names, shapes, rng, vocab=SMALL["vocab"],
            classes=SMALL["classes"]):
    vals = {}
    for k in names:
        shp = shapes[k]
        if k == "data" and len(shp) == 2 and shp[1] == S:
            vals[k] = rng.randint(0, vocab, shp).astype("float32")
        elif k.endswith("label"):
            vals[k] = rng.randint(0, classes, shp).astype("float32")
        elif k.endswith("gamma"):
            vals[k] = (1 + 0.1 * rng.randn(*shp)).astype("float32")
        else:
            vals[k] = (0.1 * rng.randn(*shp)).astype("float32")
    return vals


def _bind_pair(ref, got, shapes, seed, **kw):
    jex = ref.simple_bind(mx.cpu(), **kw, **shapes)
    tex = got.simple_bind(mt.cpu(), **kw, **shapes)
    arg_shapes = {k: a.shape for k, a in jex.arg_dict.items()}
    assert {k: a.shape for k, a in tex.arg_dict.items()} == arg_shapes
    assert {k: a.shape for k, a in tex.aux_dict.items()} == \
        {k: a.shape for k, a in jex.aux_dict.items()}
    vals = _inputs(list(jex.arg_dict), arg_shapes,
                   onp.random.RandomState(seed))
    for k, v in vals.items():
        jex.arg_dict[k][:] = mx.nd.array(v)
        tex.arg_dict[k][:] = mt.nd.array(v, ctx=mt.cpu())
    return jex, tex


def _close(got, want, what):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, what
    err = onp.abs(got - want).max() / max(1.0, onp.abs(want).max())
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("graph", ["mlp", "auto_named", "bert"])
def test_forward_and_every_gradient_equal_the_references(graph):
    """Dropout off (p = 0): the packages' generators differ."""
    build, shapes = GRAPHS[graph]
    if graph == "auto_named":
        build = lambda sym: _auto_named(sym, p=0.0)  # noqa: E731
    ref, got = _both(build)
    jex, tex = _bind_pair(ref, got, shapes, seed=3)
    for is_train in (False, True):
        jo = jex.forward(is_train=is_train)
        to = tex.forward(is_train=is_train)
        assert len(to) == len(jo)
        for i, (t, j) in enumerate(zip(to, jo)):
            _close(t.asnumpy(), j.asnumpy(), f"{graph} output {i}")
    heads = [mx.nd.array(onp.ones(o.shape, "float32")) for o in jo]
    jex.backward(heads if graph == "auto_named" else None)
    tex.backward([mt.nd.array(onp.ones(o.shape, "float32"), ctx=mt.cpu())
                  for o in jo] if graph == "auto_named" else None)
    for k in ref.list_arguments():
        if k in jex.grad_dict:
            _close(tex.grad_dict[k].asnumpy(), jex.grad_dict[k].asnumpy(),
                   f"{graph} d{k}")
    for k in ref.list_auxiliary_states():
        _close(tex.aux_dict[k].asnumpy(), jex.aux_dict[k].asnumpy(), k)


def test_grad_req_null_and_add():
    ref, got = _both(_mlp)
    reqs = {k: "add" for k in ref.list_arguments()}
    reqs.update(data="null", softmax_label="null", fc2_bias="null")
    jex, tex = _bind_pair(ref, got, GRAPHS["mlp"][1], seed=5,
                          grad_req=reqs)
    assert "fc2_bias" not in tex.grad_dict and "data" not in tex.grad_dict
    for _ in range(2):
        jex.forward(is_train=True)
        jex.backward()
        tex.forward(is_train=True)
        tex.backward()
    for k in ("fc1_weight", "fc2_weight"):
        _close(tex.grad_dict[k].asnumpy(), jex.grad_dict[k].asnumpy(), k)


def test_executor_reshape_and_copy_params_from():
    ref, got = _both(_mlp)
    jex, tex = _bind_pair(ref, got, GRAPHS["mlp"][1], seed=7)
    rng = onp.random.RandomState(8)
    new = {k: (0.1 * rng.randn(*a.shape)).astype("float32")
           for k, a in jex.arg_dict.items() if "weight" in k}
    jex.copy_params_from({k: mx.nd.array(v) for k, v in new.items()})
    tex.copy_params_from({k: mt.nd.array(v, ctx=mt.cpu())
                          for k, v in new.items()})
    with pytest.raises(MXNetError, match="unknown parameter"):
        tex.copy_params_from({"nope": mt.nd.zeros((1,), ctx=mt.cpu())})
    tex.copy_params_from({"nope": mt.nd.zeros((1,), ctx=mt.cpu())},
                         allow_extra_params=True)
    j2 = jex.reshape(data=(16, 32), softmax_label=(16,))
    t2 = tex.reshape(data=(16, 32), softmax_label=(16,))
    assert t2.arg_dict["data"].shape == (16, 32)
    for k in new:
        onp.testing.assert_array_equal(t2.arg_dict[k].asnumpy(), new[k])
    x = rng.randn(16, 32).astype("float32")
    y = rng.randint(0, 4, (16,)).astype("float32")
    _close(t2.forward(data=x, softmax_label=y)[0].asnumpy(),
           j2.forward(data=x, softmax_label=y)[0].asnumpy(), "reshaped")
    with pytest.raises(MXNetError, match="unknown argument"):
        t2.forward(nope=x)
    assert len(t2.arg_arrays) == len(j2.arg_arrays)
    assert [g is None for g in t2.grad_arrays] == \
        [g is None for g in j2.grad_arrays]


def test_bind_with_given_arrays_and_eval():
    for pkg in (mx, mt):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        c = a * b + 1.0
        with pkg.cpu():
            out = c.eval(pkg.cpu(), a=pkg.nd.array([1.0, 2.0]),
                         b=pkg.nd.array([3.0, 4.0]))
            onp.testing.assert_array_equal(out[0].asnumpy(), [4.0, 9.0])
            with pytest.raises(pkg.MXNetError, match="missing arguments"):
                c.bind(pkg.cpu(), args={"a": pkg.nd.array([1.0])})


def test_the_symbolic_bert_is_the_reference_graph():
    ref, got = _both(_bert)
    assert got.list_arguments() == ref.list_arguments()
    assert len([n for n in got._topo() if n.op == "multi_head_attention"]) \
        == SMALL["layers"]
    assert encoder_output(got, SMALL["layers"]).list_outputs() == \
        [encoder_output_name(SMALL["layers"])]
    shapes = got.get_internals().infer_shape(data=(B, S),
                                             softmax_label=(B,))[1]
    names = got.get_internals().list_outputs()
    assert shapes[names.index(encoder_output_name(SMALL["layers"]))] == \
        (B, S, SMALL["units"])


def test_shape_inference_launches_nothing(monkeypatch):
    """simple_bind's inference runs every node on meta tensors: attention
    takes the plain versions there (no wrapper of the card's kernels is
    called, no counter moves) and no node sees a tensor with storage."""
    seen = []
    real = fa.block_ops

    def spy(q):
        seen.append(q.device.type)
        return real(q)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(fa, "block_ops", spy)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        monkeypatch.setattr(fa, name, refuse)
    counts = (fa.launches, fa.launches_dq, fa.launches_dkv)
    got = symbol_bert(mt.sym, **SMALL)
    from mxnet_tpu_torch.symbol import executor
    shapes, outs, _ = executor._infer_shapes(got, {"data": (B, S),
                                                   "softmax_label": (B,)})
    assert seen == ["meta"] * SMALL["layers"]
    assert outs == [(B, SMALL["classes"])]
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == counts
    q = torch.empty(1, 1, 128, 64, device="meta")
    assert fa.block_ops(q)[0] is fa.flash_attention_fwd_reference
