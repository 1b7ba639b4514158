"""The port's subgraph partitioner (``mxnet_tpu_torch.subgraph``) against
the JAX package's, on the CPU. Oracle: tests/test_subgraph.py, whose five
cases are mirrored here.

For the same graph and backend the port forms the same regions as the
reference (the same ``_CachedSubgraph`` nodes, each over the same inner
nodes, by name). A partitioned graph runs its regions op by op on the
tape, so its outputs and every gradient are bitwise the unpartitioned
graph's (dropout included, from the same generator state); the reference
case's tolerances (1e-5, 1e-4) are kept where the port is compared with
the reference.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import subgraph as jsub
from mxnet_tpu_torch import MXNetError, nd, subgraph
from mxnet_tpu_torch.tools.symbol_bert import symbol_bert

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

SMALL = dict(layers=2, units=64, heads=2, ffn=128, seq=16, vocab=100,
             classes=3)


def _mlp(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=8)
    act = sym.Activation(fc1, name="act", act_type="relu")
    fc2 = sym.FullyConnected(act, name="fc2", num_hidden=4)
    return sym.softmax(fc2, name="sm")


def _bind_like(sym, ref_exe, x, **kwargs):
    exe = sym.simple_bind(mt.cpu(), data=x.shape, **kwargs)
    for k, a in ref_exe.arg_dict.items():
        if k in exe.arg_dict:
            a.copyto(exe.arg_dict[k])
    with mt.cpu():
        exe.arg_dict["data"][:] = nd.array(x)
    return exe


def _ref(sym, shape, seed=0):
    exe = sym.simple_bind(mt.cpu(), data=shape)
    rng = onp.random.RandomState(seed)
    with mt.cpu():
        for k, a in exe.arg_dict.items():
            if k != "data":
                a[:] = nd.array(rng.rand(*a.shape).astype("float32"))
        x = rng.rand(*shape).astype("float32")
        exe.arg_dict["data"][:] = nd.array(x)
    return exe, x


def _ops(s):
    return [n.op for n in s._topo() if not n.is_var]


# -- the reference's five cases ----------------------------------------------
def test_full_graph_collapses_to_one_subgraph():
    out = _mlp(mt.sym)
    part = subgraph.optimize_for(out, "xla")
    assert _ops(part) == ["_CachedSubgraph"]
    exe0, x = _ref(out, (2, 5))
    want = exe0.forward()[0].asnumpy()
    exe1 = _bind_like(part, exe0, x)
    onp.testing.assert_array_equal(exe1.forward()[0].asnumpy(), want)


def test_unsupported_op_splits_regions():
    out = _mlp(mt.sym)

    class NoSoftmax(subgraph.SubgraphBackend):
        def supported(self, node):
            return node.op != "softmax"

    subgraph.register_backend(NoSoftmax("no_softmax"))
    part = subgraph.optimize_for(out, "no_softmax")
    assert _ops(part) == ["_CachedSubgraph", "softmax"]
    exe0, x = _ref(out, (3, 6), seed=1)
    want = exe0.forward()[0].asnumpy()
    exe1 = _bind_like(part, exe0, x)
    onp.testing.assert_array_equal(exe1.forward()[0].asnumpy(), want)


def test_backward_through_subgraph():
    out = _mlp(mt.sym)
    part = subgraph.optimize_for(out, "xla")
    exe0, x = _ref(out, (2, 5), seed=2)
    exe0.forward(is_train=True)
    head = nd.array(onp.ones((2, 4), "float32"), ctx=mt.cpu())
    exe0.backward(head)
    exe1 = _bind_like(part, exe0, x, grad_req="write")
    exe1.forward(is_train=True)
    exe1.backward(head)
    for k in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
        onp.testing.assert_array_equal(exe1.grad_dict[k].asnumpy(),
                                       exe0.grad_dict[k].asnumpy())


def test_min_size_rejects_small_groups():
    out = _mlp(mt.sym)
    subgraph.register_backend(subgraph.SubgraphBackend("bigonly",
                                                       min_size=100))
    part = subgraph.optimize_for(out, "bigonly")
    assert _ops(part) == _ops(out)


def test_unknown_backend_raises():
    with pytest.raises(MXNetError, match="unknown subgraph backend"):
        subgraph.optimize_for(_mlp(mt.sym), "no_such_backend")


# -- the same regions as the reference ----------------------------------------
def _bert(sym):
    return symbol_bert(sym, dropout=0.1, **SMALL)


def _backends(mod):
    """Backends of one package: the default, a whitelist, a class that
    keeps attention out, a minimum size."""
    class NoAttention(mod.SubgraphBackend):
        def supported(self, node):
            return node.op != "multi_head_attention"

    return {"xla": None,
            "t_whitelist": mod.SubgraphBackend(
                "t_whitelist", op_whitelist=["FullyConnected", "gelu_tanh",
                                             "broadcast_add", "LayerNorm",
                                             "Activation"]),
            "t_no_attention": NoAttention("t_no_attention"),
            "t_min3": mod.SubgraphBackend("t_min3", min_size=3)}


def _regions(part):
    """Every node of a partitioned graph by (op, name), each region with
    the names of its inner nodes."""
    out = []
    for n in part._topo():
        if n.is_var:
            continue
        inner = [m.name for m in n.attrs["sym"]._topo() if not m.is_var] \
            if n.op == "_CachedSubgraph" else None
        out.append((n.op, n.name, inner,
                    [None if s is None else (s[0].name, s[1])
                     for s in n.inputs]))
    return out


def _inferred(build, pkg):
    """The graph with its nodes' output counts known (shape inference
    records them, as a bound graph's first forward does)."""
    s = build(pkg.sym)
    tail = (5,) if build is _mlp else (SMALL["seq"],)
    s.infer_shape(data=(2,) + tail, softmax_label=(2,))
    return s


@pytest.mark.parametrize("backend", ["xla", "t_whitelist", "t_no_attention",
                                     "t_min3"])
@pytest.mark.parametrize("graph", ["mlp", "bert"])
def test_regions_equal_the_references(graph, backend):
    build = _mlp if graph == "mlp" else _bert
    for mod, backends in ((jsub, _backends(jsub)),
                          (subgraph, _backends(subgraph))):
        if backends[backend] is not None:
            mod.register_backend(backends[backend])
    want = _regions(jsub.optimize_for(_inferred(build, mx), backend))
    got = _regions(subgraph.optimize_for(_inferred(build, mt), backend))
    assert got == want
    # a graph never run: the same regions (the port reads the output
    # counts from the consumers, see the next test)
    fresh = _regions(subgraph.optimize_for(build(mt.sym), backend))
    assert [r[:3] for r in fresh if r[0] == "_CachedSubgraph"] == \
        [r[:3] for r in want if r[0] == "_CachedSubgraph"]
    assert fresh == want


def test_a_split_read_from_a_region_runs_once():
    """A graph never run records one output for its QKV split. The
    reference's pass then maps only output 0 out of the region and keeps
    the original producers of outputs 1 and 2 beside it, so the embedding
    and the first projection run twice (two dropout draws where the
    unpartitioned graph makes one); the port counts the outputs its
    consumers read and runs every node once."""
    subgraph.register_backend(_backends(subgraph)["t_no_attention"])
    jsub.register_backend(_backends(jsub)["t_no_attention"])
    want = jsub.optimize_for(_bert(mx.sym), "t_no_attention")
    got = subgraph.optimize_for(_bert(mt.sym), "t_no_attention")

    def names(part):
        out = []
        for n in part._topo():
            if n.op == "_CachedSubgraph":
                out += [m.name for m in n.attrs["sym"]._topo()
                        if not m.is_var]
            elif not n.is_var:
                out.append(n.name)
        return out
    dup = [n for n in names(want) if names(want).count(n) > 1]
    assert "word_embed" in dup and "embed_drop" in dup
    assert sorted(names(got)) == sorted(
        n.name for n in _bert(mt.sym)._topo() if not n.is_var)


@pytest.mark.parametrize("backend", ["xla", "t_no_attention", "t_whitelist"])
def test_partitioned_bert_is_bitwise_the_unpartitioned(backend):
    """Outputs and every gradient of the small BERT, dropout 0.1 drawn from
    the same generator state, partitioned or not; shapes inferred through
    the regions equal the unpartitioned graph's."""
    subgraph.register_backend(_backends(subgraph)[backend]
                              or subgraph.get_backend("xla"))
    net = _bert(mt.sym)
    part = subgraph.optimize_for(net, backend)
    assert "_CachedSubgraph" in _ops(part)
    shapes = dict(data=(4, SMALL["seq"]), softmax_label=(4,))
    assert part.infer_shape(**shapes) == net.infer_shape(**shapes)
    rng = onp.random.RandomState(7)
    feed = {"data": rng.randint(0, SMALL["vocab"], (4, SMALL["seq"])),
            "softmax_label": rng.randint(0, 3, (4,))}
    runs = []
    for s in (net, part):
        ex = s.simple_bind(mt.cpu(), **shapes)
        for k, a in ex.arg_dict.items():
            v = feed[k] if k in feed else 0.1 * onp.random.RandomState(
                len(k)).randn(*a.shape)
            a._set_data(torch.tensor(v, dtype=torch.float32))
        mt.random.seed(11)
        out = ex.forward(is_train=True)
        ex.backward()
        runs.append(([o.asnumpy() for o in out],
                     {k: g.asnumpy() for k, g in ex.grad_dict.items()}))
    (o0, g0), (o1, g1) = runs
    for a, b in zip(o1, o0):
        onp.testing.assert_array_equal(a, b)
    assert sorted(g1) == sorted(g0)
    for k in g0:
        onp.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


def test_partitioned_graph_equals_the_references_outputs():
    """The port's partitioned MLP against the reference's partitioned MLP
    on the same weights and input (the reference's tolerances)."""
    outs = []
    for pkg, mod in ((mx, jsub), (mt, subgraph)):
        part = mod.optimize_for(_mlp(pkg.sym), "xla")
        ex = part.simple_bind(pkg.cpu(), data=(3, 5))
        rng = onp.random.RandomState(3)
        with pkg.cpu():
            for k in sorted(ex.arg_dict):
                ex.arg_dict[k][:] = pkg.nd.array(
                    rng.rand(*ex.arg_dict[k].shape).astype("float32"))
            out = ex.forward(is_train=True)[0]
            ex.backward(pkg.nd.array(onp.ones((3, 4), "float32")))
        outs.append((out.asnumpy(), ex.grad_dict["fc1_weight"].asnumpy()))
    onp.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    onp.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-4,
                                atol=1e-6)


def test_the_registry_holds_the_references_ops():
    """``_CachedSubgraph`` is registered: the port's op set is the
    reference's, 369 ops (less the ``_np_*`` ops the reference's ``mx.np``
    registers on first use; none at import)."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry
    assert set(registry.list_ops()) == {o for o in jreg.list_ops()
                                        if not o.startswith("_np_")}
    assert len(registry.list_ops()) == 369
    assert hasattr(mt.nd, "_CachedSubgraph") and \
        hasattr(mt.sym, "_CachedSubgraph")
