"""The port's int8 quantization (mxnet_tpu_torch.ops.quantization and
mxnet_tpu_torch.contrib.quantization) against the JAX package's, on the
CPU.

Each of the 15 ops runs on seeded inputs through both packages in
``tools/op_cases.py`` (``tests/test_torch_ops.py``): codes, int32
accumulators and ranges bitwise, dequantized floats within 2^-21 where the
reference's jitted op fuses a reciprocal product into a multiply-add. Here:
the products past 2^24 (exact), the dequantizers bitwise against the
reference's own functions, ``calibrate_entropy`` on the reference's cases,
``quantize_net`` in its three modes on the reference's MLP and LeNet and on
a 2-layer BERT with the reference's weights carried over (per-layer input
ranges within 1e-6 relative; outputs within the step one int8 code of the
last layer's input moves them, since the float calibration passes differ
by f32 rounding; the reference's own accuracy bars), the int8 MLP served
through ``ModelEndpoint``, and the calibration histograms: the reference
adds a narrower batch's histogram, binned over its own range, bin for bin
onto the running one (a fault); the port bins it over the running range,
as MXNet does.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ops import quantization as JQ

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, nd, serving
from mxnet_tpu_torch.contrib import quantization as pq
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.ops import quantization as Q

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _np(a):
    return onp.array(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                     else onp.asarray(a))


# ---------------------------------------------------------------------------
# the products and the dequantizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1041, 4608])
def test_int8_products_are_exact_past_2_24(K):
    """127 * 127 * K passes 2^24 for K > 1,040: the accumulators are the
    exact integer sums, in both packages."""
    rng = onp.random.RandomState(K)
    x = rng.randint(-127, 128, (9, K)).astype(onp.int8)
    x[0] = 127
    w = rng.randint(-127, 128, (5, K)).astype(onp.int8)
    w[0] = 127
    want = x.astype(onp.int64) @ w.astype(onp.int64).T
    assert want[0, 0] == 127 * 127 * K > 2 ** 24
    one = onp.float32(1.0)
    got = Q.quantized_fully_connected(_t(x), _t(w), -one, one, -one, one)[0]
    ref = JQ.quantized_fully_connected(x, w, -one, one, -one, one)[0]
    assert got.dtype == torch.int32
    onp.testing.assert_array_equal(_np(got), want)
    onp.testing.assert_array_equal(_np(got), onp.asarray(ref))
    # the same sums as a 3 x 3 convolution with C = K // 9 channels
    c = K // 9
    xc = rng.randint(-127, 128, (2, c, 5, 5)).astype(onp.int8)
    wc = rng.randint(-127, 128, (4, c, 3, 3)).astype(onp.int8)
    got = Q.quantized_conv(_t(xc), _t(wc), -one, one, -one, one,
                           kernel=(3, 3), pad=(1, 1))[0]
    ref = JQ.quantized_conv(xc, wc, -one, one, -one, one, kernel=(3, 3),
                            pad=(1, 1))[0]
    onp.testing.assert_array_equal(_np(got), onp.asarray(ref))


def test_dequantizers_equal_the_reference_functions_bitwise():
    """Op by op, dequantize (int8, uint8, int32) and dequantize_accum round
    as the reference's functions do; the reference's jitted uint8
    dequantize multiplies by 1/255 fused into a multiply-add, within 2^-21
    of them."""
    rng = onp.random.RandomState(3)
    x = rng.randn(7, 9).astype(onp.float32)
    for out_type in ("int8", "uint8"):
        q, mn, mx_ = JQ.quantize_v2(x, out_type=out_type)
        pq_, pmn, pmx = Q.quantize_v2(_t(x), out_type=out_type)
        onp.testing.assert_array_equal(_np(pq_), onp.asarray(q))
        got = _np(Q.dequantize(pq_, pmn, pmx))
        onp.testing.assert_array_equal(got, onp.asarray(
            JQ.dequantize(q, mn, mx_)))
        jitted = onp.asarray(mx.nd.contrib.dequantize(
            mx.nd.array(onp.asarray(q), dtype=out_type), mx.nd.array(mn),
            mx.nd.array(mx_)).asnumpy())
        onp.testing.assert_allclose(got, jitted, rtol=2.0 ** -21,
                                    atol=2.0 ** -21)
    acc = rng.randint(-2 ** 30, 2 ** 30, (4, 5)).astype(onp.int32)
    a, b = onp.float32(0.37), onp.float32(-1.9)
    onp.testing.assert_array_equal(
        _np(Q.dequantize(_t(acc), -a, a)),
        onp.asarray(JQ.dequantize(acc, -a, a)))
    onp.testing.assert_array_equal(
        _np(Q.dequantize_accum(_t(acc), -a, a, b, -b)),
        onp.asarray(JQ.dequantize_accum(acc, -a, a, b, -b)))


# ---------------------------------------------------------------------------
# calibrate_entropy: tests/test_quantization.py:84 and :125's data
# ---------------------------------------------------------------------------
def _outlier():
    rng = onp.random.RandomState(4)
    a = rng.randn(100000).astype("float32")
    a[0] = 40.0
    return onp.histogram(a, bins=8001, range=(-40, 40))


def _heavy_tailed():
    rng = onp.random.RandomState(8)
    a = rng.randn(200000).astype("float32")
    mask = rng.rand(200000) < 0.001
    a = a + mask * rng.randn(200000).astype("float32") * 60
    amax = float(onp.abs(a).max())
    return onp.histogram(a, bins=8001, range=(-amax, amax))


@pytest.mark.parametrize("make", [_outlier, _heavy_tailed])
def test_calibrate_entropy_matches_the_reference(make):
    hist, edges = make()
    th, div = Q.calibrate_entropy(hist, edges)
    want_th, want_div = JQ.calibrate_entropy(hist, edges)
    assert th == want_th
    assert abs(div - want_div) <= 1e-6
    assert th < float(edges[-1]) / 2


# ---------------------------------------------------------------------------
# quantize_net: the reference's MLP and LeNet, weights carried over
# ---------------------------------------------------------------------------
def _carry(ref_net, net):
    """Initialize ``net`` with ``ref_net``'s values by structural name."""
    ref = ref_net._collect_params_with_prefix()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(nd.array(ref[name].data().asnumpy()))


def _mlp(pkg_nn, dims=((64, "relu", 20), (32, "relu", 64), (10, None, 32))):
    net = pkg_nn.HybridSequential()
    for units, act, fan_in in dims:
        net.add(pkg_nn.Dense(units, activation=act, in_units=fan_in))
    return net


def _lenet(pkg_nn):
    net = pkg_nn.HybridSequential()
    net.add(pkg_nn.Conv2D(8, 5, padding=2, activation="relu",
                          in_channels=1),
            pkg_nn.MaxPool2D(2),
            pkg_nn.Conv2D(16, 3, padding=1, activation="relu",
                          in_channels=8),
            pkg_nn.MaxPool2D(2),
            pkg_nn.Flatten(),
            pkg_nn.Dense(10, in_units=16 * 7 * 7))
    return net


def _pair(build, seed):
    mx.random.seed(seed)
    ref = build(jnn)
    ref.initialize(mx.init.Xavier())
    net = build(nn)
    net.initialize()
    _carry(ref, net)
    return ref, net


def _quantized(net):
    return [b for b in net.modules()
            if isinstance(b, (pq.QuantizedDense, pq.QuantizedConv2D))]


def _jquantized(net):
    out = []

    def walk(b):
        for c in b._children.values():
            if isinstance(c, (jq.QuantizedDense, jq.QuantizedConv2D)):
                out.append(c)
            else:
                walk(c)
    walk(net)
    return out


def _one_code_step(qnet):
    """What one int8 code of the last layer's input moves its output by:
    amax_x * amax_w / 127."""
    last = _quantized(qnet)[-1]
    w = last._t("weight")
    return last._amax * float(w.detach().abs().max()) / 127


def _convert_both(build, seed, calib, x, mode, **kw):
    ref, net = _pair(build, seed)
    want = ref(mx.nd.array(x)).asnumpy()
    fwant = net(nd.array(x)).asnumpy().copy()
    qref = jq.quantize_net(ref, calib_data=[mx.nd.array(c) for c in calib],
                           calib_mode=mode, **kw)
    qnet = pq.quantize_net(net, calib_data=[nd.array(c) for c in calib],
                           calib_mode=mode, **kw)
    return (qref, qnet, qref(mx.nd.array(x)).asnumpy(),
            qnet(nd.array(x)).asnumpy(), want, fwant)


_RNG = onp.random.RandomState(5)      # tests/test_quantization.py:96's draws
MLP_CALIB = [_RNG.randn(32, 20).astype("float32") for _ in range(4)]
MLP_X = _RNG.randn(64, 20).astype("float32")


@pytest.mark.parametrize("mode", ["naive", "percentile", "entropy"])
def test_quantize_net_mlp_one_batch_matches_the_reference(mode):
    """One calibration batch (where the reference's histograms are right):
    per-layer ranges within 1e-6 relative, outputs within one code step
    of the last layer."""
    qref, qnet, ref_out, got, want, fwant = _convert_both(
        _mlp, 7, MLP_CALIB[:1], MLP_X, mode)
    onp.testing.assert_allclose(fwant, want, rtol=1e-5, atol=1e-5)
    amax = [b._amax for b in _quantized(qnet)]
    ref_amax = [b._amax for b in _jquantized(qref)]
    assert len(amax) == len(ref_amax) == 3
    onp.testing.assert_allclose(amax, ref_amax, rtol=1e-6)
    step = _one_code_step(qnet)
    assert onp.abs(got - ref_out).max() <= step, \
        (onp.abs(got - ref_out).max(), step)


@pytest.mark.parametrize("mode", ["naive", "percentile", "entropy"])
def test_quantize_net_mlp_four_batches(mode):
    """The reference test's four calibration batches: naive ranges within
    1e-6 relative of the reference's; percentile and entropy thresholds
    equal to the reference's threshold functions applied to the port's
    (MXNet-combined) histograms; the reference's bars (agreement >= 0.95,
    rel < 0.15; entropy rel < 0.5)."""
    ref, qnet = _pair(_mlp, 7)
    fwant = qnet(nd.array(MLP_X)).asnumpy().copy()
    pq.quantize_net(qnet, calib_data=[nd.array(c) for c in MLP_CALIB],
                    calib_mode=mode)
    got = qnet(nd.array(MLP_X)).asnumpy()
    amax = [b._amax for b in _quantized(qnet)]
    if mode == "naive":
        jq.quantize_net(ref, calib_data=[mx.nd.array(c) for c in MLP_CALIB],
                        calib_mode=mode)
        onp.testing.assert_allclose(
            amax, [b._amax for b in _jquantized(ref)], rtol=1e-6)
        assert onp.abs(got - ref(mx.nd.array(MLP_X)).asnumpy()).max() <= \
            _one_code_step(qnet)
    # the reference's threshold math on the port's histograms (the first
    # layer's alone in entropy mode: the reference's loop takes ~6 s a
    # histogram)
    _, net = _pair(_mlp, 7)
    coll = pq.LayerInputCollector()
    layers = [b for b in net._modules.values()]
    for blk in layers:
        coll.attach(blk, blk.name)
    for c in MLP_CALIB:
        net(nd.array(c))
    coll.detach()
    jcoll = jq.LayerInputCollector()
    for blk in layers:
        jcoll.min_max[blk.name] = coll.min_max[blk.name]
        jcoll.hists[blk.name] = coll.hists[blk.name][:2]
    checked = layers[:1] if mode == "entropy" else layers
    want_amax = [jq._threshold(jcoll, blk.name, mode, 0.9999)
                 for blk in checked]
    assert amax[:len(checked)] == want_amax
    rel = onp.abs(got - fwant).max() / (onp.abs(fwant).max() + 1e-6)
    assert rel < (0.5 if mode == "entropy" else 0.15), rel
    if mode != "entropy":
        assert (got.argmax(1) == fwant.argmax(1)).mean() >= 0.95


def test_quantize_net_lenet_naive():
    """tests/test_quantization.py:166: LeNet, naive calibration over three
    batches: ranges within 1e-6, outputs within one code step, rel < 0.06,
    both layer kinds converted."""
    rng = onp.random.RandomState(6)
    calib = [rng.rand(8, 1, 28, 28).astype("float32") for _ in range(3)]
    x = rng.rand(16, 1, 28, 28).astype("float32")
    qref, qnet, ref_out, got, want, fwant = _convert_both(
        _lenet, 11, calib, x, "naive")
    onp.testing.assert_allclose(fwant, want, rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose([b._amax for b in _quantized(qnet)],
                                [b._amax for b in _jquantized(qref)],
                                rtol=1e-6)
    assert onp.abs(got - ref_out).max() <= _one_code_step(qnet)
    rel = onp.abs(got - fwant).max() / (onp.abs(fwant).max() + 1e-6)
    assert rel < 0.06, rel
    reprs = str(qnet)
    assert "QuantizedConv2D" in reprs and "QuantizedDense" in reprs
    assert [repr(b) for b in _quantized(qnet)] == \
        [repr(b) for b in _jquantized(qref)]


def test_quantize_net_excludes_layers():
    ref, net = _pair(lambda m: _mlp(m, ((16, None, 8), (4, None, 16))), 3)
    calib = [onp.random.RandomState(7).randn(4, 8).astype("float32")]
    first = net._modules["0"].name
    pq.quantize_net(net, calib_data=[nd.array(c) for c in calib],
                    calib_mode="naive", exclude_layers=[first])
    assert type(net._modules["0"]).__name__ == "Dense"
    assert type(net._modules["1"]).__name__ == "QuantizedDense"
    _, net2 = _pair(lambda m: _mlp(m, ((16, None, 8), (4, None, 16))), 3)
    pq.quantize_net(net2, calib_data=[nd.array(c) for c in calib],
                    calib_mode="naive",
                    exclude_layers_match=[net2._modules["1"].name])
    assert type(net2._modules["0"]).__name__ == "QuantizedDense"
    assert type(net2._modules["1"]).__name__ == "Dense"


def test_quantize_net_refusals_and_hybridize():
    _, net = _pair(_mlp, 1)
    with pytest.raises(MXNetError, match="int8"):
        pq.quantize_net(net, quantized_dtype="uint8", calib_data=[])
    with pytest.raises(MXNetError, match="calib_data"):
        pq.quantize_net(net)
    net.hybridize()
    seen = []
    net._modules["0"].register_forward_pre_hook(
        lambda blk, args: seen.append(net._active))
    pq.quantize_net(net, calib_data=[nd.array(MLP_CALIB[0])],
                    calib_mode="naive")
    assert seen == [False] and net._active


def test_quantized_layers_keep_the_callers_array_type():
    _, net = _pair(_mlp, 2)
    pq.quantize_net(net, calib_data=[nd.array(MLP_CALIB[0])],
                    calib_mode="naive")
    a = net(nd.array(MLP_X))
    t = net(_t(MLP_X))
    assert isinstance(a, mt.nd.NDArray) and isinstance(t, torch.Tensor)
    onp.testing.assert_array_equal(a.asnumpy(), t.numpy())
    # the float layer's parameters are shared, not copied
    blk = net._modules["0"]
    assert blk.weight is blk._src.weight and "_src" not in net._modules


# ---------------------------------------------------------------------------
# a small BERT in both packages
# ---------------------------------------------------------------------------
SMALL_BERT = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
                  vocab_size=100, max_length=32, dropout=0.0)


def test_quantize_net_small_bert_matches_the_reference():
    mx.random.seed(12)
    ref = jbert.BERTModel(**SMALL_BERT)
    ref.initialize(mx.init.Normal(0.02))
    rng = onp.random.RandomState(13)
    toks = [rng.randint(0, 100, (4, 16)).astype("int32") for _ in range(2)]
    x = rng.randint(0, 100, (3, 16)).astype("int32")
    ref(mx.nd.array(x, dtype="int32"))
    net = bert.BERTModel(**SMALL_BERT)
    named = {k: p.data().asnumpy() for k, p in
             ref._collect_params_with_prefix().items()}
    bert.load_jax_params(net, named, ctx=CPU)
    jq.quantize_net(ref, calib_data=[mx.nd.array(t, dtype="int32")
                                     for t in toks], calib_mode="naive")
    pq.quantize_net(net, calib_data=[nd.array(t, dtype="int32")
                                     for t in toks], calib_mode="naive")
    assert len(_quantized(net)) == len(_jquantized(ref)) == 2 * 4 + 1
    onp.testing.assert_allclose([b._amax for b in _quantized(net)],
                                [b._amax for b in _jquantized(ref)],
                                rtol=1e-6)
    seq, pooled = net(nd.array(x, dtype="int32"))
    rseq, rpooled = ref(mx.nd.array(x, dtype="int32"))
    # 9 int8 layers in a row: a code flip anywhere moves the output by up
    # to a code step of the LayerNorm'd (unit-scale) activations, 2 / 127
    scale = onp.abs(rseq.asnumpy()).max()
    assert onp.abs(seq.asnumpy() - rseq.asnumpy()).max() <= 2 / 127 * scale
    assert onp.abs(pooled.asnumpy() - rpooled.asnumpy()).max() <= 2 / 127


# ---------------------------------------------------------------------------
# serving: tests/test_serving.py:323
# ---------------------------------------------------------------------------
def test_quantized_int8_endpoint_serves_and_matches_direct():
    _, net = _pair(lambda m: _mlp(m, ((32, "relu", 16), (10, None, 32))),
                   17)
    rng = onp.random.RandomState(18)
    calib = [nd.array(rng.randn(8, 16).astype("float32")) for _ in range(4)]
    qnet = pq.quantize_net(net, calib_data=calib, calib_mode="naive")
    ep = serving.ModelEndpoint("t_int8", qnet, input_shapes=(16,),
                               max_batch_size=4, ctx=CPU)
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=16)
    srv.register(ep)
    srv.start()
    try:
        xb = rng.randn(3, 16).astype("float32")
        out = srv.predict("t_int8", xb, timeout=60)
    finally:
        srv.stop()
    assert ep.warmup() == 0        # every bucket warmed at registration
    direct = qnet(nd.array(xb)).asnumpy()
    assert out.dtype == torch.float32
    onp.testing.assert_allclose(out.numpy(), direct, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the calibration histograms (a fault in the reference)
# ---------------------------------------------------------------------------
def test_collector_combines_narrower_batches_as_mxnet():
    """Two batches of 10,000: randn * 3, then randn * 0.3 scaled to |max| =
    1. The reference bins the second over its own (-1, 1) and adds it bin
    for bin onto the first's (-amax1, amax1) bins, spreading its mass over
    the whole range; the port (MXNet's combine_histogram) bins it over
    (-amax1, amax1), so its histogram is that of both batches."""
    rng = onp.random.RandomState(0)
    a = (rng.randn(10000) * 3).astype("float32")
    b = (rng.randn(10000) * 0.3).astype("float32")
    b = b / onp.abs(b).max()
    th = float(onp.abs(a).max())
    true, edges = onp.histogram(onp.concatenate([a, b]), bins=8001,
                                range=(-th, th))
    centers = (edges[:-1] + edges[1:]) / 2
    inner = onp.abs(centers) < 1
    results = {}
    for name, coll in (("port", pq.LayerInputCollector()),
                       ("reference", jq.LayerInputCollector())):
        hook = coll.hook("x")
        hook(None, (a,))
        hook(None, (b,))
        results[name] = coll.hists["x"][0]
    onp.testing.assert_array_equal(results["port"], true)
    assert results["port"][inner].sum() == true[inner].sum() == 12692
    assert results["reference"][inner].sum() == 5770
    assert onp.abs(results["reference"] - true).max() == 67


def test_collector_widens_by_whole_bins():
    """A wider later batch: the histogram grows by whole bins of the old
    width on each side, the old counts in the middle (MXNet)."""
    rng = onp.random.RandomState(1)
    a = rng.randn(1000).astype("float32")
    b = (rng.randn(1000) * 4).astype("float32")
    coll = pq.LayerInputCollector()
    hook = coll.hook("x")
    hook(None, (a,))
    first = coll.hists["x"][0].copy()
    hook(None, (b,))
    hist, edges, th = coll.hists["x"]
    grow = (hist.size - first.size) // 2
    assert hist.size == first.size + 2 * grow and th == edges[-1]
    assert th >= onp.abs(b).max()
    assert hist.sum() == 2000
    alone, _ = onp.histogram(b, bins=hist.size, range=(-th, th))
    onp.testing.assert_array_equal(hist[grow:-grow] - first,
                                   alone[grow:-grow])


# ---------------------------------------------------------------------------
# tools/int8_drift.py: the layer-by-layer comparison phase 15 runs
# ---------------------------------------------------------------------------
def _small_bert_int8(seed):
    from mxnet_tpu_torch.tools import seeded_bert_weights
    net = bert.BERTModel(**SMALL_BERT)
    named = seeded_bert_weights(net, seed)
    bert.load_jax_params(net, named, ctx=CPU)
    rng = onp.random.RandomState(seed)
    calib = [nd.array(rng.randint(0, 100, (4, 16)), dtype="int32")
             for _ in range(2)]
    return named, pq.quantize_net(net, calib_data=calib,
                                  calib_mode="naive").eval()


@pytest.mark.parametrize("broken", [False, True])
def test_int8_drift_layer_table_finds_a_layer_that_errs(broken):
    from mxnet_tpu_torch.tools import int8_drift as drift
    named, qnet = _small_bert_int8(21)
    twin = bert.BERTModel(**SMALL_BERT)
    bert.load_jax_params(twin, named, ctx=CPU)
    drift.quantized_like(twin.eval(), qnet)
    bad = "encoder.layer1.ffn.ffn1"
    if broken:                 # a layer whose input range is off by 1 %
        qnet.get_submodule(bad)._amax *= 1.01
    x = (torch.from_numpy(onp.random.RandomState(22).randint(
        0, 100, (1, 16)).astype("int32")),)
    out, seen = drift.capture(qnet, x)
    twin_out, twin_seen = drift.capture(twin, x)
    assert len(seen) == 2 * 4 + 1 and list(seen) == list(twin_seen)
    rows = drift.layer_table(seen, twin_seen, twin)
    erring = [r["layer"] for r in rows if not r["own_bitwise"]]
    assert erring == ([bad] if broken else [])
    if not broken:
        assert all(r["codes_differing"] == 0 == r["input_rel"]
                   for r in rows)
        assert drift.rel_max(out, twin_out) == 0
    # with every quantized output pinned to the first net's, only the float
    # path is left: the same ops on the same values
    pinned, fed = drift.pinned_run(twin, seen, x)
    assert drift.rel_max(pinned, out) == 0
    assert all(torch.equal(fed[p], seen[p][0]) for p in seen)
    f32 = bert.BERTModel(**SMALL_BERT)
    bert.load_jax_params(f32, named, ctx=CPU)
    res = drift.compare(qnet, twin, f32.eval(), x, x)
    assert res["own_bitwise"] == len(rows) - broken
    assert (res["own_ulps"] > 1e3) == broken
    assert res["pinned_inputs_rel"] == res["pinned_outputs_rel"] == 0
    assert res["int8_vs_f32_rel"] > 0
    if not broken:
        assert res["free_running_rel"] == 0 and res["first_flip"] is None
