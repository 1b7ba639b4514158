"""The port's single-process KVStore (mxnet_tpu_torch.kvstore) and the
Trainer's kvstore path against the JAX package's, on the CPU: the
reference's four kvstore cases of tests/test_sparse.py, push / pull /
pushpull / broadcast on lists of values, 2-bit and 1-bit gradient
compression over three pushes (packed bytes, 2-bit scales and residuals
bitwise; the 1-bit scale, a mean, within 4 f32 ulps of XLA's, whose
summation order is its own), the Trainer with ``update_on_kvstore=True``
bitwise equal to the local update and, with 2-bit compression, bitwise
equal to the reference's Trainer over three steps, its state under the
kvstore and the plugin registry. The distributed types are held against
the reference in tests/test_torch_dist_kvstore.py."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import sparse as jsparse
from mxnet_tpu.kvstore.gradient_compression import \
    GradientCompression as JaxCompression

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, gluon, kv, nd, sparse
from mxnet_tpu_torch.kvstore.gradient_compression import GradientCompression
from mxnet_tpu_torch.sparse import RowSparseNDArray

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _rand_dense(shape, density=0.3, seed=0):
    rng = onp.random.RandomState(seed)
    arr = rng.randn(*shape).astype("float32")
    mask = rng.rand(*shape) < density
    return arr * mask


def _both(fn):
    """``fn(pkg, nd, sparse)`` through the reference and the port."""
    return fn(mx, mx.nd, jsparse), fn(mt, nd, sparse)


# ---------------------------------------------------------------------------
# tests/test_sparse.py's kvstore cases (:223, :240, :374, :474)
# ---------------------------------------------------------------------------
def _row_sparse_pull(pkg, nd_, sp):
    store = pkg.kv.create("local")
    w = nd_.array(_rand_dense((6, 4), density=1.0, seed=6))
    store.init(3, w)
    out = sp.zeros("row_sparse", (6, 4))
    store.row_sparse_pull(3, out=out, row_ids=nd_.array([1, 4],
                                                        dtype="int32"))
    dout = nd_.zeros((6, 4))
    store.row_sparse_pull(3, out=dout, row_ids=nd_.array([2], dtype="int32"))
    return w.asnumpy().copy(), out, out.asnumpy().copy(), dout.asnumpy()


def test_kvstore_row_sparse_pull():
    (rw, _, rout, rdout), (w, out, got, dout) = _both(_row_sparse_pull)
    assert isinstance(out, RowSparseNDArray)
    onp.testing.assert_array_equal(got[[1, 4]], w[[1, 4]])
    onp.testing.assert_array_equal(got[0], onp.zeros(4))
    onp.testing.assert_array_equal(dout[2], w[2])
    assert abs(dout[[0, 1, 3, 4, 5]]).sum() == 0
    onp.testing.assert_array_equal(got, rout)
    onp.testing.assert_array_equal(dout, rdout)


def _sparse_push_with_updater(pkg, nd_, sp):
    store = pkg.kv.create("local")
    store.set_optimizer(pkg.optimizer.SGD(learning_rate=1.0))
    store.init(0, nd_.array(onp.zeros((5, 2), "float32")))
    g1 = sp.row_sparse_array((onp.ones((1, 2), "float32"), [1]),
                             shape=(5, 2))
    g2 = sp.row_sparse_array((onp.ones((1, 2), "float32"), [3]),
                             shape=(5, 2))
    store.push(0, [g1, g2])
    out = nd_.zeros((5, 2))
    store.pull(0, out=out)
    return out.asnumpy()


def test_kvstore_sparse_push_with_updater():
    ref, got = _both(_sparse_push_with_updater)
    onp.testing.assert_array_equal(got[1], [-1, -1])
    onp.testing.assert_array_equal(got[3], [-1, -1])
    assert abs(got[[0, 2, 4]]).sum() == 0
    onp.testing.assert_array_equal(got, ref)


def _pull_from_sparse_store(pkg, nd_, sp):
    store = pkg.kv.create("local")
    g = sp.row_sparse_array((onp.arange(4, dtype="float32").reshape(2, 2),
                             [1, 3]), shape=(5, 2))
    store.init(0, nd_.zeros((5, 2)))
    store.push(0, g)
    out = sp.row_sparse_array((onp.zeros((2, 2), "float32"), [1, 3]),
                              shape=(5, 2))
    store.row_sparse_pull(0, out=out, row_ids=nd_.array(onp.array([1, 3]),
                                                        dtype="int32"))
    return out.asnumpy()


def test_row_sparse_pull_from_sparse_store():
    ref, got = _both(_pull_from_sparse_store)
    exp = onp.zeros((5, 2), "float32")
    exp[1] = [0, 1]
    exp[3] = [2, 3]
    onp.testing.assert_array_equal(got, exp)
    onp.testing.assert_array_equal(got, ref)


def _pull_duplicate_unsorted_empty(pkg, nd_, sp):
    store = pkg.kv.create("local")
    w = nd_.array(_rand_dense((8, 3), density=1.0, seed=11))
    store.init(9, w)
    out = sp.zeros("row_sparse", (8, 3))
    store.row_sparse_pull(9, out=out, row_ids=nd_.array([5, 2, 5, 0, 2],
                                                        dtype="int32"))
    dout = nd_.zeros((8, 3))
    store.row_sparse_pull(9, out=dout, row_ids=nd_.array([4, 4, 4],
                                                         dtype="int32"))
    eout = nd_.zeros((8, 3))
    store.row_sparse_pull(9, out=eout, row_ids=nd_.array([], dtype="int32"))
    idx = out.indices.asnumpy()
    return (w.asnumpy().copy(), sorted(set(idx[idx < 8].tolist())),
            out.asnumpy(), dout.asnumpy(), eout.asnumpy())


def test_row_sparse_pull_duplicate_unsorted_empty():
    ref, (w, rows, out, dout, eout) = _both(_pull_duplicate_unsorted_empty)
    assert rows == ref[1] == [0, 2, 5]
    onp.testing.assert_array_equal(out[[0, 2, 5]], w[[0, 2, 5]])
    assert abs(out[[1, 3, 4, 6, 7]]).sum() == 0
    onp.testing.assert_array_equal(dout[4], w[4])
    assert abs(dout[[0, 1, 2, 3, 5, 6, 7]]).sum() == 0
    assert abs(eout).sum() == 0
    for a, b in zip((out, dout, eout), ref[2:]):
        onp.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# push, pull, pushpull, broadcast
# ---------------------------------------------------------------------------
def _dense_ops(pkg, nd_, sp):
    rng = onp.random.RandomState(20)
    vals = [rng.randn(3, 4).astype("float32") for _ in range(3)]
    store = pkg.kv.create("device")
    store.init([0, 1], [nd_.zeros((3, 4)), nd_.zeros((2,))])
    store.push(0, [nd_.array(v) for v in vals])
    out = [nd_.zeros((3, 4)) for _ in range(2)]
    store.pull(0, out=out)
    store.push([0, 1], [nd_.array(vals[0]), nd_.ones((2,)) * 3])
    pulled = [nd_.zeros((3, 4)), nd_.zeros((2,))]
    store.pull([0, 1], out=pulled)
    grads = [nd_.array(v) for v in vals]
    store.pushpull(5, grads)
    dst = [nd_.zeros((3, 4)) for _ in range(3)]
    store.pushpull(6, [nd_.array(v) for v in vals], out=dst)
    bout = [nd_.zeros((3, 4)) for _ in range(2)]
    store.broadcast(7, nd_.array(vals[2]), out=bout)
    # with an updater: pushpull updates the stored weight and returns it
    store.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5))
    store.init(8, nd_.ones((3, 4)))
    upd = nd_.zeros((3, 4))
    store.pushpull(8, [nd_.array(v) for v in vals[:2]], out=upd)
    return [a.asnumpy().copy() for a in out + pulled + grads + dst + bout
            + [upd]]


def test_push_pull_pushpull_broadcast_match_the_reference():
    ref, got = _both(_dense_ops)
    assert len(got) == len(ref) == 13
    for a, b in zip(got, ref):
        onp.testing.assert_array_equal(a, b)
    rng = onp.random.RandomState(20)
    vals = [rng.randn(3, 4).astype("float32") for _ in range(3)]
    onp.testing.assert_array_equal(got[0], (vals[0] + vals[1]) + vals[2])
    onp.testing.assert_array_equal(got[10], vals[2])


def test_init_copies_and_pull_refuses_unknown_keys():
    store = kv.create("local")
    w = nd.ones((2,))
    store.init("w", w)
    w += 1
    out = nd.zeros((2,))
    store.pull("w", out=out)
    onp.testing.assert_array_equal(out.asnumpy(), [1, 1])
    with pytest.raises(MXNetError, match="not initialized"):
        store.pull("x", out=out)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def _ulps(a, b):
    a = onp.asarray(a, onp.float32).view(onp.int32).astype(onp.int64)
    b = onp.asarray(b, onp.float32).view(onp.int32).astype(onp.int64)
    return int(onp.abs(a - b).max())


@pytest.mark.parametrize("kind,threshold", [("2bit", 0.5), ("2bit", 0.1),
                                            ("1bit", 0.5)])
def test_compression_matches_the_reference_over_three_pushes(kind,
                                                             threshold):
    rng = onp.random.RandomState(30)
    grads = [(rng.randn(37, 5) * 0.4).astype("float32") for _ in range(3)]
    ref = JaxCompression(kind, threshold)
    comp = GradientCompression(kind, threshold)
    assert comp.get_params() == ref.get_params()
    for g in grads:
        rpacked, rscale = ref.quantize("k", mx.nd.array(g))
        packed, scale = comp.quantize("k", torch.from_numpy(g))
        assert packed.dtype == torch.uint8
        onp.testing.assert_array_equal(packed.numpy(), onp.asarray(rpacked))
        if kind == "2bit":
            assert scale.item() == float(rscale)
            onp.testing.assert_array_equal(comp._residuals["k"].numpy(),
                                           onp.asarray(ref._residuals["k"]))
        else:
            # the mean's last bits follow the summation order
            assert _ulps(scale.numpy(), rscale) <= 4
            onp.testing.assert_allclose(
                comp._residuals["k"].numpy(),
                onp.asarray(ref._residuals["k"]), rtol=0,
                atol=4 * onp.spacing(onp.float32(rscale)))
        back = comp.dequantize(packed, scale, g.shape, torch.float32)
        rback = ref.dequantize(rpacked, rscale, g.shape, "float32")
        onp.testing.assert_allclose(back.numpy(), onp.asarray(rback),
                                    rtol=0, atol=4 * onp.spacing(
                                        onp.float32(rscale)))
    # four 2-bit or eight 1-bit codes a byte, the tail padded
    assert packed.numel() == -(-g.size // (4 if kind == "2bit" else 8))


def test_kvstore_applies_compression_per_device_with_residuals():
    """Three values of one key on one device: each passes its own
    roundtrip (its residual under (key, i)), then they are summed, as the
    reference does."""
    rng = onp.random.RandomState(31)
    vals = [(rng.randn(4, 6) * 0.6).astype("float32") for _ in range(3)]
    outs = []
    for pkg, nd_ in ((mx, mx.nd), (mt, nd)):
        store = pkg.kv.create("local")
        store.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        store.init(0, nd_.zeros((4, 6)))
        res = []
        for _ in range(2):
            store.push(0, [nd_.array(v) for v in vals])
            o = nd_.zeros((4, 6))
            store.pull(0, out=o)
            res.append(o.asnumpy().copy())
        outs.append(res)
    for a, b in zip(*outs):
        onp.testing.assert_array_equal(b, a)
    assert set(onp.unique(outs[1][0])) <= {-1.5, -1.0, -0.5, 0.0, 0.5, 1.0,
                                           1.5}


# ---------------------------------------------------------------------------
# the Trainer's kvstore path
# ---------------------------------------------------------------------------
def _dense_net(pkg_gluon):
    net = pkg_gluon.nn.HybridSequential()
    net.add(pkg_gluon.nn.Dense(8, activation="relu", in_units=6),
            pkg_gluon.nn.Dense(3, in_units=8))
    return net


def _weights(seed):
    rng = onp.random.RandomState(seed)
    return {"0.weight": rng.randn(8, 6).astype("float32") * 0.5,
            "0.bias": rng.randn(8).astype("float32") * 0.1,
            "1.weight": rng.randn(3, 8).astype("float32") * 0.5,
            "1.bias": rng.randn(3).astype("float32") * 0.1}


def _train(pkg, steps, seed=40, **trainer_kw):
    pnd = pkg.nd
    net = _dense_net(pkg.gluon)
    net.initialize()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(pnd.array(_weights(seed)[name]))
    opt = trainer_kw.pop("optimizer", ("sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9}))
    trainer = pkg.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                                **trainer_kw)
    loss_fn = pkg.gluon.loss.L2Loss()
    rng = onp.random.RandomState(seed + 1)
    for _ in range(steps):
        x = pnd.array(rng.randn(5, 6).astype("float32"))
        y = pnd.array(rng.randn(5, 3).astype("float32"))
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(5)
    return {n: p.data().asnumpy().copy()
            for n, p in net._collect_params_with_prefix().items()}, trainer


@pytest.mark.parametrize("opt", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})], ids=["sgd_momentum", "adam"])
def test_update_on_kvstore_equals_the_local_update_bitwise(opt):
    local, lt = _train(mt, 3, optimizer=opt)
    on_kv, kt = _train(mt, 3, optimizer=opt, kvstore="device",
                       update_on_kvstore=True)
    assert kt._update_on_kvstore and not lt._update_on_kvstore
    for name in local:
        onp.testing.assert_array_equal(on_kv[name], local[name])
    for i, st in lt._updaters.states.items():
        kst = kt._kvstore._updater.states[i]
        for a, b in zip(torch.utils._pytree.tree_leaves(st),
                        torch.utils._pytree.tree_leaves(kst)):
            onp.testing.assert_array_equal(b.numpy(), a.numpy())


@pytest.mark.parametrize("kvstore", ["device", "instance"])
def test_trainer_with_2bit_compression_matches_the_reference(kvstore):
    """Three SGD-momentum steps through a kvstore with 2-bit compression:
    the weights bitwise the reference Trainer's (f32: the gradients differ
    from the reference's by f32 ulps, which no 2-bit code here is near
    enough to its threshold to feel; the rest is the same float32
    operations); the compressed run differs from the uncompressed one."""
    comp = {"type": "2bit", "threshold": 0.05}
    kw = dict(update_on_kvstore=True, compression_params=comp)
    ref, _ = _train(mx, 3, kvstore=mx.kv.create("device")
                    if kvstore == "instance" else "device", **kw)
    got, trainer = _train(mt, 3, kvstore=kv.create("device")
                          if kvstore == "instance" else "device", **kw)
    assert trainer._kvstore._compression.get_params() == \
        {"type": "2bit", "threshold": "0.05"}
    for name in ref:
        onp.testing.assert_array_equal(got[name], ref[name])
    plain, _ = _train(mt, 3)
    assert any(not onp.array_equal(got[n], plain[n]) for n in got)


def test_trainer_state_under_update_on_kvstore(tmp_path):
    _, trainer = _train(mt, 2, kvstore="device", update_on_kvstore=True)
    with pytest.raises(MXNetError, match="update_on_kvstore"):
        trainer.state_dict()
    fname = str(tmp_path / "states")
    trainer.save_states(fname)
    before = {i: [t.clone() for t in torch.utils._pytree.tree_leaves(st)]
              for i, st in trainer._kvstore._updater.states.items()}
    for st in trainer._kvstore._updater.states.values():
        for t in torch.utils._pytree.tree_leaves(st):
            t.zero_()
    trainer.load_states(fname)
    for i, st in trainer._kvstore._updater.states.items():
        for a, b in zip(before[i], torch.utils._pytree.tree_leaves(st)):
            onp.testing.assert_array_equal(b.numpy(), a.numpy())
    # the local path keeps its state_dict
    _, local = _train(mt, 1)
    assert local.state_dict()["kind"] == "Trainer"


# ---------------------------------------------------------------------------
# the registry and the refusals
# ---------------------------------------------------------------------------
def test_create_types_and_the_plugin_registry():
    for name in ("local", "device", "nccl"):
        store = kv.create(name)
        assert store.type == name and store.rank == 0 and \
            store.num_workers == 1
    assert isinstance(mt.kvstore.create(), mt.kvstore.KVStore)

    @mt.kvstore.KVStoreBase.register
    class PortTestStore(mt.kvstore.KVStoreBase):
        pass
    assert isinstance(kv.create("PortTestStore"), PortTestStore)
    assert mt.kvstore.KVStoreBase.get("portteststore") is PortTestStore
    with pytest.raises(MXNetError, match="unknown"):
        kv.create("nosuchstore")
