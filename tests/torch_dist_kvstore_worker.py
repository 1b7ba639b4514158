"""Worker of tests/test_torch_dist_kvstore.py: the checks of the JAX
package's tests/dist_sync_kvstore_worker.py (``two``), dist_four_worker.py
(``four``) and dist_async_worker.py (``async``), on the port's stores;
``one`` (a one-rank job's collectives and dense store checks), ``kill``
(rank 1 dies while rank 0 blocks in a collective) and ``probe_<op>`` for
all_gather, reduce_scatter, all_to_all and ppermute (the backend's own
collective on card tensors, unstaged).

Started by ``mxnet_tpu_torch/tools/launch.py -n N -- python3
tests/torch_dist_kvstore_worker.py MODE [DEVICE]``. DEVICE is ``cpu``
(default) or ``cuda``, where the values live. Each rank prints one JSON line
``{"rank": r, "ok": true, ...}`` at its end; a failed check raises and the
launcher stops every rank.
"""
import json
import os
import sys
import time

import numpy as onp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.parallel import collectives
from mxnet_tpu_torch.sparse import RowSparseNDArray


def _ms(fn):
    start = time.perf_counter()
    fn()
    return (time.perf_counter() - start) * 1e3


def two(ctx, timings):
    kv = mt.kv.create("dist_sync")
    rank, size = kv.rank, kv.num_workers
    assert size == 2, f"expected 2 workers, got {size}"

    # dense push/pull over the allreduce path
    shape = (8, 4)
    kv.init("dense", nd.zeros(shape, ctx=ctx))
    timings["push"] = _ms(lambda: kv.push(
        "dense", nd.ones(shape, ctx=ctx) * (rank + 1)))
    out = nd.zeros(shape, ctx=ctx)
    timings["pull"] = _ms(lambda: kv.pull("dense", out=out))
    onp.testing.assert_allclose(out.asnumpy(), onp.full(shape, 3.0),
                                rtol=1e-6)
    assert out.context == ctx

    # fused pushpull
    val = nd.ones(shape, ctx=ctx) * (10 + rank)  # 10 + 11 = 21
    timings["pushpull"] = _ms(lambda: kv.pushpull("pp", val, out=val))
    onp.testing.assert_allclose(val.asnumpy(), onp.full(shape, 21.0),
                                rtol=1e-6)

    # row_sparse with different per-worker nnz
    dense_shape = (10, 3)
    kv.init("rsp", nd.zeros(dense_shape, ctx=ctx))
    if rank == 0:
        idx, vals = [1, 4], [[1.0] * 3, [2.0] * 3]
    else:
        idx, vals = [4, 7, 9], [[10.0] * 3, [20.0] * 3, [30.0] * 3]
    rsp = RowSparseNDArray(onp.array(vals, "float32"),
                           onp.array(idx, "int32"), dense_shape, ctx=ctx)
    timings["push_row_sparse"] = _ms(lambda: kv.push("rsp", rsp))
    out = nd.zeros(dense_shape, ctx=ctx)
    kv.pull("rsp", out=out, ignore_sparse=False)
    expect = onp.zeros(dense_shape, "float32")
    expect[1], expect[4], expect[7], expect[9] = 1.0, 12.0, 20.0, 30.0
    onp.testing.assert_allclose(out.asnumpy(), expect, rtol=1e-6)
    sub = nd.zeros(dense_shape, ctx=ctx)
    timings["row_sparse_pull"] = _ms(lambda: kv.row_sparse_pull(
        "rsp", out=sub, row_ids=nd.array([4, 9], ctx=ctx)))
    expect_sub = onp.zeros(dense_shape, "float32")
    expect_sub[4], expect_sub[9] = 12.0, 30.0
    onp.testing.assert_allclose(sub.asnumpy(), expect_sub, rtol=1e-6)

    # 2-bit compression: packed wire and error feedback
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("comp", nd.zeros(shape, ctx=ctx))
    g = nd.ones(shape, ctx=ctx) * 0.3   # below threshold: 0, residual 0.3
    before = kv.wire_bytes, kv.payload_bytes
    timings["push_2bit"] = _ms(lambda: kv.push("comp", g))
    wire, payload = kv.wire_bytes - before[0], kv.payload_bytes - before[1]
    assert wire * 16 == payload, (wire, payload)
    out = nd.zeros(shape, ctx=ctx)
    kv.pull("comp", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.zeros(shape), atol=1e-7)
    kv.push("comp", g)   # residual 0.3 + 0.3 = 0.6 >= 0.5: each sends +0.5
    kv.pull("comp", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full(shape, 1.0),
                                rtol=1e-6)

    # 1-bit: signs and the mean |g| as the scale (1/32 of the f32 bytes)
    kv1 = mt.kv.create("dist_sync")
    kv1.set_gradient_compression({"type": "1bit"})
    kv1.init("one", nd.zeros((8, 8), ctx=ctx))
    kv1.push("one", nd.ones((8, 8), ctx=ctx) * 0.3)
    assert kv1.wire_bytes * 32 == kv1.payload_bytes
    out1 = nd.zeros((8, 8), ctx=ctx)
    kv1.pull("one", out=out1)
    onp.testing.assert_allclose(out1.asnumpy(), onp.full((8, 8), 0.6),
                                rtol=1e-6)

    # dist_async: every push applied on arrival by rank 0's service
    kva = mt.kv.create("dist_async")
    kva.set_optimizer(mt.optimizer.SGD(learning_rate=1.0, wd=0.0))
    kva.init("aw", nd.zeros((4,), ctx=ctx))
    for _ in range(3):
        kva.push("aw", nd.ones((4,), ctx=ctx) * (rank + 1))
    out = nd.zeros((4,), ctx=ctx)
    deadline = time.time() + 30
    while time.time() < deadline:
        kva.pull("aw", out=out)
        if abs(float(out.asnumpy()[0]) + 9.0) < 1e-6:
            break
        time.sleep(0.05)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((4,), -9.0),
                                rtol=1e-6)
    assert out.context == ctx

    # the collective store
    kvc = mt.kv.create("collective")
    bout = nd.zeros((3,), ctx=ctx)
    src = nd.array([7.0, 8.0, 9.0], ctx=ctx) * (rank + 1)
    timings["collective_broadcast"] = _ms(
        lambda: kvc.broadcast("cw", src, out=bout))
    onp.testing.assert_allclose(bout.asnumpy(), [7.0, 8.0, 9.0])
    pv = nd.ones((3,), ctx=ctx) * (rank + 1)
    timings["collective_pushpull"] = _ms(
        lambda: kvc.pushpull("cg", pv, out=pv))
    onp.testing.assert_allclose(pv.asnumpy(), onp.full(3, 3.0))

    # p3: sliced wire transfers still sum
    prev = mt.config.get("MXNET_P3_SLICE_SIZE")
    mt.config.set("MXNET_P3_SLICE_SIZE", 8)
    kvp = mt.kv.create("p3")
    kvp.init("pw", nd.zeros((5, 5), ctx=ctx))
    wire0 = kvp.wire_bytes
    timings["push_p3"] = _ms(lambda: kvp.push(
        "pw", nd.ones((5, 5), ctx=ctx) * (rank + 1)))
    assert kvp.wire_bytes - wire0 == 25 * 4
    pout = nd.zeros((5, 5), ctx=ctx)
    kvp.pull("pw", out=pout)
    onp.testing.assert_allclose(pout.asnumpy(), onp.full((5, 5), 3.0))
    mt.config.set("MXNET_P3_SLICE_SIZE", prev)

    # gluon.Trainer over the job with momentum: under update_on_kvstore
    # the store sums the workers' gradients once (1 + 2) and updates its
    # weight, as the local update does after the pushpull: w = 1 - 0.3,
    # then 0.7 - 0.57
    for on_kvstore in (False, True):
        param = gluon.Parameter(f"trainer_w{int(on_kvstore)}", shape=(3,))
        param.initialize(init=mt.init.Constant(1.0), ctx=ctx)
        trainer = gluon.Trainer([param], "sgd", {"learning_rate": 0.1,
                                                 "momentum": 0.9},
                                kvstore="dist_sync",
                                update_on_kvstore=on_kvstore)
        for _ in range(2):
            param.grad()._set_data(param.data()._data * 0 + (rank + 1))
            trainer.step(1)
        onp.testing.assert_allclose(param.data().asnumpy(),
                                    onp.full(3, 0.13), rtol=1e-6)

    # the heartbeat: every worker's beat is fresh
    assert kv.num_dead_node(timeout_sec=60) == 0
    kv.barrier()
    kva.close()
    return {"wire_bytes": wire, "payload_bytes": payload}


def four(ctx, timings):
    kv = mt.kv.create("dist_sync")
    rank, size = kv.rank, kv.num_workers
    assert size == 4, f"expected 4 workers, got {size}"
    shape = (4, 8)
    kv.init("w", nd.zeros(shape, ctx=ctx))
    timings["push"] = _ms(lambda: kv.push(
        "w", nd.ones(shape, ctx=ctx) * (rank + 1)))   # 1+2+3+4 = 10
    out = nd.zeros(shape, ctx=ctx)
    kv.pull("w", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full(shape, 10.0),
                                rtol=1e-6)
    val = nd.ones(shape, ctx=ctx) * (rank + 1)
    timings["pushpull"] = _ms(lambda: kv.pushpull("pp", val, out=val))
    onp.testing.assert_allclose(val.asnumpy(), onp.full(shape, 10.0),
                                rtol=1e-6)
    assert kv.num_dead_node(timeout_sec=60) == 0
    return {}


LAG = 3.0


def async_(ctx, timings):
    """Rank 3 lags; ranks 0-2 see applied updates before it pushes."""
    kv = mt.kv.create("dist_async")
    rank, size = kv.rank, kv.num_workers
    assert size == 4 and kv.type == "dist_async"

    def updater(key, grad, weight):
        weight -= 0.1 * grad

    kv.set_updater(updater)
    shape = (2, 4)
    kv.init("w", nd.zeros(shape, ctx=ctx))
    if rank == 3:
        time.sleep(LAG)
        record = {"pushed_at": time.time()}
        kv.push("w", nd.ones(shape, ctx=ctx))
    else:
        kv.push("w", nd.ones(shape, ctx=ctx) * (rank + 1))
        out = nd.zeros(shape, ctx=ctx)
        kv.pull("w", out=out)
        seen = float(out.asnumpy()[0, 0])
        record = {"seen_nonzero_at": time.time(), "seen": seen}
        assert seen < 0.0, f"rank {rank}: nothing applied before the laggard"
    deadline = time.time() + 60
    out = nd.zeros(shape, ctx=ctx)
    while time.time() < deadline:    # 1+2+3+1 = 7 -> -0.7
        kv.pull("w", out=out)
        if abs(float(out.asnumpy()[0, 0]) + 0.7) < 1e-5:
            break
        time.sleep(0.1)
    onp.testing.assert_allclose(out.asnumpy(), onp.full(shape, -0.7),
                                rtol=1e-5)
    kv.close()
    return record


def one(ctx, timings):
    """A one-rank job: the world collectives the stores use run over its
    process group (NCCL where the rank has a card), and a dist_sync
    store's dense push, pull and pushpull."""
    import torch
    t = torch.arange(8.0, device=ctx.torch_device())
    timings["all_reduce"] = _ms(lambda: collectives.world_all_reduce(t))
    assert t.tolist() == [float(i) for i in range(8)]
    g = collectives.world_all_gather(t)
    assert g.shape == (1, 8) and g.device == t.device
    timings["broadcast"] = _ms(lambda: collectives.world_broadcast(t))
    kv = mt.kv.create("dist_sync")
    assert kv.num_workers == 1
    kv.init("w", nd.zeros((4, 8), ctx=ctx))
    kv.push("w", nd.ones((4, 8), ctx=ctx) * 3)
    out = nd.zeros((4, 8), ctx=ctx)
    kv.pull("w", out=out)
    onp.testing.assert_allclose(out.asnumpy(), onp.full((4, 8), 3.0))
    val = nd.ones((4, 8), ctx=ctx)
    kv.pushpull("pp", val, out=val)
    onp.testing.assert_allclose(val.asnumpy(), onp.ones((4, 8)))
    return {}


def probe(op):
    """The backend's own ``op`` on card tensors, unstaged, 20 times on
    values computed just before on the card (after a long product, so a
    collective that does not wait for its input reads stale memory), each
    result checked: the job exits non-zero where the backend does not take
    it or gets it wrong."""
    def run(ctx, timings):
        import torch
        import torch.distributed as dist
        collectives.initialize_distributed()
        dev = ctx.torch_device()
        r, n = collectives.rank(), collectives.num_workers()
        big = torch.randn(1024 if dev.type == "cpu" else 4096, 1024 if dev.type == "cpu" else 4096, device=dev)
        for it in range(20):
            t = (big @ big)[0, :0].sum() + torch.arange(
                4.0, device=dev) + 10 * r + 100 * it
            base = torch.arange(4.0, device=dev) + 100 * it
            if op == "all_gather":
                out = t.new_empty(4 * n)
                dist.all_gather_into_tensor(out, t)
                want = torch.cat([base + 10 * q for q in range(n)])
            elif op == "reduce_scatter":
                out = t.new_empty(4 // n)
                dist.reduce_scatter_tensor(out, t)
                full = sum(base + 10 * q for q in range(n))
                want = full.chunk(n)[r]
            elif op == "all_to_all":
                out = torch.empty_like(t)
                dist.all_to_all_single(out, t)
                want = torch.cat([(base + 10 * q).chunk(n)[r]
                                  for q in range(n)])
            else:
                out = torch.empty_like(t)
                ops = [dist.P2POp(dist.isend, t, 1 - r),
                       dist.P2POp(dist.irecv, out, 1 - r)]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
                want = base + 10 * (1 - r)
            assert torch.equal(out, want), (op, it, out, want)
        return {"native": op}
    return run


def kill(ctx, timings):
    """Rank 1 dies after joining; rank 0 waits in a collective until the
    launcher stops it."""
    kv = mt.kv.create("dist_sync")
    if kv.rank == 1:
        os._exit(3)
    kv.init("k", nd.zeros((2,), ctx=ctx))
    kv.push("k", nd.ones((2,), ctx=ctx))
    return {}


def main():
    mode = sys.argv[1]
    dev = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    ctx = mt.gpu(0) if dev == "cuda" else mt.cpu()
    timings = {}
    with ctx:
        extra = {"two": two, "four": four, "async": async_,
                 "kill": kill, "one": one,
                 **{f"probe_{op}": probe(op) for op in (
                     "all_gather", "reduce_scatter", "all_to_all",
                     "ppermute")}}[mode](
            ctx, timings)
    line = json.dumps({"rank": collectives.rank(), "mode": mode, "ok": True,
                       "backend": collectives.backend(),
                       "host_staged": collectives.host_staged(),
                       "ms": timings, **extra})
    os.write(1, (line + "\n").encode())   # one write: ranks share the pipe
    collectives.barrier()


if __name__ == "__main__":
    sys.exit(main())
