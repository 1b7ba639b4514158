"""The port's distributed KVStores against the JAX package's
tests/test_dist_kvstore.py: the reference workers' checks ported
(tests/torch_dist_kvstore_worker.py) on 2 and 4 ranks started by
``mxnet_tpu_torch/tools/launch.py`` (gloo on the CPU), async staleness with
a lagging rank, the heartbeat, the single-process dist stores and the
collective store, the compressed wire against the reference's packing, a
killed rank, and F6: ``kv.create`` of every reference type in one process,
held against the reference's store and Trainer.

Every job has a process-group timeout (``MXNET_DIST_TIMEOUT``) and the
launcher's timeout, and the launcher stops every rank when one fails.
"""
import json
import os
import sys
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kvstore.gradient_compression import \
    GradientCompression as JaxCompression

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, gluon, nd
from mxnet_tpu_torch.parallel import collectives
from mxnet_tpu_torch.tools import launch

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_kvstore_worker.py")
CPU = mt.cpu()


def _launch(n, mode, timeout=120, **env):
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1", **env)
    start = time.monotonic()
    proc = launch.run(n, [sys.executable, WORKER, mode], timeout=timeout,
                      env=env)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return proc, lines, time.monotonic() - start


@pytest.mark.parametrize("n, mode", [(2, "two"), (4, "four")])
def test_reference_worker_checks(n, mode):
    """dist_sync dense push/pull and pushpull, row-sparse pushes of unequal
    nnz and row_sparse_pull, 2-bit (1/16 of the f32 bytes on the wire, error
    feedback 0 -> 1.0) and 1-bit compression, dist_async converging to -9,
    the collective store, p3 slices, gluon.Trainer with momentum with and
    without update_on_kvstore, and the heartbeat (2 ranks); the dense sums
    of all four ranks (4 ranks)."""
    proc, lines, _ = _launch(n, mode)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    assert sorted(ln["rank"] for ln in lines) == list(range(n))
    assert all(ln["ok"] and ln["backend"] == "gloo" for ln in lines)


def test_async_staleness_with_a_lagging_rank():
    """Rank 3 sleeps before its only push; ranks 0-2 see applied updates
    before it pushes (dist_sync could not finish without it), and the final
    weight has every push (test_dist_kvstore.py:116)."""
    proc, lines, _ = _launch(4, "async")
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    rec = {ln["rank"]: ln for ln in lines}
    assert sorted(rec) == [0, 1, 2, 3]
    for r in range(3):
        assert rec[r]["seen_nonzero_at"] < rec[3]["pushed_at"], rec


def test_a_killed_rank_stops_the_job():
    """Rank 1 exits while rank 0 waits in a collective: the launcher stops
    rank 0 and returns 1 long before any timeout."""
    proc, _, seconds = _launch(2, "kill", timeout=60)
    assert proc.returncode == 1, proc.stderr[-4000:]
    assert "stopping the others" in proc.stderr
    assert seconds < 30


def test_collective_store_single_process():
    """The collective store in one process (test_dist_kvstore.py:27)."""
    with CPU:
        kv = mt.kv.create("collective")
        assert kv.type == "collective" and kv.num_workers == 1
        a = nd.array(onp.ones((2, 3), "float32"))
        b = nd.array(onp.full((2, 3), 2.0, "float32"))
        kv.pushpull("k", [a, b])
        onp.testing.assert_allclose(a.asnumpy(), onp.full((2, 3), 3.0))
        out = nd.zeros((2, 3))
        kv.broadcast("k", nd.array(onp.full((2, 3), 7.0, "float32")), out)
        onp.testing.assert_allclose(out.asnumpy(), onp.full((2, 3), 7.0))
        with pytest.raises(MXNetError, match="pushpull-only"):
            kv.push("k", a)
        with pytest.raises(MXNetError, match="pushpull-only"):
            kv.pull("k", out=a)


def test_async_store_single_process():
    """dist_async in one process applies each push at once
    (test_dist_kvstore.py:47)."""
    with CPU:
        kv = mt.kv.create("dist_async")
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=1.0, wd=0.0))
        kv.init("w", nd.zeros((3,)))
        kv.push("w", nd.ones((3,)))
        out = nd.zeros((3,))
        kv.pull("w", out=out)
        onp.testing.assert_allclose(out.asnumpy(), -onp.ones(3), rtol=1e-6)


def test_heartbeat_failure_detection(tmp_path):
    """num_dead_node counts stale or absent heartbeats
    (test_dist_kvstore.py:63)."""
    mt.config.set("MXNET_KVSTORE_HEARTBEAT_DIR", str(tmp_path))
    kv = None
    try:
        kv = mt.kv.create("dist_sync")
        assert (tmp_path / "heartbeat_0").exists()
        assert kv.num_dead_node(timeout_sec=60) == 0
        stale = tmp_path / "heartbeat_1"
        stale.write_text(str(time.time() - 3600))
        assert kv.num_dead_node(timeout_sec=60) == 0   # one worker
        real = type(kv).num_workers
        try:
            type(kv).num_workers = property(lambda self: 2)
            assert kv.num_dead_node(timeout_sec=60) == 1
            stale.write_text(str(time.time()))
            assert kv.num_dead_node(timeout_sec=60) == 0
            (tmp_path / "heartbeat_1").unlink()
            assert kv.num_dead_node(timeout_sec=60) == 1
        finally:
            type(kv).num_workers = real
    finally:
        if kv is not None:
            kv.close()
        mt.config.set("MXNET_KVSTORE_HEARTBEAT_DIR", None)


@pytest.mark.parametrize("kind, threshold", [("2bit", 0.5), ("1bit", 0.0)])
def test_compressed_wire_is_the_references(kind, threshold, monkeypatch):
    """The bytes a worker gathers for a compressed push of a summed gradient
    are bitwise the reference's ``quantize`` of it (the 1-bit scale, a
    mean, within 4 f32 ulps: XLA sums in its own order), over three pushes
    with their residuals, and the sum the store keeps is what the
    reference dequantizes."""
    rng = onp.random.RandomState(2)
    grads = [rng.randn(6, 5).astype("float32") for _ in range(3)]
    ref = JaxCompression(type=kind, threshold=threshold)
    sent = []
    real = collectives.world_all_gather

    def spy(t):
        sent.append(t.clone())
        return real(t)
    monkeypatch.setattr(collectives, "world_all_gather", spy)
    with CPU:
        kv = mt.kv.create("dist_sync")
        kv.set_gradient_compression({"type": kind, "threshold": threshold})
        for g in grads:
            sent.clear()
            total = kv._compressed_sum("k", kv._compression,
                                       torch.from_numpy(g.copy()))
            packed, scale = ref.quantize(("k", "wire"), mx.nd.array(g).data)
            onp.testing.assert_array_equal(sent[0].numpy(),
                                           onp.asarray(packed))
            s_port, s_ref = float(sent[1]), float(onp.asarray(scale))
            assert abs(s_port - s_ref) <= 4 * onp.spacing(onp.float32(s_ref))
            want = onp.asarray(ref.dequantize(packed, scale, g.shape,
                                              onp.float32))
            onp.testing.assert_allclose(total.numpy(), want, rtol=1e-6,
                                        atol=0)
            assert sent[0].numel() * (16 if kind == "2bit" else 32) >= \
                g.size and sent[0].dtype == torch.uint8


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_async", "p3", "horovod", "tpu"])
def test_f6_every_reference_type_in_one_process(name):
    """F6: every type of the reference's ``_TYPES`` makes a store in one
    process, with the reference's type, rank and worker count (before the
    fix the port refused the dist types, horovod and tpu), and a Trainer
    over it takes the reference Trainer's SGD step."""
    port = mt.kv.create(name)
    ref = mx.kv.create(name)
    assert (port.type, port.rank, port.num_workers) == \
        (ref.type, ref.rank, ref.num_workers)
    w = onp.array([0.5, -1.0, 2.0], "float32")
    g = onp.array([0.25, 1.0, -3.0], "float32")
    with CPU:
        p = gluon.Parameter("w", shape=(3,))
        p.initialize()
        p.set_data(nd.array(w))
        p.grad()._set_data(torch.from_numpy(g.copy()))
        tr = gluon.Trainer([p], "sgd", {"learning_rate": 0.1}, kvstore=name)
        tr.step(2)
    jp = mx.gluon.Parameter("w", shape=(3,))
    jp.initialize()
    jp.set_data(mx.nd.array(w))
    jp.grad()._set_data(mx.nd.array(g).data)
    jtr = mx.gluon.Trainer([jp], "sgd", {"learning_rate": 0.1},
                           kvstore=name)
    jtr.step(2)
    onp.testing.assert_array_equal(p.data().asnumpy(), jp.data().asnumpy())
