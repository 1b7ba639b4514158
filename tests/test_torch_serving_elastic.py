"""The port's serving resilience on the CPU, as the JAX package's
tests/test_resilience.py (serving half) and test_resilience_elastic.py hold
the reference: dispatch retries complete every request, the circuit opens,
sheds and recovers, a wedged drain is abandoned with the right errors,
degraded admission, three hot-swap cycles under load with zero errors,
corrupt / probe-mismatch / wrong-model checkpoints roll back, a checkpoint
the JAX package's ModelEndpoint.save_checkpoint wrote is read bit for bit,
and worker-kill and watchdog failover under PoolSupervisor. Small BERT (2
layers, 128 units); served rows against the direct forward within 1e-5
(the bucket's batch size moves f32 sums by ulps)."""
import os
import shutil
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.resilience.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from mxnet_tpu.serving import ModelEndpoint as JaxEndpoint

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel, params_from_jax
from mxnet_tpu_torch.resilience import (CheckpointManager, CircuitBreaker,
                                        RetryPolicy, faults,
                                        verify_checkpoint_dir)
from mxnet_tpu_torch.resilience.faults import FaultInjected
from mxnet_tpu_torch.serving import (HotSwapError, PoolSupervisor,
                                     RequestTimeoutError, ServerClosedError,
                                     ServerOverloadError)

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=128, hidden_size=256, num_heads=4,
             vocab_size=100, max_length=64, dropout=0.0)
SEQ = 16
TOL = 1e-5


def weights(seed):
    rng = onp.random.RandomState(seed)
    named = {}
    for k, p in BERTModel(**SMALL)._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        named[k] = a + 1.0 if k.endswith("gamma") else a
    return named


def port_net(named):
    net = BERTModel(**SMALL)
    net.load_state_dict(params_from_jax(named))
    return net.eval()


def endpoint(name, net, max_batch_size=4):
    return serving.ModelEndpoint(name, net, [(SEQ,), (SEQ,)], dtype="int32",
                                 max_batch_size=max_batch_size, ctx=mt.cpu())


def rows(seed, n):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab_size"], (n, SEQ)).astype(onp.int32),
            rng.randint(0, 2, (n, SEQ)).astype(onp.int32))


def one(x, i):
    return tuple(a[i] for a in x)


def direct(net, x):
    with torch.inference_mode():
        return net(*(torch.from_numpy(a) for a in x))


def wait_inflight(srv, limit=10.0):
    """Wait until the worker holds a batch (it is inside the hung step)."""
    end = time.monotonic() + limit
    while srv._inflight is None:
        assert time.monotonic() < end, "the worker never took the batch"
        time.sleep(0.005)


def close(got, want, tol=TOL):
    return all(torch.allclose(a, b, rtol=0, atol=tol)
               for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# retries, the circuit, the drain, degraded admission
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", [True, False])
def test_dispatch_retries_complete_every_request(pipeline):
    net = port_net(weights(20))
    srv = serving.InferenceServer(
        batch_timeout_ms=1.0, max_queue=64, pipeline=pipeline,
        retry_policy=RetryPolicy(max_attempts=6, base_ms=1.0))
    srv.register(endpoint("t_retry", net))
    srv.start()
    xs = rows(21, 10)
    try:
        with faults.inject("unavailable", site="serving_dispatch",
                           every_n=2) as inj:
            futs = [srv.submit("t_retry", one(xs, i)) for i in range(10)]
            outs = [f.result(timeout=60) for f in futs]
        assert inj.fires >= 1
        want = direct(net, xs)
        for i, o in enumerate(outs):
            assert close(o, tuple(w[i] for w in want))
        assert srv.health()["circuit"] == "healthy"
    finally:
        srv.stop()


def test_circuit_opens_sheds_and_recovers():
    br = CircuitBreaker(scope="t_cb", degraded_after=1, open_after=2,
                        cooldown_s=0.25)
    srv = serving.InferenceServer(
        batch_timeout_ms=1.0, max_queue=64, breaker=br,
        retry_policy=RetryPolicy(max_attempts=2, base_ms=0.5))
    srv.register(endpoint("t_cb", port_net(weights(22))))
    srv.start()
    x = one(rows(23, 1), 0)
    try:
        with faults.inject("shape_mismatch", site="serving_dispatch",
                           every_n=1, times=4):
            for _ in range(2):
                with pytest.raises(FaultInjected):
                    srv.predict("t_cb", x, timeout=30)
        assert br.state() == "open"
        with pytest.raises(ServerOverloadError):
            srv.submit("t_cb", x)
        time.sleep(0.3)
        assert srv.health()["circuit"] == "half_open"
        assert srv.predict("t_cb", x, timeout=30)[1].shape == (128,)
        assert srv.health()["circuit"] == "healthy"
        seen = br.snapshot()["transitions"]
        assert ("open", "half_open") in seen
        assert ("half_open", "healthy") in seen
    finally:
        srv.stop()


@pytest.mark.parametrize("behind", [False, True])
def test_wedged_drain_is_abandoned(behind):
    """A hung step cannot hang shutdown: the in-flight request fails with
    RequestTimeoutError, one queued behind it with ServerClosedError (or
    RequestTimeoutError when the prep stage already held it), all counted
    in ``drain_abandoned``."""
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64)
    srv.register(endpoint("t_drain", port_net(weights(24)), 2))
    srv.start()
    x = one(rows(25, 1), 0)
    try:
        with faults.inject("hang", site="serving_dispatch", seconds=2.0,
                           every_n=1, times=1):
            f1 = srv.submit("t_drain", x)
            wait_inflight(srv)               # the worker takes it and hangs
            f2 = srv.submit("t_drain", x) if behind else None
            t0 = time.monotonic()
            srv.stop(drain=True, timeout=0.2)
            assert time.monotonic() - t0 < 1.6   # not the 2 s hang
        with pytest.raises(RequestTimeoutError):
            f1.result(timeout=0.1)
        if behind:
            with pytest.raises((ServerClosedError, RequestTimeoutError)):
                f2.result(timeout=0.1)
        assert srv.drain_abandoned == 1 + behind
    finally:
        time.sleep(2.1)                      # let the wedged worker unwind


def test_degraded_breaker_tightens_admission():
    br = CircuitBreaker(scope="t_degraded", degraded_after=1, open_after=10,
                        cooldown_s=5.0)
    srv = serving.InferenceServer(batch_timeout_ms=500.0, max_queue=8,
                                  breaker=br)
    srv.register(endpoint("t_degraded", port_net(weights(26))))
    br.record_failure()
    assert br.state() == "degraded"
    srv.start()
    xs = rows(27, 6)
    try:
        with faults.inject("hang", site="serving_dispatch", seconds=0.3):
            admitted = shed = 0
            for i in range(6):
                try:
                    srv.submit("t_degraded", one(xs, i))
                    admitted += 1
                except ServerOverloadError:
                    shed += 1
            assert admitted <= 4 and shed >= 2    # half of max_queue
    finally:
        srv.stop(timeout=5.0)
    assert srv.breaker_for("t_degraded") is br
    assert serving.stats()["t_degraded"]["shed"].get("degraded", 0) >= 2


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------
def serving_ckpt(tmp_path, tag, seed, units=128):
    """Producer side: a port-written serving checkpoint (weights and a
    recorded probe) of the weights from ``seed``."""
    d = os.path.join(str(tmp_path), tag)
    cfg = dict(SMALL, units=units)
    net = BERTModel(**cfg)
    named = weights(seed) if units == 128 else None
    if named is not None:
        net.load_state_dict(params_from_jax(named))
    else:
        with mt.cpu():
            net.initialize()
    src = serving.ModelEndpoint(f"t_src_{tag}", net, [(SEQ,), (SEQ,)],
                                dtype="int32", max_batch_size=4, ctx=mt.cpu())
    src.save_checkpoint(CheckpointManager(d, fsync=False), 1, probe_seed=seed)
    serving.unregister(src.name)
    return d


@pytest.mark.parametrize("pipeline", [True, False])
def test_hot_swap_three_cycles_under_load(tmp_path, pipeline):
    d1, d2 = serving_ckpt(tmp_path, "w1", 41), serving_ckpt(tmp_path, "w2", 42)
    nets = {s: port_net(weights(s)) for s in (40, 41, 42, 43)}
    ep = endpoint("t_swap", port_net(weights(40)))
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=256,
                                  pipeline=pipeline)
    srv.register(ep)
    srv.register(endpoint("t_swap_other", nets[43]))
    srv.start()
    xs = rows(44, 16)
    stop = threading.Event()
    errors, served = [], []

    def load(name):
        i = 0
        while not stop.is_set():
            x = one(xs, i % 16)
            try:
                served.append((name, i % 16, srv.predict(name, x,
                                                         timeout=30)))
            except Exception as e:           # asserted empty below
                errors.append(repr(e))
            i += 1

    threads = [threading.Thread(target=load, args=(n,))
               for n in ("t_swap", "t_swap_other")]
    for t in threads:
        t.start()
    try:
        for cycle, d in enumerate((d1, d2, d1)):
            rep = srv.hot_swap("t_swap", d, timeout=30)
            assert rep["weights_epoch"] == cycle + 1
            assert rep["probe"] == "recorded"
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        srv.stop()
    assert errors == [] and served
    assert ep.weights_epoch == 3 and ep.stats.counters["hot_swaps"] == 3
    want = {s: direct(nets[s], xs) for s in nets}
    for name, i, got in served:
        seeds = (40, 41, 42) if name == "t_swap" else (43,)
        assert any(close(got, tuple(w[i] for w in want[s])) for s in seeds)
    # after the last cycle the endpoint serves d1's weights
    srv2 = serving.InferenceServer(batch_timeout_ms=1.0)
    srv2.register(ep, warmup=False)
    srv2.start()
    try:
        got = srv2.predict("t_swap", one(xs, 0), timeout=30)
    finally:
        srv2.stop()
    assert close(got, tuple(w[0] for w in want[41]))


def test_corrupt_checkpoint_rolls_back(tmp_path):
    d1 = serving_ckpt(tmp_path, "good", 51)
    bad_root = os.path.join(str(tmp_path), "bad")
    shutil.copytree(d1, bad_root)
    bad = os.path.join(bad_root, "ckpt-00000001", "state.npz")
    raw = bytearray(open(bad, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(raw))
    ep = endpoint("t_rb", port_net(weights(50)))
    srv = serving.InferenceServer(batch_timeout_ms=1.0)
    srv.register(ep)
    srv.start()
    x = one(rows(52, 1), 0)
    try:
        before = srv.predict("t_rb", x, timeout=30)
        with pytest.raises(HotSwapError):
            srv.hot_swap("t_rb", bad_root, timeout=30)
        after = srv.predict("t_rb", x, timeout=30)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert ep.weights_epoch == 0
        assert srv.hot_swap("t_rb", d1, timeout=30)["weights_epoch"] == 1
    finally:
        srv.stop()


def test_probe_mismatch_and_wrong_model_roll_back(tmp_path):
    d1 = serving_ckpt(tmp_path, "src", 61)
    state = verify_checkpoint_dir(os.path.join(d1, "ckpt-00000001"))
    state["model"]["params"]["p0"] = \
        onp.asarray(state["model"]["params"]["p0"]) + 1.0   # wrong weights
    ep = endpoint("t_pm", port_net(weights(60)))
    x = one(rows(62, 1), 0)
    before = ep.run_batch(tuple(a[None] for a in x), 1)[0]
    with pytest.raises(HotSwapError, match="rolled back"):
        ep.hot_swap(state)
    with pytest.raises(HotSwapError):
        ep.hot_swap(serving_ckpt(tmp_path, "shape", 71, units=64))
    after = ep.run_batch(tuple(a[None] for a in x), 1)[0]
    assert ep.weights_epoch == 0
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_reference_checkpoint_reads_bit_for_bit(tmp_path):
    """The JAX package's ModelEndpoint.save_checkpoint output: its weights
    load bit for bit; its probe (another implementation's outputs, and ids
    drawn below 0) cannot validate here, so the swap rolls back; a
    port-written checkpoint of the same weights swaps in."""
    named = weights(81)
    jnet = JaxBERT(**SMALL)
    jnet.initialize()
    z = mx.nd.array(onp.zeros((1, SEQ), onp.int32), dtype="int32")
    jnet(z, z)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(named[k]))
    jep = JaxEndpoint("t_ref_ckpt_src", jnet, [(SEQ,), (SEQ,)],
                      dtype="int32", max_batch_size=4, ctx=mx.cpu())
    ref_dir = os.path.join(str(tmp_path), "ref")
    jep.save_checkpoint(JaxCheckpointManager(ref_dir, fsync=False), 1,
                        probe_seed=5)
    jnames = list(jnet.collect_params().keys())
    jstruct = {id(p): k for k, p in jnet._collect_params_with_prefix().items()}
    order = [jstruct[id(p)] for p in jnet.collect_params().values()]

    ep = endpoint("t_ref_ckpt", port_net(weights(80)))
    host, probe, label = ep.load_swap_source(ref_dir)
    assert label.endswith("ckpt-00000001") and len(host) == len(jnames)
    for arr, key in zip(host, order):
        assert arr.dtype == onp.float32
        assert onp.array_equal(arr, named[key])
    x = one(rows(82, 1), 0)
    before = ep.run_batch(tuple(a[None] for a in x), 1)[0]
    srv = serving.InferenceServer(batch_timeout_ms=1.0)
    srv.register(ep, warmup=False)
    srv.start()
    try:
        with pytest.raises(HotSwapError, match="rolled back"):
            srv.hot_swap("t_ref_ckpt", ref_dir, timeout=30)
        assert ep.weights_epoch == 0
        got = srv.predict("t_ref_ckpt", x, timeout=30)
        assert all(torch.equal(a[None], b) for a, b in zip(got, before))
        port_dir = serving_ckpt(tmp_path, "same", 81)
        assert srv.hot_swap("t_ref_ckpt", port_dir,
                            timeout=30)["weights_epoch"] == 1
        got = srv.predict("t_ref_ckpt", x, timeout=30)
    finally:
        srv.stop()
    want = direct(port_net(named), tuple(a[None] for a in x))
    assert close(tuple(a[None] for a in got), want)


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", [True, False])
def test_worker_kill_failover_completes_every_request(pipeline, monkeypatch):
    """A BaseException kills the worker mid-stream; the supervisor starts a
    new generation, the requeued batch runs again, every request of both
    tenants completes once and right; only the victim's breaker counted."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    net_v, net_o = port_net(weights(83)), port_net(weights(84))
    srv = serving.InferenceServer(
        batch_timeout_ms=1.0, max_queue=256, pipeline=pipeline,
        retry_policy=RetryPolicy(max_attempts=2, base_ms=0.5))
    srv.register(endpoint("t_fo", net_v))
    srv.register(endpoint("t_fo_other", net_o))
    srv.start()
    sup = PoolSupervisor(srv, poll_s=0.02).start()
    xs = rows(85, 12)
    try:
        with faults.inject("worker_kill", site="serving_dispatch",
                           at=(2,)) as inj:
            futs_v = [srv.submit("t_fo", one(xs, i)) for i in range(12)]
            futs_o = [srv.submit("t_fo_other", one(xs, i))
                      for i in range(12)]
            outs_v = [f.result(timeout=60) for f in futs_v]
            outs_o = [f.result(timeout=60) for f in futs_o]
        assert inj.fires == 1
        assert sup.failovers >= 1 and sup.reports[0]["reason"] == "worker_dead"
        assert sup.reports[0]["requeued"] >= 1
        for net, outs in ((net_v, outs_v), (net_o, outs_o)):
            want = direct(net, xs)
            for i, o in enumerate(outs):
                assert close(o, tuple(w[i] for w in want))
        h = srv.health()
        assert h["worker_epoch"] >= 1 and h["failovers"] >= 1
        victim = sup.reports[0]["tenant"]
        other = "t_fo_other" if victim == "t_fo" else "t_fo"
        assert srv.breaker_for(other).snapshot()["consecutive_failures"] == 0
        c = serving.stats()["t_fo"]["counters"]
        assert c["completed"] == 12 and c["submitted"] == 12
        out = srv.predict("t_fo", one(xs, 0), timeout=30)
        assert close(out, tuple(w[0] for w in direct(net_v, xs)))
    finally:
        sup.stop()
        srv.stop()


@pytest.mark.parametrize("pipeline", [True, False])
def test_failover_during_prep_runs_the_batch_once(pipeline):
    """failover() while the worker (serial) or the prep stage (pipelined)
    is inside a hung prep: the batch is requeued once, the replacement
    serves it, and the superseded thread neither executes it nor requeues
    it again when its prep returns."""
    net = port_net(weights(93))
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64,
                                  pipeline=pipeline)
    ep = srv.register(endpoint("t_fo_prep", net))
    srv.start()
    x = one(rows(94, 1), 0)
    try:
        with faults.inject("hang", site="serving_prep", seconds=0.5,
                           every_n=1, times=1) as inj:
            fut = srv.submit("t_fo_prep", x)
            end = time.monotonic() + 10
            while inj.fires == 0:
                assert time.monotonic() < end
                time.sleep(0.002)
            report = srv.failover("test")
            out = fut.result(timeout=30)
        assert report["requeued"] == 1
        time.sleep(0.6)                      # let the zombie's prep return
        c = ep.stats.snapshot()["counters"]
        assert c["batches"] == 1 and c["completed"] == 1
        assert ep.stats.snapshot()["queue_wait"]["count"] == 1
        assert srv._inflight is None and not srv._prepared
        assert srv.endpoints() == ["t_fo_prep"]
        assert close(out, tuple(w[0] for w in direct(
            net, tuple(a[None] for a in x))))
        assert srv.predict("t_fo_prep", x, timeout=30) is not None
    finally:
        srv.stop()


@pytest.mark.parametrize("pipeline", [True, False])
def test_wedged_worker_fails_over_through_the_watchdog(pipeline):
    net = port_net(weights(91))
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64,
                                  watchdog_stall_s=0.15, pipeline=pipeline)
    srv.register(endpoint("t_wedge", net))
    srv.start()
    sup = PoolSupervisor(srv, poll_s=0.02).start()
    x = one(rows(92, 1), 0)
    try:
        with faults.inject("hang", site="serving_dispatch", seconds=2.0,
                           every_n=1, times=1):
            t0 = time.monotonic()
            out = srv.predict("t_wedge", x, timeout=30)
            elapsed = time.monotonic() - t0
        assert elapsed < 1.6                 # the replacement served it
        assert any(r["reason"] == "worker_wedged" for r in sup.reports)
        assert srv.health()["watchdog_stalls"] >= 1
        assert close(out, tuple(w[0] for w in direct(
            net, tuple(a[None] for a in x))))
    finally:
        time.sleep(2.1)                      # let the zombie unwind
        sup.stop()
        srv.stop()
    assert serving.stats()["t_wedge"]["counters"]["completed"] == 1
