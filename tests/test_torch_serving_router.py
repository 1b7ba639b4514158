"""The port's multi-tenant serving core on the CPU: Router.select against the
JAX package's on seeded random tenant sets (exactly, decision by decision),
the pipelined server bitwise equal to the serial one, served rows against
the JAX package's ModelEndpoint.run_batch (f32 within 1e-4, as
tests/test_torch_serving.py), per-tenant shedding, the queue-full shed
reason and the queue-wait / prep / overlap metrics. Small BERT: 2 layers,
128 units."""
import random
import sys
import threading
import time
from concurrent.futures import Future

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.resilience.watchdog import CircuitBreaker as JaxBreaker
from mxnet_tpu.serving import ModelEndpoint as JaxEndpoint
from mxnet_tpu.serving import tailguard as jtg
from mxnet_tpu.serving.batcher import EndpointQueue as JaxQueue
from mxnet_tpu.serving.batcher import Request as JaxRequest
from mxnet_tpu.serving.router import Router as JaxRouter
from mxnet_tpu.serving.router import StepCostEWMA as JaxEWMA
from mxnet_tpu.serving.router import Tenant as JaxTenant
from mxnet_tpu.serving.stats import EndpointStats as JaxStats

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel, params_from_jax
from mxnet_tpu_torch.resilience import faults
from mxnet_tpu_torch.resilience.watchdog import CircuitBreaker
from mxnet_tpu_torch.serving import ServerOverloadError, tailguard as tg
from mxnet_tpu_torch.serving.batcher import (EndpointQueue, Request, fail,
                                             resolve)
from mxnet_tpu_torch.serving.router import Router, StepCostEWMA, Tenant
from mxnet_tpu_torch.serving.stats import EndpointStats

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=128, hidden_size=256, num_heads=4,
             vocab_size=100, max_length=64, dropout=0.0)
SEQ = 16


def weights(seed=0):
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


def rows(rng, n):
    return (rng.randint(0, SMALL["vocab_size"], (n, SEQ)).astype(onp.int32),
            rng.randint(0, 2, (n, SEQ)).astype(onp.int32))


def endpoint(name, net, max_batch_size=8):
    return serving.ModelEndpoint(name, net, [(SEQ,), (SEQ,)], dtype="int32",
                                 max_batch_size=max_batch_size, ctx=mt.cpu())


def direct(net, tok, typ):
    with torch.inference_mode():
        return net(torch.from_numpy(tok), torch.from_numpy(typ))


# ---------------------------------------------------------------------------
# Router.select against the reference, decision by decision
# ---------------------------------------------------------------------------
class StubEndpoint:
    """The reference test's stub: buckets, a step-cost EWMA and stats."""

    def __init__(self, name, stats_cls, ewma_cls, max_batch, buckets):
        self.name = name
        self.max_batch_size = max_batch
        self.buckets = buckets
        self.stats = stats_cls(name)
        self.step_cost = ewma_cls()


def _tenant_pair(rng, i):
    name = f"t{i}"
    max_batch = rng.choice([2, 4, 8])
    buckets = tuple(b for b in (1, 2, 4, 8) if b <= max_batch)
    slo_us = rng.choice([None, 5_000, 30_000, 200_000])
    timeout_us = 2000
    pair = []
    for pkg in ((JaxStats, JaxEWMA, JaxQueue, JaxTenant, JaxBreaker),
                (EndpointStats, StepCostEWMA, EndpointQueue, Tenant,
                 CircuitBreaker)):
        stats_cls, ewma_cls, queue_cls, tenant_cls, breaker_cls = pkg
        ep = StubEndpoint(name, stats_cls, ewma_cls, max_batch, buckets)
        pair.append(tenant_cls(name, ep, queue_cls(ep, 256, timeout_us),
                               breaker_cls(scope=name), slo_us=slo_us))
    for b in rng.sample(buckets, rng.randrange(0, len(buckets) + 1)):
        us = rng.uniform(200, 80_000)
        for t in pair:
            t.endpoint.step_cost.observe(b, us)
    return pair


def _enqueue(pair, rng, now):
    n = rng.randrange(0, 4)
    for _ in range(n):
        r = rng.randint(1, pair[0].endpoint.max_batch_size)
        age = rng.choice([0, 500, 3_000, 50_000, 2_000_000])
        dl = rng.choice([None, None, now + rng.randrange(-5_000, 60_000)])
        for t, cls in zip(pair, (JaxRequest, Request)):
            req = cls(tuple([onp.zeros((r, 4), "float32")]), r, False)
            req.enqueue_us = now - age
            req.deadline_us = dl
            t.queue.offer(req)


@pytest.mark.parametrize("level", [0, 1])
def test_router_select_equals_the_reference(level):
    rng = random.Random(31 + level)
    jtg.BROWNOUT.level = tg.BROWNOUT.level = level
    contested = 0
    try:
        for trial in range(150):
            now = 10_000_000 + rng.randrange(10 ** 6)
            jr, pr = JaxRouter(batch_timeout_us=2000), \
                Router(batch_timeout_us=2000)
            for i in range(rng.randrange(1, 6)):
                jt, pt = _tenant_pair(rng, i)
                _enqueue((jt, pt), rng, now)
                jr.add(jt)
                pr.add(pt)
            for flush in (False, True):
                a, b = jr.select(now, flush), pr.select(now, flush)
                assert (a and a.name) == (b and b.name), trial
                contested += sum(t.queue.ready(now, flush)
                                 for t in pr.tenants()) > 1
            for jt, pt in zip(jr.tenants(), pr.tenants()):
                assert jt.queue.ready(now) == pt.queue.ready(now)
                if len(pt.queue):
                    assert jr.slack_us(jt, now) == pr.slack_us(pt, now)
                    assert jr.effective_deadline_us(jt) == \
                        pr.effective_deadline_us(pt)
            assert jr.next_wakeup_us() == pr.next_wakeup_us()
        assert contested > 100      # most decisions pick among several
    finally:
        jtg.BROWNOUT.reset()
        tg.BROWNOUT.reset()


def test_resolve_fail_swallow_only_invalid_state():
    f = Future()
    assert f.cancel()
    resolve(f, 1)
    f2 = Future()
    f2.set_result(1)
    resolve(f2, 2)
    fail(f2, RuntimeError("late"))

    class Broken(Future):
        def set_result(self, v):
            raise RuntimeError("broken result plumbing")

        def set_exception(self, e):
            raise RuntimeError("broken exception plumbing")

    with pytest.raises(RuntimeError, match="broken result"):
        resolve(Broken(), 1)
    with pytest.raises(RuntimeError, match="broken exception"):
        fail(Broken(), ValueError("x"))


# ---------------------------------------------------------------------------
# pipelined against serial, and against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_bitwise_equals_serial(depth):
    """A fixed script of requests, one at a time, assembles the same rows
    into the same buckets on both paths (depth d cycles d + 1 slots): byte
    for byte equal outputs."""
    net = port_net(weights(1))
    rng = onp.random.RandomState(42)
    script = [rows(rng, r) for r in (1, 3, 5, 8, 2, 7)]
    outs = {}
    for pipe in (False, True):
        srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64,
                                      pipeline=pipe, pipeline_depth=depth)
        srv.register(endpoint(f"t_pipe_{pipe}", net))
        srv.start()
        try:
            outs[pipe] = [srv.predict(f"t_pipe_{pipe}", r, timeout=60)
                          for r in script]
        finally:
            srv.stop()
    for a, b in zip(outs[False], outs[True]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.numpy().tobytes() == y.numpy().tobytes()


def test_pipelined_concurrent_clients_match_direct_and_reference():
    named = weights(2)
    net = port_net(named)
    ep = endpoint("t_pipe_conc", net)
    srv = serving.InferenceServer(batch_timeout_ms=3.0, max_queue=128,
                                  pipeline=True)
    srv.register(ep)
    srv.start()
    rng = onp.random.RandomState(44)
    reqs = [rows(rng, int(rng.randint(1, 5))) for _ in range(24)]
    results = [None] * len(reqs)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(i):
            results[i] = srv.predict("t_pipe_conc", reqs[i], timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    for (tok, typ), got in zip(reqs, results):
        want = direct(net, tok, typ)
        for a, b in zip(got, want):
            onp.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                        atol=1e-5)
    # the same rows through the reference's run_batch, f32 within 1e-4
    jnet = JaxBERT(**SMALL)
    jnet.initialize()
    z = mx.nd.array(onp.zeros((1, SEQ), onp.int32), dtype="int32")
    jnet(z, z)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(named[k]))
    jep = JaxEndpoint("torch_router_parity", jnet, [(SEQ,), (SEQ,)],
                      dtype="int32", max_batch_size=8, ctx=mx.cpu())
    tok, typ = reqs[0]
    j_outs, _ = jep.run_batch((tok, typ), len(tok))
    for a, b in zip(results[0], j_outs):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b)[:len(tok)],
                                    rtol=0, atol=1e-4)
    snap = ep.stats.snapshot()
    assert snap["counters"]["completed"] == len(reqs)
    assert snap["queue_wait"]["count"] == len(reqs)
    assert snap["prep"]["count"] == snap["counters"]["batches"]


# ---------------------------------------------------------------------------
# per-tenant shedding and the metrics
# ---------------------------------------------------------------------------
def test_open_breaker_sheds_one_tenant_not_the_server():
    net = port_net(weights(3))
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=16)
    srv.register(endpoint("t_shed_a", net, 4),
                 breaker=CircuitBreaker(scope="serving:t_shed_a",
                                        degraded_after=1, open_after=1,
                                        cooldown_s=60.0))
    srv.register(endpoint("t_shed_b", net, 4))
    srv.start()
    x = rows(onp.random.RandomState(4), 1)
    try:
        assert srv.predict("t_shed_a", x, timeout=30)[0].shape == (1, SEQ, 128)
        srv.breaker_for("t_shed_a").record_failure()      # -> OPEN
        with pytest.raises(ServerOverloadError):
            srv.submit("t_shed_a", x)
        assert srv.predict("t_shed_b", x, timeout=30)[0].shape == (1, SEQ, 128)
        h = srv.health()
        assert h["endpoints"]["t_shed_a"]["circuit"] == "open"
        assert h["endpoints"]["t_shed_b"]["circuit"] == "healthy"
        assert h["circuit"] == "open"
        assert serving.stats()["t_shed_a"]["shed"].get("circuit_open") == 1
    finally:
        srv.stop()


def test_queue_full_shed_reason_counted():
    srv = serving.InferenceServer(batch_timeout_ms=60_000.0, max_queue=64)
    ep = srv.register(endpoint("t_shed_q", port_net(weights(5))), max_queue=2)
    srv.start()
    x = rows(onp.random.RandomState(6), 1)
    futs = [srv.submit("t_shed_q", x) for _ in range(2)]
    with pytest.raises(ServerOverloadError):
        srv.submit("t_shed_q", x)
    snap = ep.stats.snapshot()
    assert snap["shed"] == {"queue_full": 1}
    assert snap["counters"]["rejected"] == 1
    assert snap["queue_depth"] == 2 and snap["queue_peak"] == 2
    srv.stop(drain=True)
    for f in futs:
        assert f.result(timeout=5)[0].shape == (1, SEQ, 128)


def test_queue_wait_prep_and_overlap_metrics():
    ep = endpoint("t_qw", port_net(weights(7)), 4)
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64,
                                  pipeline=True)
    srv.register(ep)
    srv.start()
    rng = onp.random.RandomState(8)
    try:
        for _ in range(6):
            srv.predict("t_qw", rows(rng, 2), timeout=60)
        ratio = srv.health()["prep_overlap_ratio"]
    finally:
        srv.stop()
    snap = serving.stats()["t_qw"]
    assert snap["queue_wait"]["count"] == 6
    assert snap["prep"]["count"] == snap["counters"]["batches"] == 6
    assert 0.0 <= ratio <= 1.0
    assert snap["prep_overlap_ratio"] == pytest.approx(ratio)
    assert snap["counters"]["compiles"] == len(ep.buckets)


def test_requeued_request_records_its_queue_wait_once():
    """A failover's requeue_front puts assembled requests back; their
    second assembly does not record a second queue wait."""
    ep = endpoint("t_qw_once", port_net(weights(7)), 4)
    q = EndpointQueue(ep, 64, 0)
    reqs = [Request(rows(onp.random.RandomState(i), 1), 1, False)
            for i in range(3)]
    for r in reqs:
        assert q.offer(r)
    first = q.take_batch(10**15)
    assert first == reqs and ep.stats.snapshot()["queue_wait"]["count"] == 3
    q.requeue_front(first[1:])
    assert q.take_batch(10**15) == reqs[1:]
    assert ep.stats.snapshot()["queue_wait"]["count"] == 3


# ---------------------------------------------------------------------------
# when the prep stage assembles
# ---------------------------------------------------------------------------
def _held_server(name, max_batch_size, step_s):
    """A pipelined server whose step-cost EWMA predicts ``step_s`` a step,
    and the endpoint."""
    ep = endpoint(name, port_net(weights(11)), max_batch_size)
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64,
                                  pipeline=True)
    srv.register(ep)
    ep.step_cost = StepCostEWMA(alpha=1.0)
    for b in ep.buckets:
        ep.step_cost.observe(b, step_s * 1e6)
    return srv.start(), ep


def _wait_for(cond, limit=10.0):
    end = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.002)


def test_prep_holds_a_partial_batch_until_the_step_is_predicted_to_end():
    """Rows that arrive while a step runs join one batch: prep does not
    seal the first of them as soon as the handoff has room (that split a
    tenant's closed-loop traffic into smaller batches)."""
    srv, ep = _held_server("t_hold", 8, 0.4)
    rng = onp.random.RandomState(12)
    xs = [rows(rng, 1) for _ in range(3)]
    try:
        with faults.inject("hang", site="serving_dispatch", seconds=0.4,
                           every_n=1, times=1):
            f0 = srv.submit("t_hold", xs[0])
            _wait_for(lambda: srv._inflight is not None)
            f1 = srv.submit("t_hold", xs[1])
            time.sleep(0.1)
            assert not srv._prepared and srv._preparing is None   # held
            f2 = srv.submit("t_hold", xs[2])
            outs = [f.result(timeout=30) for f in (f0, f1, f2)]
    finally:
        srv.stop()
    assert ep.stats.snapshot()["counters"]["batches"] == 2
    net = port_net(weights(11))
    for x, got in zip(xs, outs):
        for a, b in zip(got, direct(net, *x)):
            onp.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                        atol=1e-5)


def test_prep_assembles_a_full_bucket_at_once():
    """A full bucket cannot grow: prep assembles and stages it while the
    step in flight still runs."""
    srv, ep = _held_server("t_hold_full", 4, 5.0)
    rng = onp.random.RandomState(13)
    try:
        with faults.inject("hang", site="serving_dispatch", seconds=0.5,
                           every_n=1, times=1):
            f0 = srv.submit("t_hold_full", rows(rng, 1))
            _wait_for(lambda: srv._inflight is not None)
            futs = [srv.submit("t_hold_full", rows(rng, 2))
                    for _ in range(2)]
            _wait_for(lambda: len(srv._prepared) == 1, limit=0.3)
            assert srv._inflight is not None and not f0.done()
            for f in [f0] + futs:
                f.result(timeout=30)
    finally:
        srv.stop()
    assert ep.stats.snapshot()["counters"]["batches"] == 2


def test_brownout_sheds_bulk_never_gold():
    net = port_net(weights(9))
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64)
    srv.register(endpoint("t_tier_gold", net, 4))
    srv.register(endpoint("t_tier_bulk", net, 4), tier="bulk")
    with pytest.raises(mt.MXNetError, match="unknown tenant tier"):
        srv.register(endpoint("t_tier_bad", net, 4), tier="platinum")
    srv.start()
    x = rows(onp.random.RandomState(10), 1)
    try:
        tg.BROWNOUT.level = 2
        with pytest.raises(ServerOverloadError, match="brownout"):
            srv.predict("t_tier_bulk", x, timeout=30)
        assert srv.predict("t_tier_gold", x, timeout=30) is not None
    finally:
        tg.BROWNOUT.reset()
        srv.stop()
