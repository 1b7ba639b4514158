"""The port's ServingPool and Autoscaler on the CPU. The decision core
(consecutive-poll hysteresis, cooldown, min/max bounds) is pure host
logic: ``tick(now=...)`` is driven through seeded sequences of a stub SLO
monitor and a stub pool in both packages and the reports are compared
exactly at every step. The real pool: rotation, a drain that drops no
request, submit falling through a closed replica, scale-up, and hedged
responses bitwise the unhedged ones. Small BERT (2 layers, 128 units)."""
import random
import threading
from contextlib import contextmanager

import numpy as onp
import pytest
import torch

from mxnet_tpu import config as jcfg
from mxnet_tpu.serving import Autoscaler as JaxAutoscaler
from mxnet_tpu.serving import tailguard as jtg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as pcfg
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel, params_from_jax
from mxnet_tpu_torch.serving import tailguard as tg

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=128, hidden_size=256, num_heads=4,
             vocab_size=100, max_length=64, dropout=0.0)
SEQ = 16


@contextmanager
def knobs(**vals):
    saved = [(c, k, c.get(k)) for c in (jcfg, pcfg) for k in vals]
    try:
        for c in (jcfg, pcfg):
            for k, v in vals.items():
                c.set(k, v)
        yield
    finally:
        for c, k, v in saved:
            c.set(k, v)


class StubMonitor:
    burn_threshold = 14.0

    def __init__(self):
        self.fast_burn = 0.0
        self.alert = False

    def check_all(self):
        return [{"endpoint": "e", "fast_burn": self.fast_burn,
                 "slow_burn": self.fast_burn, "alert_active": self.alert}]


class StubPool:
    def __init__(self, size=1):
        self._size = size
        self.pressure = 0.0

    def scale_up(self):
        self._size += 1
        return self._size - 1

    def scale_down(self, drain_timeout_s=None):
        if self._size <= 1:
            return None
        self._size -= 1
        return self._size

    def size(self):
        return self._size

    def queue_pressure(self):
        return self.pressure

    def snapshot(self):
        return {"size": self._size}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_equal_the_reference_at_every_step(seed):
    rng = random.Random(seed)
    kw = dict(min_replicas=rng.choice([1, 2]), max_replicas=rng.choice([3, 4]),
              up_n=rng.choice([1, 2, 3]), down_n=rng.choice([2, 3, 5]),
              cooldown_s=rng.choice([0.0, 5.0, 10.0]), queue_high=0.5,
              queue_low=0.05)
    jm, pm = StubMonitor(), StubMonitor()
    jp, pp = StubPool(kw["min_replicas"]), StubPool(kw["min_replicas"])
    a = JaxAutoscaler(jp, monitor=jm, **kw)
    b = serving.Autoscaler(pp, monitor=pm, **kw)
    jtg.BROWNOUT.reset()
    tg.BROWNOUT.reset()
    now, acted = 0.0, 0
    try:
        for _ in range(300):
            now += rng.choice([0.5, 1.0, 2.0, 7.0])
            mode = rng.random()
            alert = mode < 0.1
            burn = rng.choice([0.0, 0.5, 3.0, 20.0]) if mode < 0.5 else 0.0
            pressure = rng.choice([0.0, 0.01, 0.2, 0.6, 0.95])
            jm.alert = pm.alert = alert
            jm.fast_burn = pm.fast_burn = burn
            jp.pressure = pp.pressure = pressure
            ra, rb = a.tick(now=now), b.tick(now=now)
            assert ra == rb
            acted += rb is not None
            assert jp.size() == pp.size()
            assert (a._over_polls, a._idle_polls, a._last_action_ts) == \
                (b._over_polls, b._idle_polls, b._last_action_ts)
            assert jtg.BROWNOUT.level == tg.BROWNOUT.level
    finally:
        jtg.BROWNOUT.reset()
        tg.BROWNOUT.reset()
    assert acted >= 3 and a.actions == b.actions


def test_cooldown_and_bounds():
    pool, mon = StubPool(), StubMonitor()
    a = serving.Autoscaler(pool, monitor=mon, min_replicas=1, max_replicas=3,
                           up_n=2, down_n=3, cooldown_s=10.0)
    mon.alert = True
    a.tick(now=0.0)
    assert a.tick(now=1.0)["action"] == "up"
    for t in (2.0, 5.0, 9.0):
        assert a.tick(now=t) is None
    assert a.tick(now=12.0)["action"] == "up" and pool.size() == 3
    assert a.tick(now=30.0) is None and a.tick(now=31.0) is None   # at max
    snap = a.snapshot()
    assert snap["max_replicas"] == 3 and len(snap["actions"]) == 2
    tg.BROWNOUT.reset()


# ---------------------------------------------------------------------------
# the real pool
# ---------------------------------------------------------------------------
def weights(seed=11):
    rng = onp.random.RandomState(seed)
    named = {}
    for k, p in BERTModel(**SMALL)._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        named[k] = a + 1.0 if k.endswith("gamma") else a
    return named


def rows(seed, n):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab_size"], (n, SEQ)).astype(onp.int32),
            rng.randint(0, 2, (n, SEQ)).astype(onp.int32))


def one(x, i):
    return tuple(a[i] for a in x)


@pytest.fixture
def pool():
    """A two-replica pool over one client-facing endpoint name, each
    replica its own copy of the same weights."""
    named = weights()
    nets = {}

    def factory(rid):
        net = BERTModel(**SMALL)
        net.load_state_dict(params_from_jax(named))
        nets[rid] = net.eval()
        srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64,
                                      pipeline=True)
        srv.register(serving.ModelEndpoint(
            "t_pool_ep", net, [(SEQ,), (SEQ,)], dtype="int32",
            max_batch_size=4, ctx=mt.cpu()))
        return srv

    p = serving.ServingPool(factory, initial_replicas=2)
    try:
        yield p, nets
    finally:
        p.stop(drain=True)


def _alone(p, x):
    """The response of one replica serving the request alone (bucket 1)."""
    return p.predict("t_pool_ep", x, timeout=60)


def test_pool_serves_from_rotation(pool):
    p, nets = pool
    assert p.size() == 2
    xs = rows(1, 8)
    outs = [_alone(p, one(xs, i)) for i in range(8)]
    with torch.inference_mode():
        for i, o in enumerate(outs):
            want = nets[0](*(torch.from_numpy(a[i:i + 1]) for a in xs))
            assert all(torch.equal(g[None], w) for g, w in zip(o, want))


def test_scale_down_drains_without_dropping(pool):
    p, _ = pool
    xs = rows(2, 16)
    stop = threading.Event()
    errors, served = [], [0]

    def client():
        i = 0
        while not stop.is_set():
            try:
                p.predict("t_pool_ep", one(xs, i % 16), timeout=60)
                served[0] += 1
            except Exception as e:          # asserted empty below
                errors.append(repr(e))
            i += 1

    t = threading.Thread(target=client)
    t.start()
    try:
        assert p.scale_down() is not None and p.size() == 1
        assert p.scale_down() is None, "the last replica never drains"
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
    assert not errors and served[0] > 0


def test_submit_falls_through_a_closed_replica(pool):
    p, nets = pool
    p._rotation()[0].server.stop(drain=True)
    x = one(rows(3, 1), 0)
    out = p.predict("t_pool_ep", x, timeout=60)
    with torch.inference_mode():
        want = nets[1](*(torch.from_numpy(a[None]) for a in x))
    assert all(torch.equal(g[None], w) for g, w in zip(out, want))


def test_scale_up_adds_a_live_replica(pool):
    p, _ = pool
    rid = p.scale_up()
    snap = p.snapshot()
    assert snap["size"] == 3 and rid in {r["rid"] for r in snap["replicas"]}
    assert all(r["state"] == "running" for r in snap["replicas"])
    assert 0.0 <= snap["queue_pressure"] <= 1.0


def test_hedged_responses_bitwise_the_unhedged(pool):
    """Zero hedge delay and a unit budget: every submit hedges at once, the
    worst case for the first-response-wins race. Both replicas hold the
    same weights and run one request a batch, so each response is bitwise
    the unhedged response of one replica."""
    p, _ = pool
    xs = rows(4, 12)
    unhedged = [_alone(p, one(xs, i)) for i in range(12)]
    with knobs(MXNET_HEDGE_ENABLE=True, MXNET_HEDGE_BUDGET_RATIO=1.0,
               MXNET_HEDGE_DELAY_MIN_MS=0.0, MXNET_HEDGE_DELAY_FACTOR=0.0):
        tg.hedge_reset()
        before = dict(tg.hedge_counts)
        hedged = []
        try:
            for i in range(12):
                tg.HEDGER.reset()       # the delay stays 0 (empty ring)
                hedged.append(p.submit("t_pool_ep", one(xs, i))
                              .result(timeout=60))
        finally:
            tg.hedge_reset()
    delta = {k: tg.hedge_counts[k] - before[k] for k in before}
    for a, b in zip(hedged, unhedged):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert delta["requests"] >= 1
    assert delta["cancelled"] + delta["wasted"] <= delta["requests"]
    assert delta["wins"] <= delta["requests"]
