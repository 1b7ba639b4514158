"""The port's tail guard (mxnet_tpu_torch.serving.tailguard), its retry
budget in RetryPolicy.run(budget_tier=) and the SLO monitor
(mxnet_tpu_torch.telemetry.slo), held against the JAX package's: pure host
logic, so each is driven through one seeded call sequence in both packages
(a fake clock where time matters) and the states are compared exactly at
every step."""
import random
from contextlib import contextmanager

import pytest

from mxnet_tpu import config as jcfg
from mxnet_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from mxnet_tpu.resilience import retry as jretry
from mxnet_tpu.resilience.watchdog import CircuitBreaker as JaxBreaker
from mxnet_tpu.serving import errors as jerrors
from mxnet_tpu.serving import tailguard as jtg
from mxnet_tpu.telemetry import slo as jslo

from mxnet_tpu_torch import config as pcfg
from mxnet_tpu_torch.resilience import retry as pretry
from mxnet_tpu_torch.resilience.retry import RetryPolicy
from mxnet_tpu_torch.resilience.watchdog import CircuitBreaker
from mxnet_tpu_torch.serving import errors, tailguard as tg
from mxnet_tpu_torch.telemetry import slo


@contextmanager
def knobs(**vals):
    """Set the same flags in both packages; restore after."""
    saved = [(c, k, c.get(k)) for c in (jcfg, pcfg) for k in vals]
    try:
        for c in (jcfg, pcfg):
            for k, v in vals.items():
                c.set(k, v)
        yield
    finally:
        for c, k, v in saved:
            c.set(k, v)


class Clock:
    def __init__(self, t=1_000_000):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------
def test_deadline_taxonomy():
    assert issubclass(errors.DeadlineExceeded, errors.ServingError)
    assert issubclass(errors.RequestTimeoutError, errors.DeadlineExceeded)
    assert issubclass(errors.HotSwapError, errors.ServingError)
    for name in jerrors.__all__:
        assert hasattr(errors, name), name


def test_deadline_steps_equal_the_reference():
    rng = random.Random(3)
    for _ in range(50):
        born = rng.randrange(10 ** 9)
        budget = rng.uniform(0.0, 500.0)
        a, b = jtg.Deadline(budget, now_us=born), tg.Deadline(budget, now_us=born)
        assert a.deadline_us == b.deadline_us
        for _ in range(5):
            now = born + rng.randrange(-1000, 600_000)
            assert a.remaining_us(now) == b.remaining_us(now)
            assert a.remaining_ms(now) == b.remaining_ms(now)
            assert a.expired(now) == b.expired(now)
        at = born + rng.randrange(10 ** 6)
        assert jtg.Deadline.at(at).deadline_us == tg.Deadline.at(at).deadline_us


def test_spent_deadline_raises_and_counts():
    d = tg.Deadline(0.0, now_us=0)
    before = tg.deadline_exceeded_total.get("t_site", 0)
    with pytest.raises(errors.DeadlineExceeded, match="t_site"):
        d.check("t_site")
    assert tg.deadline_exceeded_total["t_site"] == before + 1
    tg.Deadline(60_000.0).check("t_ok")
    tg.deadline_expired("t_counted", n=3)
    assert tg.deadline_exceeded_total["t_counted"] >= 3


# ---------------------------------------------------------------------------
# token buckets, retry budgets, hedging
# ---------------------------------------------------------------------------
def test_token_bucket_sequence_equals_the_reference():
    rng = random.Random(5)
    a, b = jtg.TokenBucket(2.0, 7.5), tg.TokenBucket(2.0, 7.5)
    for _ in range(300):
        if rng.random() < 0.5:
            amt = rng.uniform(0, 3)
            a.deposit(amt)
            b.deposit(amt)
        else:
            amt = rng.choice([1.0, 0.5, 2.0])
            assert a.take(amt) == b.take(amt)
        assert a.balance() == b.balance()


@pytest.mark.parametrize("ratio,lo,cap", [(0.1, 3.0, 6.0), (1.0, 2.0, 3.0),
                                          (0.0, 1.0, 1.0)])
def test_retry_budgets_sequence_equals_the_reference(ratio, lo, cap):
    rng = random.Random(7)
    a, b = jtg.RetryBudgets(), tg.RetryBudgets()
    with knobs(MXNET_RETRY_BUDGET_RATIO=ratio, MXNET_RETRY_BUDGET_MIN=lo,
               MXNET_RETRY_BUDGET_CAP=cap):
        for _ in range(400):
            tier = rng.choice(["execute", "decode", "frontdoor"])
            if rng.random() < 0.4:
                units = rng.choice([1.0, 2.0, 0.5])
                a.on_work(tier, units)
                b.on_work(tier, units)
            else:
                assert a.allow(tier) == b.allow(tier)
            if ratio > 0:
                assert a.balance(tier) == b.balance(tier)


def test_hedge_policy_sequence_equals_the_reference():
    rng = random.Random(11)
    a, b = jtg.HedgePolicy(), tg.HedgePolicy()
    with knobs(MXNET_HEDGE_DELAY_FACTOR=2.0, MXNET_HEDGE_DELAY_MIN_MS=10.0):
        for _ in range(600):        # wraps the 256-entry ring twice
            us = rng.expovariate(1 / 20_000.0)
            a.observe_latency(us)
            b.observe_latency(us)
            pred = rng.choice([0.0, 1_000.0, 30_000.0])
            assert a.p95_us() == b.p95_us()
            assert a.delay_s(pred) == b.delay_s(pred)


def test_hedge_budget_sequence_equals_the_reference():
    rng = random.Random(13)
    jtg.hedge_reset()
    tg.hedge_reset()
    try:
        with knobs(MXNET_HEDGE_BUDGET_RATIO=0.3):
            for _ in range(200):
                if rng.random() < 0.6:
                    jtg.hedge_deposit()
                    tg.hedge_deposit()
                else:
                    assert jtg.hedge_allowed() == tg.hedge_allowed()
                assert jtg._HEDGE_BUCKET.balance() == \
                    tg._HEDGE_BUCKET.balance()
    finally:
        jtg.hedge_reset()
        tg.hedge_reset()


# ---------------------------------------------------------------------------
# brownout
# ---------------------------------------------------------------------------
class BurnStub:
    """The reference test's stand-in for the SLO monitor's burn surface."""
    burn_threshold = 14.0

    def __init__(self):
        self.burning = False

    def check_all(self):
        burn = 99.0 if self.burning else 0.0
        return [{"endpoint": "t_brown", "fast_burn": burn,
                 "slow_burn": burn, "alert_active": self.burning}]


@pytest.mark.parametrize("up,down", [(2, 3), (1, 1), (3, 2)])
def test_brownout_ladder_steps_equal_the_reference(up, down):
    rng = random.Random(up * 10 + down)
    ja, pa = BurnStub(), BurnStub()
    a = jtg.BrownoutController(monitor=ja)
    b = tg.BrownoutController(monitor=pa)
    with knobs(MXNET_BROWNOUT_ENABLE=True, MXNET_BROWNOUT_UP_N=up,
               MXNET_BROWNOUT_DOWN_N=down, MXNET_BROWNOUT_MAX_NEW_TOKENS=8,
               MXNET_BROWNOUT_TIMEOUT_BOOST=4.0):
        burning = False
        for _ in range(200):
            if rng.random() < 0.2:
                burning = not burning
            ja.burning = pa.burning = burning
            assert a.tick() == b.tick()
            assert a.level == b.level
            assert a.snapshot() == b.snapshot()
            for tier in ("gold", "silver", "bulk"):
                assert a.shed_tier(tier) == b.shed_tier(tier)
            n = rng.randrange(1, 100)
            assert a.clamp_max_new_tokens(n) == b.clamp_max_new_tokens(n)
    with knobs(MXNET_BROWNOUT_ENABLE=False):
        a.level = b.level = 3
        for _ in range(5):           # disabled: steps down, then quiet
            assert a.tick() == b.tick()
    a.reset()
    b.reset()
    assert b.level == 0 and b.snapshot()["shedding"] == []


# ---------------------------------------------------------------------------
# RetryPolicy: deadline clamp and budget tier, on a shared fake clock
# ---------------------------------------------------------------------------
def _drive_retry(cls, seq, deadline_us, tier, clock):
    """Run ``cls(...).run`` over a scripted failure sequence with a fake
    sleep that advances ``clock``; returns (result or error, sleeps, calls)."""
    calls = {"n": 0}
    slept = []

    def fn():
        i = calls["n"]
        calls["n"] += 1
        if i < len(seq) and seq[i]:
            raise RuntimeError(f"UNAVAILABLE: scripted #{i}")
        return "served"

    def sleep(s):
        slept.append(s)
        clock.t += int(s * 1e6)

    pol = cls(max_attempts=6, base_ms=20.0, max_ms=400.0, multiplier=2.0,
              jitter=0.25, seed=17, sleep=sleep)
    try:
        out = pol.run(fn, site="t_seq", deadline_us=deadline_us,
                      budget_tier=tier)
    except Exception as e:
        out = (type(e).__name__, type(e.__cause__).__name__)
    return out, slept, calls["n"]


def test_retry_policy_steps_equal_the_reference(monkeypatch):
    rng = random.Random(19)
    jclock, pclock = Clock(), Clock()
    monkeypatch.setattr(jretry, "_now_us", jclock)
    monkeypatch.setattr(pretry, "_now_us", pclock)
    for trial in range(40):
        seq = [rng.random() < 0.7 for _ in range(8)]
        start = rng.randrange(10 ** 6, 10 ** 7)
        jclock.t = pclock.t = start
        deadline = None if trial % 3 == 0 else \
            start + rng.randrange(0, 300_000)
        tier = None if trial % 2 else f"t_tier{trial % 4}"
        with knobs(MXNET_RETRY_BUDGET_RATIO=0.5, MXNET_RETRY_BUDGET_MIN=2.0,
                   MXNET_RETRY_BUDGET_CAP=3.0):
            if trial % 8 == 0:
                jtg.RETRY_BUDGETS.reset()
                tg.RETRY_BUDGETS.reset()
            want = _drive_retry(JaxRetryPolicy, seq, deadline, tier, jclock)
            got = _drive_retry(RetryPolicy, seq, deadline, tier, pclock)
        assert got == want, trial
        assert jclock.t == pclock.t
    jtg.RETRY_BUDGETS.reset()
    tg.RETRY_BUDGETS.reset()


def test_budget_gate_propagates_the_original_error():
    with knobs(MXNET_RETRY_BUDGET_RATIO=0.001, MXNET_RETRY_BUDGET_MIN=1.0,
               MXNET_RETRY_BUDGET_CAP=1.0):
        tg.RETRY_BUDGETS.reset()
        calls = {"n": 0}

        def always_down():
            calls["n"] += 1
            raise RuntimeError("UNAVAILABLE: storm")

        pol = RetryPolicy(max_attempts=10, base_ms=0.1, max_ms=0.1,
                          jitter=0.0, sleep=lambda s: None)
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            pol.run(always_down, site="t_gate", budget_tier="t_gate_tier")
        assert calls["n"] == 2          # one token: exactly one retry
        assert tg.RETRY_BUDGETS.exhausted("t_gate_tier")
    tg.RETRY_BUDGETS.reset()


# ---------------------------------------------------------------------------
# the SLO monitor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("escalate", [False, True])
def test_slo_monitor_steps_equal_the_reference(escalate):
    rng = random.Random(23 + escalate)
    jc, pc = [1000.0], [1000.0]
    kw = dict(fast_window_s=30.0, slow_window_s=120.0, burn_threshold=5.0,
              min_events=4, escalate=escalate)
    a = jslo.SLOMonitor(time_fn=lambda: jc[0], **kw)
    b = slo.SLOMonitor(time_fn=lambda: pc[0], **kw)
    jbr = {n: JaxBreaker(scope=n, degraded_after=3, open_after=6)
           for n in ("t_a", "t_b")}
    pbr = {n: CircuitBreaker(scope=n, degraded_after=3, open_after=6)
           for n in ("t_a", "t_b")}
    for n, thr, tgt in (("t_a", 50_000.0, 0.9), ("t_b", 10_000.0, 0.99)):
        a.register(n, thr, target=tgt, breaker=jbr[n])
        b.register(n, thr, target=tgt, breaker=pbr[n])
    phase_bad = False
    for step in range(600):
        jc[0] = pc[0] = jc[0] + rng.choice([0.01, 0.2, 1.0, 3.0])
        if step % 60 == 0:
            phase_bad = not phase_bad
        name = rng.choice(["t_a", "t_b", "t_none"])
        lat = rng.uniform(0, 120_000 if phase_bad else 12_000)
        ok = rng.random() > (0.2 if phase_bad else 0.01)
        a.record(name, lat, ok=ok)
        b.record(name, lat, ok=ok)
        if step % 7 == 0:
            assert a.check_all() == b.check_all()
        for n in ("t_a", "t_b"):
            assert a.get(n).alert_active == b.get(n).alert_active
            assert jbr[n].state() == pbr[n].state()
    assert a.snapshot() == b.snapshot()
    assert any(o.alerts for o in b.objectives())
    assert sum(o.good + o.bad for o in b.objectives()) > 0
