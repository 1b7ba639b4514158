"""Tail-tolerance layer: deadlines, hedges, retry budgets, brownout (the
port of ``mxnet_tpu/serving/tailguard.py``).

**Deadline propagation.** A :class:`Deadline` is minted once at ingress
and the same object rides every hop (pool submit, endpoint queue, batch
assembly, the per-batch retry, each decode token); each tier reads the one
budget and fails fast with :class:`~.errors.DeadlineExceeded` once it is
spent.

**Hedged requests.** :class:`HedgePolicy` says when a pending request is
late enough to duplicate onto the next replica: after the larger of the
observed p95 pool latency and the predicted step cost times
``MXNET_HEDGE_DELAY_FACTOR``, floored at ``MXNET_HEDGE_DELAY_MIN_MS``.
Hedges draw from a token bucket that earns ``MXNET_HEDGE_BUDGET_RATIO`` a
primary submit, so speculation cannot amplify an overload; the first
response wins and the loser is cancelled at batch assembly.

**Retry budgets.** Per-tier token buckets (``execute`` device-step
retries, ``decode`` failover requeues, ``frontdoor``) gate every retry
through :func:`retry_allowed`; each unit of real work deposits
``MXNET_RETRY_BUDGET_RATIO`` (buckets start at ``MXNET_RETRY_BUDGET_MIN``,
capped at ``MXNET_RETRY_BUDGET_CAP``). A retry storm drains the bucket and
further retries are refused: bounded shed instead of amplification.

**Brownout ladder.** :class:`BrownoutController` reads the SLO monitor's
burn state and degrades in criticality order, with hysteresis
(``MXNET_BROWNOUT_UP_N`` burning ticks down, ``MXNET_BROWNOUT_DOWN_N``
calm ticks back up): level 1 widens batch timeouts by
``MXNET_BROWNOUT_TIMEOUT_BOOST`` and clamps decode ``max_new_tokens`` to
``MXNET_BROWNOUT_MAX_NEW_TOKENS``; level 2 refuses ``tier="bulk"`` tenants
at admission; level 3 refuses silver too. Gold is never refused.

The knobs are registered in the port's ``config.py``. Every count is a
reference family (``mxtpu_deadline_exceeded_total``, ``mxtpu_hedge_*``,
``mxtpu_retry_budget_*``, ``mxtpu_brownout_*``); the module's tables read
them: :data:`deadline_exceeded_total` (by site), :data:`hedge_counts`
(requests, wins, cancelled, wasted, budget_exhausted),
:data:`retry_budget_exhausted_total` (by tier),
:data:`brownout_transitions_total` (by direction) and
:data:`brownout_shed_total` (by tier). The gauges are each tier's
``mxtpu_retry_budget_tokens`` and ``mxtpu_brownout_level``. The first
refusal of a dry retry budget or hedge bucket fires its flight trigger
(``retry_budget_exhausted``, ``hedge_budget_exhausted``: one a dry
episode), and every brownout level change the ``brownout_shift`` trigger
and event.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .. import config as _config
from .. import telemetry as _telemetry
from ..telemetry import flight as _flight
from ..telemetry.metrics import CountView
from .errors import DeadlineExceeded

__all__ = ["Deadline", "DeadlineExceeded", "TokenBucket", "RetryBudgets",
           "RETRY_BUDGETS", "retry_allowed", "retry_deposit", "HedgePolicy",
           "HEDGER", "BrownoutController", "BROWNOUT", "TIER_RANKS",
           "deadline_expired"]


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


_DEADLINE_C = _telemetry.counter(
    "mxtpu_deadline_exceeded_total",
    "Requests failed fast because their propagated Deadline budget ran out, "
    "by the site that detected it (ingress/pool_submit/queue/assembly/"
    "retry_backoff/decode_token) — the earliest tier that could know, so "
    "expired work stops consuming capacity immediately.",
    labelnames=("site",))
_HEDGES_C = _telemetry.counter(
    "mxtpu_hedge_requests_total",
    "Hedge duplicates launched onto a second replica after the adaptive "
    "delay (the speculation volume; bounded by the hedge token bucket).")
_HEDGE_WINS_C = _telemetry.counter(
    "mxtpu_hedge_wins_total",
    "Hedged requests where the duplicate finished first — tail latency the "
    "hedge actually saved.")
_HEDGE_CANCELLED_C = _telemetry.counter(
    "mxtpu_hedge_cancelled_total",
    "Hedge losers cancelled before occupying device rows (dropped at batch "
    "assembly) — speculation that cost zero device work.")
_HEDGE_WASTED_C = _telemetry.counter(
    "mxtpu_hedge_wasted_total",
    "Hedge losers that had already entered a device batch when the winner "
    "resolved — the duplicate work hedging truly wasted.")
_HEDGE_EXHAUSTED_C = _telemetry.counter(
    "mxtpu_hedge_budget_exhausted_total",
    "Hedges skipped because the hedge token bucket was dry — speculation "
    "refusing to amplify an overload.")
_RETRY_TOKENS_G = _telemetry.gauge(
    "mxtpu_retry_budget_tokens",
    "Live token balance of each tier's retry budget bucket (frontdoor / "
    "execute / decode); zero means further retries are refused until real "
    "work deposits more.",
    labelnames=("tier",))
_RETRY_EXHAUSTED_C = _telemetry.counter(
    "mxtpu_retry_budget_exhausted_total",
    "Retries refused because the tier's budget bucket was dry — a retry "
    "storm converting into bounded shed instead of amplification.",
    labelnames=("tier",))
_BROWNOUT_LEVEL_G = _telemetry.gauge(
    "mxtpu_brownout_level",
    "Current brownout ladder level: 0 normal, 1 soften (timeout boost + "
    "decode clamp), 2 shed bulk, 3 shed bulk+silver (gold always serves).")
_BROWNOUT_TRANSITIONS_C = _telemetry.counter(
    "mxtpu_brownout_transitions_total",
    "Brownout ladder level changes, by direction (degrade / recover); one "
    "brownout_shift flight event accompanies each.",
    labelnames=("direction",))
_BROWNOUT_SHED_C = _telemetry.counter(
    "mxtpu_brownout_shed_total",
    "Requests refused at admission by the brownout ladder, by tenant tier "
    "(gold is never in this count by construction).",
    labelnames=("tier",))

#: requests failed fast because their Deadline ran out, by detecting site
deadline_exceeded_total = CountView(_DEADLINE_C)
#: hedge duplicates launched / won / cancelled before a batch / wasted
#: inside one / skipped for a dry budget
hedge_counts = CountView({"requests": _HEDGES_C, "wins": _HEDGE_WINS_C,
                          "cancelled": _HEDGE_CANCELLED_C,
                          "wasted": _HEDGE_WASTED_C,
                          "budget_exhausted": _HEDGE_EXHAUSTED_C})
#: retries refused because the tier's bucket was dry, by tier
retry_budget_exhausted_total = CountView(_RETRY_EXHAUSTED_C)
#: brownout level changes, by direction (degrade / recover)
brownout_transitions_total = CountView(_BROWNOUT_TRANSITIONS_C)
#: requests refused at admission by the brownout ladder, by tenant tier
brownout_shed_total = CountView(_BROWNOUT_SHED_C)


# ---------------------------------------------------------------------------
# deadline propagation
# ---------------------------------------------------------------------------
class Deadline:
    """One end-to-end latency budget, minted at ingress and passed by
    reference through every tier: an absolute expiry on the
    ``perf_counter_ns() // 1000`` microsecond clock every serving tier
    stamps with. ``check(site)`` raises :class:`DeadlineExceeded` (and
    counts the site) once the budget is spent."""

    __slots__ = ("deadline_us", "born_us")

    def __init__(self, budget_ms: float, now_us: Optional[int] = None):
        self.born_us = _now_us() if now_us is None else int(now_us)
        self.deadline_us = self.born_us + int(float(budget_ms) * 1000.0)

    @classmethod
    def at(cls, deadline_us: int) -> "Deadline":
        """Adopt an absolute expiry already on the shared clock."""
        d = cls.__new__(cls)
        d.born_us = _now_us()
        d.deadline_us = int(deadline_us)
        return d

    def remaining_us(self, now_us: Optional[int] = None) -> int:
        now = _now_us() if now_us is None else now_us
        return self.deadline_us - now

    def remaining_ms(self, now_us: Optional[int] = None) -> float:
        return self.remaining_us(now_us) / 1e3

    def expired(self, now_us: Optional[int] = None) -> bool:
        return self.remaining_us(now_us) <= 0

    def check(self, site: str):
        """Fail fast: raise DeadlineExceeded when the budget is gone."""
        rem = self.remaining_us()
        if rem <= 0:
            _DEADLINE_C.labels(site).inc()
            raise DeadlineExceeded(
                f"deadline exceeded at {site}: budget of "
                f"{(self.deadline_us - self.born_us) / 1e3:.1f} ms overran "
                f"by {-rem / 1e3:.1f} ms")

    def __repr__(self):
        return (f"Deadline(remaining_ms={self.remaining_ms():.1f}, "
                f"deadline_us={self.deadline_us})")


def deadline_expired(site: str, n: int = 1):
    """Count expiries found without a Deadline in hand (the batcher
    dropping expired heads at assembly)."""
    _DEADLINE_C.labels(site).inc(n)


# ---------------------------------------------------------------------------
# token buckets (hedge budget + per-tier retry budgets)
# ---------------------------------------------------------------------------
class TokenBucket:
    """A capped token bucket: ``deposit()`` is driven by units of real
    work, ``take()`` spends a token per speculative or retried unit. No
    time-based refill: an idle system banks nothing."""

    __slots__ = ("_lock", "tokens", "cap")

    def __init__(self, initial: float, cap: float):
        self._lock = threading.Lock()
        self.cap = float(cap)
        self.tokens = min(float(initial), self.cap)

    def deposit(self, amount: float):
        with self._lock:
            self.tokens = min(self.tokens + float(amount), self.cap)

    def take(self, amount: float = 1.0) -> bool:
        with self._lock:
            if self.tokens >= amount:
                self.tokens -= amount
                return True
            return False

    def balance(self) -> float:
        with self._lock:
            return self.tokens


class RetryBudgets:
    """Per-tier retry token buckets, created on first use at
    ``MXNET_RETRY_BUDGET_MIN`` tokens and capped at
    ``MXNET_RETRY_BUDGET_CAP``; ``on_work`` deposits
    ``MXNET_RETRY_BUDGET_RATIO`` a unit. A ratio <= 0 disables budgeting
    (every ``allow`` succeeds). ``exhausted(tier)`` is latched from a
    refusal until the next granted retry (the reference's one flight
    trigger per episode)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self._latched: Dict[str, bool] = {}

    @staticmethod
    def _ratio() -> float:
        return float(_config.get("MXNET_RETRY_BUDGET_RATIO"))

    def _bucket(self, tier: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tier)
            if b is None:
                b = TokenBucket(float(_config.get("MXNET_RETRY_BUDGET_MIN")),
                                float(_config.get("MXNET_RETRY_BUDGET_CAP")))
                self._buckets[tier] = b
                self._latched[tier] = False
            return b

    def on_work(self, tier: str, units: float = 1.0):
        """Deposit for real work done at ``tier``."""
        if self._ratio() <= 0:
            return
        b = self._bucket(tier)
        b.deposit(self._ratio() * units)
        _RETRY_TOKENS_G.labels(tier).set(b.balance())

    def allow(self, tier: str) -> bool:
        """Spend one token for a retry at ``tier``. False: the budget is
        spent and the caller must not retry (it propagates its error)."""
        if self._ratio() <= 0:
            return True
        b = self._bucket(tier)
        ok = b.take(1.0)
        _RETRY_TOKENS_G.labels(tier).set(b.balance())
        with self._lock:
            first = not ok and not self._latched[tier]
            self._latched[tier] = not ok
        if not ok:
            _RETRY_EXHAUSTED_C.labels(tier).inc()
        if first:
            _flight.trigger("retry_budget_exhausted", tier=tier,
                            tokens=round(b.balance(), 3), cap=b.cap)
        return ok

    def exhausted(self, tier: str) -> bool:
        with self._lock:
            return self._latched.get(tier, False)

    def balance(self, tier: str) -> float:
        return self._bucket(tier).balance()

    def reset(self):
        """Forget every bucket (tests and drills)."""
        with self._lock:
            self._buckets.clear()
            self._latched.clear()


#: the process-wide registry every wired tier consumes
RETRY_BUDGETS = RetryBudgets()


def retry_deposit(tier: str, units: float = 1.0):
    """``RETRY_BUDGETS.on_work``."""
    RETRY_BUDGETS.on_work(tier, units)


def retry_allowed(tier: str) -> bool:
    """``RETRY_BUDGETS.allow``."""
    return RETRY_BUDGETS.allow(tier)


# ---------------------------------------------------------------------------
# hedging policy
# ---------------------------------------------------------------------------
class HedgePolicy:
    """When to duplicate a pending request: after
    ``max(p95 of recent pool latencies, predicted_step_us *
    MXNET_HEDGE_DELAY_FACTOR, MXNET_HEDGE_DELAY_MIN_MS)``."""

    _RING = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._lat_us: list = []       # ring of recent pool latencies
        self._idx = 0

    @staticmethod
    def enabled() -> bool:
        return bool(_config.get("MXNET_HEDGE_ENABLE")) and \
            float(_config.get("MXNET_HEDGE_BUDGET_RATIO")) > 0.0

    def observe_latency(self, us: float):
        """Feed one completed pool submit's end-to-end latency."""
        with self._lock:
            if len(self._lat_us) < self._RING:
                self._lat_us.append(float(us))
            else:
                self._lat_us[self._idx] = float(us)
                self._idx = (self._idx + 1) % self._RING

    def p95_us(self) -> float:
        with self._lock:
            if not self._lat_us:
                return 0.0
            vals = sorted(self._lat_us)
        return vals[min(len(vals) - 1, int(0.95 * len(vals)))]

    def delay_s(self, predicted_step_us: float = 0.0) -> float:
        """The hedge delay for one request, in seconds."""
        factor = float(_config.get("MXNET_HEDGE_DELAY_FACTOR"))
        floor_us = float(_config.get("MXNET_HEDGE_DELAY_MIN_MS")) * 1000.0
        delay_us = max(self.p95_us(), predicted_step_us * factor, floor_us)
        return delay_us / 1e6

    def reset(self):
        with self._lock:
            self._lat_us.clear()
            self._idx = 0


#: the process-wide hedging policy and its budget bucket
HEDGER = HedgePolicy()
_HEDGE_BUCKET = TokenBucket(1.0, 64.0)
_HEDGE_LATCH = threading.Event()


def hedge_deposit():
    """One primary submit's worth of hedge budget income."""
    _HEDGE_BUCKET.deposit(float(_config.get("MXNET_HEDGE_BUDGET_RATIO")))


def hedge_allowed() -> bool:
    """Spend one hedge token; False refuses the hedge (the budget is dry)."""
    if _HEDGE_BUCKET.take(1.0):
        _HEDGE_LATCH.clear()
        return True
    _HEDGE_EXHAUSTED_C.inc()
    if not _HEDGE_LATCH.is_set():
        _HEDGE_LATCH.set()
        _flight.trigger("hedge_budget_exhausted",
                        tokens=round(_HEDGE_BUCKET.balance(), 3))
    return False


def hedge_launched():
    _HEDGES_C.inc()


def hedge_won():
    _HEDGE_WINS_C.inc()


def hedge_cancelled():
    _HEDGE_CANCELLED_C.inc()


def hedge_wasted():
    _HEDGE_WASTED_C.inc()


def hedge_reset():
    """Re-seed the hedge bucket and clear the latency ring (tests and
    drills)."""
    global _HEDGE_BUCKET
    _HEDGE_BUCKET = TokenBucket(1.0, 64.0)
    _HEDGE_LATCH.clear()
    HEDGER.reset()


# ---------------------------------------------------------------------------
# brownout ladder
# ---------------------------------------------------------------------------
#: tenant criticality ranks (lower sheds last): register(tier=...) values
TIER_RANKS = {"gold": 0, "silver": 1, "bulk": 2}

#: brownout level -> lowest tier rank refused at admission (None: nobody)
_SHED_RANK_AT_LEVEL = {0: None, 1: None, 2: 2, 3: 1}

_MAX_LEVEL = 3


class BrownoutController:
    """Degradation ladder over the SLO monitor's burn state.

    ``tick(now)`` reads the monitor (default the process-wide
    ``telemetry.slo.MONITOR``; injectable): *burning* means an objective's
    alert is latched or its fast burn is at or over the monitor's
    threshold. The tiers consume ``shed_tier(tier)`` (admission),
    ``timeout_boost()`` (batch assembly) and ``clamp_max_new_tokens(n)``
    (decode). ``transitions`` keeps each level change's report."""

    def __init__(self, monitor=None):
        self._monitor = monitor
        self._lock = threading.Lock()
        self.level = 0
        self._hot = 0
        self._calm = 0
        self.transitions: list = []

    def _resolve_monitor(self):
        if self._monitor is not None:
            return self._monitor
        from ..telemetry.slo import MONITOR
        return MONITOR

    def set_monitor(self, monitor):
        """Swap the burn-signal source (None: the process-wide monitor)."""
        self._monitor = monitor

    @staticmethod
    def enabled() -> bool:
        return bool(_config.get("MXNET_BROWNOUT_ENABLE"))

    def _burning(self) -> bool:
        mon = self._resolve_monitor()
        thr = float(mon.burn_threshold)
        for st in mon.check_all():
            if st.get("alert_active"):
                return True
            if float(st.get("fast_burn", 0.0)) >= thr:
                return True
        return False

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One control turn: read the burn signal, apply hysteresis, move
        at most one level. Returns the transition report or None."""
        if not self.enabled():
            with self._lock:
                if self.level == 0:
                    return None
                return self._shift_locked(-1, "disabled")
        burning = self._burning()
        up_n = max(1, int(_config.get("MXNET_BROWNOUT_UP_N")))
        down_n = max(1, int(_config.get("MXNET_BROWNOUT_DOWN_N")))
        with self._lock:
            if burning:
                self._hot += 1
                self._calm = 0
                if self._hot >= up_n and self.level < _MAX_LEVEL:
                    self._hot = 0
                    return self._shift_locked(+1, "slo_burn")
            else:
                self._calm += 1
                self._hot = 0
                if self._calm >= down_n and self.level > 0:
                    self._calm = 0
                    return self._shift_locked(-1, "burn_cleared")
        return None

    def _shift_locked(self, direction: int, reason: str) -> dict:
        old = self.level
        self.level = min(max(self.level + direction, 0), _MAX_LEVEL)
        _BROWNOUT_LEVEL_G.set(self.level)
        word = "degrade" if direction > 0 else "recover"
        _BROWNOUT_TRANSITIONS_C.labels(word).inc()
        report = {"from_level": old, "to_level": self.level,
                  "direction": word, "reason": reason,
                  "shedding": self.shedding_tiers()}
        self.transitions.append(report)
        del self.transitions[:-64]
        _flight.trigger("brownout_shift", **report)
        _telemetry.event("brownout_shift", **report)
        return report

    def shed_tier(self, tier: str) -> bool:
        """Refuse a request for a ``tier`` tenant now? Gold never."""
        rank = TIER_RANKS.get(tier, 0)
        shed_from = _SHED_RANK_AT_LEVEL.get(self.level)
        if shed_from is None or rank == 0:
            return False
        if rank >= shed_from:
            _BROWNOUT_SHED_C.labels(tier).inc()
            return True
        return False

    def shedding_tiers(self) -> list:
        shed_from = _SHED_RANK_AT_LEVEL.get(self.level)
        if shed_from is None:
            return []
        return sorted(t for t, r in TIER_RANKS.items()
                      if r >= shed_from and r > 0)

    def timeout_boost(self) -> float:
        """Batch-timeout multiplier (1.0 at level 0)."""
        if self.level >= 1:
            return max(1.0, float(_config.get("MXNET_BROWNOUT_TIMEOUT_BOOST")))
        return 1.0

    def clamp_max_new_tokens(self, requested: int) -> int:
        """Decode generation budget under brownout (identity at level 0)."""
        if self.level >= 1:
            clamp = max(1, int(_config.get("MXNET_BROWNOUT_MAX_NEW_TOKENS")))
            return min(int(requested), clamp)
        return int(requested)

    def snapshot(self) -> dict:
        with self._lock:
            return {"level": self.level, "hot_ticks": self._hot,
                    "calm_ticks": self._calm, "enabled": self.enabled(),
                    "shedding": self.shedding_tiers(),
                    "timeout_boost": self.timeout_boost()}

    def reset(self):
        """Back to level 0 with the hysteresis counters cleared (tests and
        drills); not a transition."""
        with self._lock:
            self.level = 0
            self._hot = 0
            self._calm = 0
            _BROWNOUT_LEVEL_G.set(0)


#: the process-wide ladder: Autoscaler.tick drives it, servers consult it
BROWNOUT = BrownoutController()
