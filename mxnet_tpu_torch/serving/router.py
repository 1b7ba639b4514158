"""Router: SLO-aware batch selection across the endpoints of one server
(the port of ``mxnet_tpu/serving/router.py``).

The InferenceServer multiplexes N ``ModelEndpoint`` tenants over one
device-owning dispatch path; the Router decides whose batch runs next,
earliest-deadline-first priced by each bucket's measured step cost:

1. A tenant's head request has an *effective deadline*: its explicit
   deadline when set, else ``enqueue + slo_ms`` (the tenant's SLO), else
   ``enqueue + batch_timeout`` (widened by the brownout boost).
2. Its *slack* is ``deadline - now - est_step``, ``est_step`` the EWMA of
   the bucket this batch would run in.
3. Among tenants whose head is still meetable (slack >= 0) the smallest
   slack wins. When only late tenants remain, the cheapest estimated step
   runs first (shortest job first), so a long late batch does not convoy
   short ones.
4. A late tenant whose head has waited more than ``starvation_factor x
   (batch_timeout + est_step)`` is escalated and served oldest first.

Selection happens at the last moment (the prep stage, or the serial
worker, assembles after the previous batch is already running), so rows
arriving during step k join batch k+1: continuous batching.

The Router owns no lock: every call happens under the server's condition,
like the EndpointQueues it reads. :class:`StepCostEWMA` locks itself: it is
fed from the worker outside the server lock.

The reference's learned cost-model prior for cold buckets (its
``costmodel`` reads StableHLO) is not ported: a bucket never observed is
priced by the nearest observed one, scaled by the row ratio. A named
estimator exports each bucket's estimate as ``mxtpu_step_cost_est_us``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .. import telemetry as _telemetry
from . import bucketing, tailguard as _tailguard
from .batcher import EndpointQueue

__all__ = ["StepCostEWMA", "Tenant", "Router"]

_EST_G = _telemetry.gauge(
    "mxtpu_step_cost_est_us",
    "Live per-(endpoint, bucket) step-cost estimate: the cost-model prior "
    "while a bucket is cold, the measured EWMA once observed.",
    labelnames=("endpoint", "bucket"))


class StepCostEWMA:
    """Per-bucket exponentially-weighted moving average of step time (us).

    ``observe(bucket, us)`` is fed by every executed step (and by warm-up's
    one run per bucket, so estimates exist before the first request).
    ``estimate(bucket)`` falls back to the nearest observed bucket scaled by
    the row ratio (0.0 on an empty table) until the bucket itself has been
    observed once. ``name`` labels the ``mxtpu_step_cost_est_us`` gauge;
    anonymous instances export nothing."""

    def __init__(self, alpha: float = 0.25, name: Optional[str] = None):
        self.alpha = float(alpha)
        self.name = name
        self._lock = threading.Lock()
        self._est: Dict[int, float] = {}

    def observe(self, bucket: int, step_us: float):
        with self._lock:
            prev = self._est.get(bucket)
            est = self._est[bucket] = step_us if prev is None else \
                prev + self.alpha * (step_us - prev)
        if self.name is not None:
            _EST_G.labels(self.name, str(bucket)).set(est)

    def estimate(self, bucket: int) -> float:
        with self._lock:
            got = self._est.get(bucket)
            if got is not None:
                return got
            if not self._est:
                return 0.0
            nearest = min(self._est, key=lambda b: abs(b - bucket))
            return self._est[nearest] * (bucket / nearest)

    def snapshot(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._est)


class Tenant:
    """One endpoint's seat at the scheduler: its queue, its circuit breaker
    (this tenant's overload tightens this tenant's admission only), its
    optional SLO (``slo_us``: the scheduling deadline default and the
    latency objective the SLO monitor burns against ``slo_target``) and
    its brownout ``tier`` (gold / silver / bulk)."""

    __slots__ = ("name", "endpoint", "queue", "breaker", "slo_us",
                 "slo_target", "tier")

    def __init__(self, name: str, endpoint, queue: EndpointQueue,
                 breaker, slo_us: Optional[int] = None,
                 slo_target: Optional[float] = None, tier: str = "gold"):
        self.name = name
        self.endpoint = endpoint
        self.queue = queue
        self.breaker = breaker
        self.slo_us = slo_us
        self.slo_target = slo_target
        self.tier = tier


class Router:
    """EDF-with-measured-step-cost selection across registered tenants;
    every method is called with the server's condition lock held."""

    def __init__(self, batch_timeout_us: int, starvation_factor: float = 8.0):
        self.batch_timeout_us = int(batch_timeout_us)
        self.starvation_factor = float(starvation_factor)
        self._tenants: Dict[str, Tenant] = {}

    # -- registry -----------------------------------------------------------
    def add(self, tenant: Tenant):
        self._tenants[tenant.name] = tenant

    def get(self, name: str) -> Tenant:
        return self._tenants[name]

    def find(self, name: str) -> Optional[Tenant]:
        return self._tenants.get(name)

    def names(self) -> List[str]:
        return sorted(self._tenants)

    def tenants(self) -> List[Tenant]:
        return list(self._tenants.values())

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    # -- scheduling inputs --------------------------------------------------
    def effective_batch_timeout_us(self) -> float:
        """The batching deadline in force: the configured timeout widened
        by the brownout ladder."""
        return self.batch_timeout_us * _tailguard.BROWNOUT.timeout_boost()

    def est_step_us(self, tenant: Tenant) -> float:
        """Estimated step time of the batch this tenant would run next:
        the EWMA of the bucket its pending rows land in."""
        ep = tenant.endpoint
        rows = min(max(tenant.queue.pending_rows, 1), ep.max_batch_size)
        return ep.step_cost.estimate(bucketing.bucket_for(rows, ep.buckets))

    def effective_deadline_us(self, tenant: Tenant) -> int:
        """Head request's deadline, or enqueue + SLO, or the batch
        deadline."""
        head_dl = tenant.queue.head_deadline_us()
        if head_dl is not None:
            return head_dl
        budget = tenant.slo_us if tenant.slo_us \
            else self.effective_batch_timeout_us()
        return int(tenant.queue.head_enqueue_us() + budget)

    def slack_us(self, tenant: Tenant, now_us: int) -> float:
        return self.effective_deadline_us(tenant) - now_us - \
            self.est_step_us(tenant)

    def _starvation_us(self, tenant: Tenant) -> float:
        return self.starvation_factor * \
            (self.effective_batch_timeout_us() + self.est_step_us(tenant))

    # -- the decision -------------------------------------------------------
    def select(self, now_us: int, flush: bool = False) -> Optional[Tenant]:
        """The next tenant to assemble a batch for, or None when no queue
        is ready (the policy is the module docstring's)."""
        ready = [t for t in self._tenants.values()
                 if t.queue.ready(now_us, flush)]
        if not ready:
            return None
        if len(ready) == 1:
            return ready[0]
        meetable: List[Tuple[float, Tenant]] = []
        late: List[Tenant] = []
        for t in ready:
            s = self.slack_us(t, now_us)
            if s >= 0:
                meetable.append((s, t))
            else:
                late.append(t)
        if meetable:
            return min(meetable, key=lambda st: st[0])[1]
        starving = [t for t in late
                    if now_us - t.queue.head_enqueue_us() >
                    self._starvation_us(t)]
        if starving:
            return min(starving, key=lambda t: t.queue.head_enqueue_us())
        return min(late, key=self.est_step_us)

    # -- bookkeeping for the dispatch loops ---------------------------------
    def next_wakeup_us(self) -> Optional[int]:
        wakeups = [w for t in self._tenants.values()
                   for w in (t.queue.next_wakeup_us(),) if w is not None]
        return min(wakeups) if wakeups else None

    def fail_all(self, exc: Exception) -> int:
        """Fail every queued request; returns how many."""
        return sum(t.queue.fail_all(exc) for t in self._tenants.values())
