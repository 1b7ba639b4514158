"""Per-tenant SLO objectives with multi-window burn-rate alerting (the port
of ``mxnet_tpu/telemetry/slo.py``).

An *objective* is "the fraction of requests under ``threshold_us`` must be
at least ``target``". The monitor classifies every completed request as
good or bad into per-second buckets and computes each window's **burn
rate**, ``bad_ratio / (1 - target)``, over a fast window (minutes) and a
slow one (an hour). The alert fires only when both burn at or above
``MXNET_SLO_BURN_THRESHOLD`` with at least ``MXNET_SLO_MIN_EVENTS`` in the
fast window, and latches until the fast window drops under the threshold.
With ``MXNET_SLO_ESCALATE`` a firing alert forces the tenant's circuit
breaker to DEGRADED.

Each :class:`Objective` reports into the reference's families
(``mxtpu_slo_good_total``, ``_bad_total``, ``_burn_rate`` by window,
``_alert_active``, ``_alerts_total``, ``_escalations_total``, by endpoint):
its ``good``, ``bad``, ``alerts`` and ``escalations`` are its share of the
counters, ``fast_burn``/``slow_burn`` the gauges; an alert records the
``slo_burn_alert`` flight event and its clearing ``slo_burn_clear``.

Objectives are registered by ``InferenceServer.register(slo_ms=...)``; the
process-wide monitor is :data:`MONITOR`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import config as _config
from . import flight as _flight
from .metrics import REGISTRY, Baseline

__all__ = ["Objective", "SLOMonitor", "MONITOR"]

_GOOD = REGISTRY.counter(
    "mxtpu_slo_good_total",
    "Requests that met their endpoint's latency objective.",
    labelnames=("endpoint",))
_BAD = REGISTRY.counter(
    "mxtpu_slo_bad_total",
    "Requests that missed their endpoint's latency objective (too slow or "
    "failed).",
    labelnames=("endpoint",))
_BURN = REGISTRY.gauge(
    "mxtpu_slo_burn_rate",
    "Error-budget burn rate (bad_ratio / (1 - target)) per window: 1.0 = "
    "budget consumed exactly at the sustainable pace.",
    labelnames=("endpoint", "window"))
_ALERT_ACTIVE = REGISTRY.gauge(
    "mxtpu_slo_alert_active",
    "1 while an endpoint's multi-window burn alert is latched, else 0.",
    labelnames=("endpoint",))
_ALERTS = REGISTRY.counter(
    "mxtpu_slo_alerts_total",
    "Burn-rate alert episodes fired (both windows over threshold).",
    labelnames=("endpoint",))
_ESCALATIONS = REGISTRY.counter(
    "mxtpu_slo_escalations_total",
    "Burn alerts that escalated the offending tenant's breaker to DEGRADED "
    "(MXNET_SLO_ESCALATE).",
    labelnames=("endpoint",))



class Objective:
    """One endpoint's latency objective, its per-second (second, good, bad)
    buckets (oldest first) and its counters."""

    __slots__ = ("name", "threshold_us", "target", "breaker", "buckets",
                 "alert_active", "_good", "_bad", "_burn_fast", "_burn_slow",
                 "_active_g", "_alerts", "_escalations", "_own")

    def __init__(self, name: str, threshold_us: float, target: float,
                 breaker=None):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.name = name
        self.threshold_us = float(threshold_us)
        self.target = float(target)
        self.breaker = breaker
        self.buckets: deque = deque()
        self.alert_active = False
        self._good = _GOOD.labels(name)
        self._bad = _BAD.labels(name)
        self._burn_fast = _BURN.labels(name, "fast")
        self._burn_slow = _BURN.labels(name, "slow")
        self._active_g = _ALERT_ACTIVE.labels(name)
        self._active_g.set(0)
        self._alerts = _ALERTS.labels(name)
        self._escalations = _ESCALATIONS.labels(name)
        self._own = Baseline({"good": self._good, "bad": self._bad,
                              "alerts": self._alerts,
                              "escalations": self._escalations})

    good = property(lambda self: int(self._own["good"]))
    bad = property(lambda self: int(self._own["bad"]))
    alerts = property(lambda self: int(self._own["alerts"]))
    escalations = property(lambda self: int(self._own["escalations"]))
    fast_burn = property(lambda self: self._burn_fast.value)
    slow_burn = property(lambda self: self._burn_slow.value)

    def window_totals(self, window_s: float, now: float):
        """(good, bad) over the trailing ``window_s`` seconds."""
        lo = now - window_s
        good = bad = 0
        for sec, g, b in reversed(self.buckets):
            if sec < lo:
                break
            good += g
            bad += b
        return good, bad


class SLOMonitor:
    """Burn-rate monitor. The windows, threshold, minimum events and
    escalation read their ``MXNET_SLO_*`` flag at every check unless pinned
    here; ``time_fn`` is the clock (injectable for tests)."""

    def __init__(self, target: Optional[float] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None,
                 min_events: Optional[int] = None,
                 escalate: Optional[bool] = None,
                 time_fn=time.monotonic):
        self._target = target
        self._fast = fast_window_s
        self._slow = slow_window_s
        self._threshold = burn_threshold
        self._min_events = min_events
        self._escalate = escalate
        self._now = time_fn
        self._lock = threading.Lock()
        self._objectives: Dict[str, Objective] = {}

    @property
    def fast_window_s(self) -> float:
        return self._fast if self._fast is not None else \
            float(_config.get("MXNET_SLO_FAST_WINDOW_S"))

    @property
    def slow_window_s(self) -> float:
        return self._slow if self._slow is not None else \
            float(_config.get("MXNET_SLO_SLOW_WINDOW_S"))

    @property
    def burn_threshold(self) -> float:
        return self._threshold if self._threshold is not None else \
            float(_config.get("MXNET_SLO_BURN_THRESHOLD"))

    @property
    def min_events(self) -> int:
        return self._min_events if self._min_events is not None else \
            int(_config.get("MXNET_SLO_MIN_EVENTS"))

    @property
    def escalate(self) -> bool:
        return self._escalate if self._escalate is not None else \
            bool(_config.get("MXNET_SLO_ESCALATE"))

    # -- registration -------------------------------------------------------
    def register(self, name: str, threshold_us: float,
                 target: Optional[float] = None, breaker=None) -> Objective:
        """Register (or replace) an endpoint's objective; ``target`` falls
        back to ``MXNET_SLO_TARGET``."""
        if target is None:
            target = self._target if self._target is not None else \
                float(_config.get("MXNET_SLO_TARGET"))
        obj = Objective(name, threshold_us, target, breaker=breaker)
        with self._lock:
            self._objectives[name] = obj
        return obj

    def unregister(self, name: str):
        with self._lock:
            self._objectives.pop(name, None)

    def get(self, name: str) -> Optional[Objective]:
        with self._lock:
            return self._objectives.get(name)

    def objectives(self) -> List[Objective]:
        with self._lock:
            return list(self._objectives.values())

    # -- recording ----------------------------------------------------------
    def record(self, name: str, latency_us: float, ok: bool = True):
        """Classify one completed request (a no-op for an endpoint without
        an objective) and run the burn check of its objective."""
        obj = self.get(name)
        if obj is None:
            return
        good = bool(ok) and latency_us <= obj.threshold_us
        now = self._now()
        sec = int(now)
        with self._lock:
            if obj.buckets and obj.buckets[-1][0] == sec:
                s, g, b = obj.buckets[-1]
                obj.buckets[-1] = (s, g + good, b + (not good))
            else:
                obj.buckets.append((sec, int(good), int(not good)))
                lo = now - self.slow_window_s - 1
                while obj.buckets and obj.buckets[0][0] < lo:
                    obj.buckets.popleft()
        (obj._good if good else obj._bad).inc()
        self.check(obj, now)

    # -- burn check / alerting ----------------------------------------------
    @staticmethod
    def _burn(good: int, bad: int, target: float) -> float:
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / (1.0 - target)

    def check(self, obj: Objective, now: Optional[float] = None) -> dict:
        """Recompute both windows' burn rates and fire or clear the latched
        alert; returns the state."""
        if now is None:
            now = self._now()
        with self._lock:
            fg, fb = obj.window_totals(self.fast_window_s, now)
            sg, sb = obj.window_totals(self.slow_window_s, now)
        fast = self._burn(fg, fb, obj.target)
        slow = self._burn(sg, sb, obj.target)
        obj._burn_fast.set(fast)
        obj._burn_slow.set(slow)
        thr = self.burn_threshold
        breaching = (fg + fb >= self.min_events and fast >= thr
                     and slow >= thr)
        if breaching and not obj.alert_active:
            obj.alert_active = True
            obj._active_g.set(1)
            obj._alerts.inc()
            escalated = False
            if self.escalate and obj.breaker is not None:
                obj.breaker.force_degraded(
                    f"slo burn {fast:.1f}x fast / {slow:.1f}x slow "
                    f"(threshold {thr:g}x)")
                escalated = True
                obj._escalations.inc()
            _flight.event("slo_burn_alert", endpoint=obj.name,
                          fast_burn=round(fast, 3), slow_burn=round(slow, 3),
                          threshold=thr, target=obj.target,
                          escalated=escalated)
        elif obj.alert_active and fast < thr:
            obj.alert_active = False
            obj._active_g.set(0)
            _flight.event("slo_burn_clear", endpoint=obj.name,
                          fast_burn=round(fast, 3))
        return {"endpoint": obj.name, "fast_burn": fast, "slow_burn": slow,
                "alert_active": obj.alert_active,
                "fast_events": fg + fb, "slow_events": sg + sb}

    def check_all(self) -> List[dict]:
        return [self.check(obj) for obj in self.objectives()]

    def snapshot(self) -> List[dict]:
        """Every objective's state with its threshold and target."""
        out = []
        for obj in self.objectives():
            st = self.check(obj)
            st.update(threshold_us=obj.threshold_us, target=obj.target)
            out.append(st)
        return out

    def _reset_for_tests(self):
        with self._lock:
            self._objectives.clear()


#: the process-wide monitor InferenceServer.register() feeds
MONITOR = SLOMonitor()
