"""Step-cost model of the decode scheduler (``StepCostEWMA`` of
``mxnet_tpu/serving/router.py``; the router itself is not ported).

The learned cost-model prior the reference can blend in for cold buckets is
not ported either: a bucket never observed is priced by the nearest observed
one, scaled by the row ratio.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["StepCostEWMA"]


class StepCostEWMA:
    """Per-bucket exponentially-weighted moving average of step time (us).

    ``observe(bucket, us)`` is fed by every executed step (and by warm-up's
    one run per bucket, so estimates exist before the first request).
    ``estimate(bucket)`` falls back to the nearest observed bucket scaled by
    the row ratio (0.0 on an empty table) until the bucket itself has been
    observed once."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._est: Dict[int, float] = {}

    def observe(self, bucket: int, step_us: float):
        with self._lock:
            prev = self._est.get(bucket)
            self._est[bucket] = step_us if prev is None else \
                prev + self.alpha * (step_us - prev)

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
