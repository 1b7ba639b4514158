"""Per-endpoint serving counters and latency quantiles (the minimal core of
``mxnet_tpu/serving/stats.py``).

Counters: request lifecycle (submitted / completed / rejected /
deadline_drops / cancelled), device steps (batches, and warmup_batches for
the construction probe and warmup runs), rows (real_rows / padded_rows;
occupancy = real / (real + padded)). Latencies (submit -> result, and the
device step) keep the most recent samples in a bounded window and report
exact quantiles over it.

:class:`LatencyHistogram` is the reference's log-spaced histogram, which the
decode path's ``DecodeStats`` keeps (approximate quantiles, bounded memory
over a sequence's whole life).
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Sequence

import numpy as np

__all__ = ["EndpointStats", "LatencyHistogram"]

_WINDOW = 1 << 16      # samples kept per latency series

# geometric bins with ratio 2**(1/8) (~9% wide), starting at 1 us; 240 bins
# top out around 1e9 us (~17 min). Bin i covers [_RATIO**i, _RATIO**(i+1)).
_RATIO = 2.0 ** 0.125
_NBINS = 240
_BOUNDS = tuple(_RATIO ** (i + 1) for i in range(_NBINS))


def _quantile_from_buckets(bounds: Sequence[float], counts: Sequence[int],
                           n: int, p: float, max_seen: float) -> float:
    """Approximate p-quantile (p in [0, 100]) as the geometric midpoint of
    the bucket holding the rank; past the last bound, the observed max."""
    if n == 0:
        return 0.0
    rank = max(1, int(round(p / 100.0 * n)))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            if i >= len(bounds):
                return max_seen
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else hi / 2.0
            return (lo * hi) ** 0.5
    return max_seen


class LatencyHistogram:
    """Log-spaced duration histogram with quantile estimation (not
    thread-safe: its owner holds a lock around it)."""

    __slots__ = ("counts", "n", "total_us", "min_us", "max_us")

    def __init__(self):
        self.counts = [0] * _NBINS
        self.n = 0
        self.total_us = 0.0
        self.min_us = float("inf")
        self.max_us = 0.0

    def record(self, dur_us: float):
        d = max(float(dur_us), 0.0)
        self.n += 1
        self.total_us += d
        self.min_us = min(self.min_us, d)
        self.max_us = max(self.max_us, d)
        idx = 0 if d < 1.0 else min(int(math.log(d) / math.log(_RATIO)),
                                    _NBINS - 1)
        self.counts[idx] += 1

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> approximate duration in us (geometric bin
        midpoint), 0.0 when empty."""
        return _quantile_from_buckets(_BOUNDS, self.counts, self.n, p,
                                      self.max_us)

    def snapshot(self) -> Dict[str, float]:
        if self.n == 0:
            return {"count": 0, "mean_us": 0.0, "p50_us": 0.0, "p95_us": 0.0,
                    "p99_us": 0.0, "min_us": 0.0, "max_us": 0.0}
        return {"count": self.n, "mean_us": self.total_us / self.n,
                "p50_us": self.percentile(50), "p95_us": self.percentile(95),
                "p99_us": self.percentile(99), "min_us": self.min_us,
                "max_us": self.max_us}


def _quantiles(samples) -> Dict[str, float]:
    if not samples:
        return {"count": 0, "p50_us": 0.0, "p99_us": 0.0, "mean_us": 0.0,
                "max_us": 0.0}
    a = np.asarray(samples, dtype=np.float64)
    p50, p99 = np.percentile(a, [50, 99])
    return {"count": int(a.size), "p50_us": float(p50), "p99_us": float(p99),
            "mean_us": float(a.mean()), "max_us": float(a.max())}


class EndpointStats:
    """Counters and latency windows for one ModelEndpoint (thread-safe)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "submitted": 0, "completed": 0, "rejected": 0,
            "deadline_drops": 0, "cancelled": 0, "batches": 0,
            "warmup_batches": 0, "real_rows": 0, "padded_rows": 0}
        self._latency = deque(maxlen=_WINDOW)
        self._step = deque(maxlen=_WINDOW)

    def bump(self, counter: str, delta: int = 1):
        with self._lock:
            self.counters[counter] += delta

    def record_latency(self, dur_us: float):
        with self._lock:
            self._latency.append(float(dur_us))

    def record_step(self, dur_us: float):
        with self._lock:
            self._step.append(float(dur_us))

    def snapshot(self) -> Dict:
        with self._lock:
            c = dict(self.counters)
            lat, step = list(self._latency), list(self._step)
        den = c["real_rows"] + c["padded_rows"]
        return {"counters": c,
                "batch_occupancy": c["real_rows"] / den if den else 0.0,
                "latency": _quantiles(lat), "step": _quantiles(step)}
