"""Per-endpoint serving counters and latency quantiles (the minimal core of
``mxnet_tpu/serving/stats.py``).

Counters: request lifecycle (submitted / completed / rejected /
deadline_drops / cancelled), device steps (batches, and warmup_batches for
the construction probe and warmup runs), rows (real_rows / padded_rows;
occupancy = real / (real + padded)). Latencies (submit -> result, and the
device step) keep the most recent samples in a bounded window and report
exact quantiles over it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict

import numpy as np

__all__ = ["EndpointStats"]

_WINDOW = 1 << 16      # samples kept per latency series


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
