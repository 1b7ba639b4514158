"""Decode-path counters for one generative endpoint (the port of
``mxnet_tpu/serving/generate/stats.py``, without its exported metric
families).

The numbers that matter are decode tokens and steps (tokens/s once divided
by wall clock) and the inter-token latency distribution (the unit of the
per-tenant SLOs). Histograms are :class:`~..stats.LatencyHistogram`.
"""
from __future__ import annotations

import threading
from typing import Dict

from ..stats import LatencyHistogram

__all__ = ["DecodeStats"]

_SEQ_EVENTS = ("submitted", "admitted", "finished", "cancelled", "failed",
               "requeued", "paused", "resumed")


class DecodeStats:
    """Counters and histograms for one decode endpoint (thread-safe).

    Counters: ``tokens`` emitted (prefill first-tokens included), decode
    ``steps``, ``compiles`` (buckets run for the first time), and
    ``seq_<event>`` for each sequence lifecycle event. Histograms (us):
    ``prefill``, decode ``step`` and ``intertoken`` gaps."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "tokens": 0, "steps": 0, "compiles": 0,
            **{f"seq_{ev}": 0 for ev in _SEQ_EVENTS},
        }
        self.prefill = LatencyHistogram()
        self.step = LatencyHistogram()
        self.intertoken = LatencyHistogram()

    def seq_event(self, event: str, delta: int = 1):
        with self._lock:
            self.counters[f"seq_{event}"] += delta

    def tokens(self, n: int = 1):
        with self._lock:
            self.counters["tokens"] += n

    def record_step(self, dur_us: float):
        with self._lock:
            self.counters["steps"] += 1
            self.step.record(dur_us)

    def record_prefill(self, dur_us: float):
        with self._lock:
            self.prefill.record(dur_us)

    def record_intertoken(self, dur_us: float):
        with self._lock:
            self.intertoken.record(dur_us)

    def record_compile(self):
        with self._lock:
            self.counters["compiles"] += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "prefill": self.prefill.snapshot(),
                "step": self.step.snapshot(),
                "intertoken": self.intertoken.snapshot(),
            }
