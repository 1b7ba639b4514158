"""Perf-regression sentinel: EWMA drift detection over step latencies (the
port of ``mxnet_tpu/telemetry/perf_sentinel.py``).

This module watches the *running* fleet. Every train-step and serving-step
latency observation feeds a per-stream :class:`DriftDetector`: a slow EWMA
tracks the baseline, a fast EWMA tracks "now", and when the fast track sits
above ``baseline * MXNET_PERF_REGRESSION_RATIO`` for
``MXNET_PERF_SUSTAIN_N`` consecutive observations the sentinel emits a
``perf_regression`` flight event (bundle-dumping when a flight directory is
configured) and bumps ``mxtpu_perf_regressions_total``. One spike never
fires — sustained drift does.

After firing, the detector re-baselines at the regressed level: the alert
is edge-triggered (one event per regression episode, not one per step), and
a later *further* regression fires again.

Hot-path cost: one lock, a handful of float ops on host durations the
caller already measured — it never reads the card. Disable entirely with MXNET_PERF_SENTINEL=0.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .metrics import REGISTRY

__all__ = ["DriftDetector", "PerfSentinel", "SENTINEL", "observe"]

_REGRESSIONS = REGISTRY.counter(
    "mxtpu_perf_regressions_total",
    "Sustained latency regressions detected by the EWMA drift sentinel, "
    "by stream (train_step / serving_step.<endpoint>).",
    labelnames=("stream",))
_BASELINE = REGISTRY.gauge(
    "mxtpu_perf_baseline_us",
    "The drift sentinel's slow-EWMA baseline latency per stream.",
    labelnames=("stream",))


def _cfg(name, default):
    try:
        from .. import config
    except ImportError:
        return default
    return config.get(name)


class DriftDetector:
    """EWMA drift detector for one latency stream (microseconds)."""

    __slots__ = ("stream", "alpha", "ratio", "sustain_n", "warmup_n",
                 "n", "baseline", "fast", "streak", "fired")

    def __init__(self, stream: str, alpha: float, ratio: float,
                 sustain_n: int, warmup_n: int):
        self.stream = stream
        self.alpha = alpha
        self.ratio = ratio
        self.sustain_n = max(1, sustain_n)
        self.warmup_n = max(1, warmup_n)
        self.n = 0
        self.baseline: Optional[float] = None   # slow EWMA
        self.fast: Optional[float] = None       # fast EWMA (4x alpha)
        self.streak = 0
        self.fired = 0

    def observe(self, dur_us: float) -> bool:
        """Feed one latency; True when this observation fires a regression."""
        d = float(dur_us)
        self.n += 1
        if self.baseline is None:
            self.baseline = self.fast = d
            return False
        fast_alpha = min(1.0, self.alpha * 4.0)
        self.fast += fast_alpha * (d - self.fast)
        if self.n <= self.warmup_n:
            # warmup: both tracks converge, nothing can fire
            self.baseline += self.alpha * (d - self.baseline)
            return False
        if self.fast > self.baseline * self.ratio:
            self.streak += 1
            if self.streak >= self.sustain_n:
                # edge-trigger: re-baseline at the regressed level so the
                # alert fires once per episode
                self.streak = 0
                self.fired += 1
                self.baseline = self.fast
                return True
        else:
            self.streak = 0
            self.baseline += self.alpha * (d - self.baseline)
        return False

    def snapshot(self) -> Dict:
        return {"stream": self.stream, "n": self.n,
                "baseline_us": self.baseline, "fast_us": self.fast,
                "streak": self.streak, "fired": self.fired}


class PerfSentinel:
    """Per-stream drift detectors behind one lock; knobs read at stream
    creation (a new stream after ``config.set`` picks up new values)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams: Dict[str, DriftDetector] = {}

    def observe(self, stream: str, dur_us: float):
        """Feed one latency observation; fires the flight trigger on
        sustained regression. Never raises."""
        try:
            if not bool(_cfg("MXNET_PERF_SENTINEL", True)):
                return
            with self._lock:
                det = self._streams.get(stream)
                if det is None:
                    det = DriftDetector(
                        stream,
                        alpha=float(_cfg("MXNET_PERF_EWMA_ALPHA", 0.05)),
                        ratio=float(_cfg("MXNET_PERF_REGRESSION_RATIO", 1.5)),
                        sustain_n=int(_cfg("MXNET_PERF_SUSTAIN_N", 8)),
                        warmup_n=int(_cfg("MXNET_PERF_WARMUP_N", 50)))
                    self._streams[stream] = det
                prev_baseline = det.baseline
                fired = det.observe(dur_us)
                baseline = det.baseline
                fast = det.fast
            _BASELINE.labels(stream).set(baseline or 0.0)
            if fired:
                _REGRESSIONS.labels(stream).inc()
                # report against the pre-episode baseline: firing re-baselines
                # the detector, so det.baseline is already the regressed level
                ref = prev_baseline or baseline
                from . import flight as _flight
                _flight.trigger(
                    "perf_regression", stream=stream,
                    baseline_us=round(ref or 0.0, 1),
                    current_us=round(fast or 0.0, 1),
                    ratio=round((fast / ref) if ref else 0.0, 3))
        except Exception:
            pass

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {s: d.snapshot() for s, d in self._streams.items()}

    def reset(self):
        with self._lock:
            self._streams.clear()


SENTINEL = PerfSentinel()


def observe(stream: str, dur_us: float):
    """Module-level hook the train/serving step paths call."""
    SENTINEL.observe(stream, dur_us)
