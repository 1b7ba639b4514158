"""Per-endpoint serving counters and latency quantiles (the port of
``mxnet_tpu/serving/stats.py``).

Every count is a child of the process-wide ``mxtpu_serving_*`` families of
the port's telemetry registry, labelled by endpoint, as the reference's
stats were re-based (its docstring): the request lifecycle (submitted /
completed / rejected / deadline_drops / cancelled), device steps
(batches), rows (real_rows / padded_rows; occupancy = real / (real +
padded)), the first run of each bucket (``compiles``, the cache misses;
its time in ``compile_ms_total``: the port compiles nothing, this is the
first-use cost warmup pays), later runs of a warm bucket (``cache_hits``),
the queue gauges and sheds by reason (queue_full, degraded, circuit_open,
circuit_half_open, brownout). An endpoint reads its own share of each
child (:class:`~..telemetry.metrics.Baseline`): one built again under a
used name starts from zero while the family keeps counting. Three counts
have no reference family and stay here: ``hot_swaps`` (this endpoint's
committed swaps; ``mxtpu_serving_hot_swaps_total`` counts the process's by
outcome), ``warmup_batches`` (the construction probe and warmup runs) and
``swap_probes`` (the forwards of hot-swap probes and recorded
checkpoints).

Latency series (submit -> result, the device step, submit -> batch
assembly as ``queue_wait``, the host prep of a batch as ``prep``) feed the
families' histograms and keep the most recent samples in a bounded window,
whose exact quantiles the snapshot reports; ``prep_overlap_ratio`` is the
process-wide gauge (the share of prep time hidden under a device step).
Every step latency also feeds the drift sentinel
(``serving_step.<endpoint>``). Nothing here reads the card.

:class:`LatencyHistogram` is the reference's log-spaced histogram, which the
decode path's ``DecodeStats`` keeps (approximate quantiles, bounded memory
over a sequence's whole life); it shares the registry's quantile estimator.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict

import numpy as np

from .. import telemetry as _telemetry
from ..telemetry import perf_sentinel as _perf_sentinel
from ..telemetry.metrics import Baseline, _quantile_from_buckets

__all__ = ["EndpointStats", "LatencyHistogram", "set_prep_overlap_ratio"]

_WINDOW = 1 << 16      # samples kept per latency series

# shared-registry families (one per metric, children per endpoint label)
_REQUESTS = _telemetry.counter(
    "mxtpu_serving_requests_total",
    "Serving request lifecycle events by endpoint and event "
    "(submitted/completed/rejected/deadline_dropped/cancelled).",
    labelnames=("endpoint", "event"))
_BATCHES = _telemetry.counter(
    "mxtpu_serving_batches_total", "Device batch steps executed.",
    labelnames=("endpoint",))
_ROWS = _telemetry.counter(
    "mxtpu_serving_batch_rows_total",
    "Batch rows by kind: real (request rows) vs padded (bucket fill); "
    "occupancy = real / (real + padded).",
    labelnames=("endpoint", "kind"))
_QUEUE_DEPTH = _telemetry.gauge(
    "mxtpu_serving_queue_depth",
    "Rows currently admitted and waiting, per endpoint.",
    labelnames=("endpoint",))
_QUEUE_PEAK = _telemetry.gauge(
    "mxtpu_serving_queue_peak", "High-water mark of the admitted-row queue.",
    labelnames=("endpoint",))
_OCCUPANCY = _telemetry.gauge(
    "mxtpu_serving_batch_occupancy",
    "Cumulative real/(real+padded) row ratio per endpoint (0..1).",
    labelnames=("endpoint",))
_LATENCY = _telemetry.histogram(
    "mxtpu_serving_request_latency_us",
    "End-to-end request latency: submit -> result ready (microseconds).",
    labelnames=("endpoint",))
_STEP = _telemetry.histogram(
    "mxtpu_serving_step_latency_us",
    "Device step latency: pad + run + slice (microseconds).",
    labelnames=("endpoint",))
_CACHE_HITS = _telemetry.counter(
    "mxtpu_serving_cache_hits_total",
    "Shape-bucket executable cache hits.", labelnames=("endpoint",))
_CACHE_MISSES = _telemetry.counter(
    "mxtpu_serving_cache_misses_total",
    "Shape-bucket executable cache misses (each one is a compile).",
    labelnames=("endpoint",))
_COMPILE_SECONDS = _telemetry.counter(
    "mxtpu_serving_compile_seconds_total",
    "Cumulative wall seconds spent compiling bucket executables; growth "
    "after warmup is a recompile storm.", labelnames=("endpoint",))
_QUEUE_WAIT = _telemetry.histogram(
    "mxtpu_serving_queue_wait_us",
    "Time a request waits admitted-but-unscheduled: submit -> picked for a "
    "batch assembly (microseconds). The scheduling share of latency — at "
    "saturation this, not step time, is where p99 lives.",
    labelnames=("endpoint",))
_PREP_LATENCY = _telemetry.histogram(
    "mxtpu_serving_prep_latency_us",
    "Host prep time per batch: concat + pad + device transfer "
    "(microseconds). Pipelined serving overlaps this with the device step.",
    labelnames=("endpoint",))
_SHED = _telemetry.counter(
    "mxtpu_serving_shed_total",
    "Requests shed at admission by endpoint and reason: queue_full, "
    "degraded (tightened admission), circuit_open, circuit_half_open.",
    labelnames=("endpoint", "reason"))
_PREP_OVERLAP = _telemetry.gauge(
    "mxtpu_serving_prep_overlap_ratio",
    "Cumulative fraction of host batch-prep time hidden under a concurrent "
    "device step (0..1); ~0 means prep rides the critical path.")


def set_prep_overlap_ratio(ratio: float):
    """Pipeline hook for the process-wide prep/step overlap gauge."""
    _PREP_OVERLAP.set(ratio)


# EndpointStats counter key -> the lifecycle event label
_EVENT_NAMES = {"submitted": "submitted", "completed": "completed",
                "rejected": "rejected", "deadline_drops": "deadline_dropped",
                "cancelled": "cancelled"}
# counts without a reference family, kept by the endpoint itself
_LOCAL = ("warmup_batches", "hot_swaps", "swap_probes")

# geometric bins with ratio 2**(1/8) (~9% wide), starting at 1 us; 240 bins
# top out around 1e9 us (~17 min). Bin i covers [_RATIO**i, _RATIO**(i+1)).
_RATIO = 2.0 ** 0.125
_NBINS = 240
_BOUNDS = tuple(_RATIO ** (i + 1) for i in range(_NBINS))


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
    """Counters, gauges and latency windows for one ModelEndpoint
    (thread-safe), over the registry's families."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        # pre-bound children (one bump, no lookup, on the hot path)
        self._m_events = {k: _REQUESTS.labels(name, v)
                          for k, v in _EVENT_NAMES.items()}
        self._m_batches = _BATCHES.labels(name)
        self._m_rows = {"real_rows": _ROWS.labels(name, "real"),
                        "padded_rows": _ROWS.labels(name, "padded")}
        self._m_qdepth = _QUEUE_DEPTH.labels(name)
        self._m_qpeak = _QUEUE_PEAK.labels(name)
        self._m_occupancy = _OCCUPANCY.labels(name)
        self._m_latency = _LATENCY.labels(name)
        self._m_step = _STEP.labels(name)
        self._m_queue_wait = _QUEUE_WAIT.labels(name)
        self._m_prep = _PREP_LATENCY.labels(name)
        self._m_hits = _CACHE_HITS.labels(name)
        self._m_misses = _CACHE_MISSES.labels(name)
        self._m_compile_s = _COMPILE_SECONDS.labels(name)
        self._own = Baseline({
            **self._m_events, "batches": self._m_batches, **self._m_rows,
            "compiles": self._m_misses, "cache_hits": self._m_hits,
            "compile_s": self._m_compile_s})
        self._shed = Baseline()
        self._local: Dict[str, int] = dict.fromkeys(_LOCAL, 0)
        # a new endpoint starts with an empty queue
        self._m_qdepth.set(0)
        self._m_qpeak.set(0)
        self._latency = deque(maxlen=_WINDOW)
        self._step = deque(maxlen=_WINDOW)
        self._queue_wait = deque(maxlen=_WINDOW)
        self._prep = deque(maxlen=_WINDOW)

    # -- O(1) bumps on the dispatch path ------------------------------------
    def bump(self, counter: str, delta: int = 1):
        ev = self._m_events.get(counter)
        if ev is not None:
            ev.inc(delta)
        elif counter == "batches":
            self._m_batches.inc(delta)
        elif counter in self._m_rows:
            with self._lock:
                self._m_rows[counter].inc(delta)
                real = self._m_rows["real_rows"].value
                den = real + self._m_rows["padded_rows"].value
                self._m_occupancy.set(real / den if den else 0.0)
        elif counter == "cache_hits":
            self._m_hits.inc(delta)
        else:
            with self._lock:
                self._local[counter] += delta

    @property
    def counters(self) -> Dict[str, int]:
        """This endpoint's counts, by the names of the reference's
        ``EndpointStats.counters``."""
        c = self._own.as_dict()
        del c["compile_s"]
        with self._lock:
            c.update(self._local)
        return c

    @property
    def queue_depth(self) -> int:
        return int(self._m_qdepth.value)

    @property
    def queue_peak(self) -> int:
        return int(self._m_qpeak.value)

    @property
    def compile_us(self) -> float:
        return self._own["compile_s"] * 1e6

    @property
    def shed_reasons(self) -> Dict[str, int]:
        return self._shed.as_dict()

    def set_queue_depth(self, rows: int):
        with self._lock:
            self._m_qdepth.set(rows)
            if rows > self._m_qpeak.value:
                self._m_qpeak.set(rows)

    def record_latency(self, dur_us: float):
        with self._lock:
            self._latency.append(float(dur_us))
        self._m_latency.observe(dur_us)

    def record_step(self, dur_us: float):
        with self._lock:
            self._step.append(float(dur_us))
        self._m_step.observe(dur_us)
        _perf_sentinel.observe(f"serving_step.{self.name}", dur_us)

    def record_queue_wait(self, dur_us: float):
        with self._lock:
            self._queue_wait.append(float(dur_us))
        self._m_queue_wait.observe(dur_us)

    def record_prep(self, dur_us: float):
        with self._lock:
            self._prep.append(float(dur_us))
        self._m_prep.observe(dur_us)

    def record_shed(self, reason: str):
        """One admission shed, by reason (the caller bumps ``rejected``)."""
        self._shed.add(reason, _SHED.labels(self.name, reason)).inc()

    def record_compile(self, dur_us: float):
        """The first run of one bucket (warmup)."""
        self._m_misses.inc()
        self._m_compile_s.inc(dur_us / 1e6)

    def snapshot(self) -> Dict:
        c = self.counters
        with self._lock:
            series = {k: list(v) for k, v in (
                ("latency", self._latency), ("step", self._step),
                ("queue_wait", self._queue_wait), ("prep", self._prep))}
        rest = {"queue_depth": self.queue_depth,
                "queue_peak": self.queue_peak,
                "shed": self.shed_reasons,
                "compile_ms_total": self.compile_us / 1e3,
                "prep_overlap_ratio": _PREP_OVERLAP.value}
        den = c["real_rows"] + c["padded_rows"]
        return {"counters": c,
                "batch_occupancy": c["real_rows"] / den if den else 0.0,
                **{k: _quantiles(v) for k, v in series.items()}, **rest}
