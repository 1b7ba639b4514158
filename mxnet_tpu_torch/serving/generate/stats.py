"""Decode-path counters for one generative endpoint (the port of
``mxnet_tpu/serving/generate/stats.py``).

The numbers that matter are decode tokens and steps (tokens/s once divided
by wall clock) and the inter-token latency distribution (the unit of the
per-tenant SLOs). Every count is a child of the reference's
``mxtpu_decode_*`` families, labelled by endpoint; the ``counters`` of a
:class:`DecodeStats` are its share of them, except ``compiles`` (buckets
run for the first time), which has no family. The latency histograms feed
the families and keep the reference's local
:class:`~..stats.LatencyHistogram` for the snapshot's quantiles.
"""
from __future__ import annotations

import threading
from typing import Dict

from ... import telemetry as _telemetry
from ...telemetry.metrics import Baseline
from ..stats import LatencyHistogram

__all__ = ["DecodeStats"]

_TOKENS = _telemetry.counter(
    "mxtpu_decode_tokens_total",
    "Tokens emitted to client streams (prefill first-tokens included).",
    labelnames=("endpoint",))
_STEPS = _telemetry.counter(
    "mxtpu_decode_steps_total",
    "Batched decode steps executed (each advances every running sequence "
    "by one token).",
    labelnames=("endpoint",))
_SEQS = _telemetry.counter(
    "mxtpu_decode_seqs_total",
    "Sequence lifecycle events: submitted / admitted / finished / "
    "cancelled / failed / requeued (failover) / paused / resumed "
    "(stream backpressure).",
    labelnames=("endpoint", "event"))
_OCCUPANCY = _telemetry.gauge(
    "mxtpu_decode_batch_occupancy",
    "Running sequences / padded batch bucket at the last decode step "
    "(0..1); persistently low means the bucket ladder is too coarse for "
    "the offered concurrency.",
    labelnames=("endpoint",))
_QUEUE_DEPTH = _telemetry.gauge(
    "mxtpu_decode_queue_depth",
    "Sequences admitted-but-waiting for a batch slot or KV pages.",
    labelnames=("endpoint",))
_INTERTOKEN = _telemetry.histogram(
    "mxtpu_decode_intertoken_us",
    "Gap between consecutive tokens of one sequence as emitted by the "
    "scheduler (microseconds) — the unit per-tenant decode SLOs are "
    "expressed in.",
    labelnames=("endpoint", "tenant"))
_PREFILL = _telemetry.histogram(
    "mxtpu_decode_prefill_us",
    "Prefill executable latency per admitted sequence (microseconds).",
    labelnames=("endpoint",))
_STEP_LAT = _telemetry.histogram(
    "mxtpu_decode_step_us",
    "Batched decode-step executable latency (microseconds).",
    labelnames=("endpoint",))
_BACKPRESSURE = _telemetry.counter(
    "mxtpu_decode_stream_backpressure_total",
    "Sequences paused because their client stream buffer filled; the "
    "sequence keeps its KV pages and resumes when the consumer drains.",
    labelnames=("endpoint",))
_FAILOVERS = _telemetry.counter(
    "mxtpu_decode_failovers_total",
    "Decode-worker failovers by reason (worker_dead = the loop thread "
    "died, e.g. an injected decode_stall); running sequences are requeued "
    "with pages and emitted tokens intact.",
    labelnames=("endpoint", "reason"))

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
        self._compiles = 0
        self.prefill = LatencyHistogram()
        self.step = LatencyHistogram()
        self.intertoken = LatencyHistogram()
        self._m_tokens = _TOKENS.labels(name)
        self._m_steps = _STEPS.labels(name)
        self._m_seqs = {ev: _SEQS.labels(name, ev) for ev in _SEQ_EVENTS}
        self._m_occupancy = _OCCUPANCY.labels(name)
        self._m_queue_depth = _QUEUE_DEPTH.labels(name)
        self._m_prefill = _PREFILL.labels(name)
        self._m_step = _STEP_LAT.labels(name)
        self._m_backpressure = _BACKPRESSURE.labels(name)
        self._m_intertoken: Dict[str, object] = {}
        self._own = Baseline({
            "tokens": self._m_tokens, "steps": self._m_steps,
            **{f"seq_{ev}": c for ev, c in self._m_seqs.items()}})

    @property
    def counters(self) -> Dict[str, int]:
        c = self._own.as_dict()
        with self._lock:
            c["compiles"] = self._compiles
        return c

    def seq_event(self, event: str, delta: int = 1):
        self._m_seqs[event].inc(delta)

    def tokens(self, n: int = 1):
        self._m_tokens.inc(n)

    def record_step(self, dur_us: float, rows: int, bucket: int):
        with self._lock:
            self.step.record(dur_us)
        self._m_steps.inc()
        self._m_step.observe(dur_us)
        self._m_occupancy.set(rows / bucket if bucket else 0.0)

    def record_prefill(self, dur_us: float):
        with self._lock:
            self.prefill.record(dur_us)
        self._m_prefill.observe(dur_us)

    def record_intertoken(self, tenant: str, dur_us: float):
        with self._lock:
            self.intertoken.record(dur_us)
            child = self._m_intertoken.get(tenant)
            if child is None:
                child = self._m_intertoken.setdefault(
                    tenant, _INTERTOKEN.labels(self.name, tenant))
        child.observe(dur_us)

    def record_compile(self):
        with self._lock:
            self._compiles += 1

    def backpressure(self):
        self._m_backpressure.inc()

    def failover(self, reason: str):
        _FAILOVERS.labels(self.name, reason).inc()

    def set_queue_depth(self, n: int):
        self._m_queue_depth.set(n)

    def snapshot(self) -> Dict:
        counters = self.counters
        with self._lock:
            return {
                "counters": counters,
                "prefill": self.prefill.snapshot(),
                "step": self.step.snapshot(),
                "intertoken": self.intertoken.snapshot(),
            }
