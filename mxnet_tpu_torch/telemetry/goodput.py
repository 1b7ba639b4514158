"""Goodput ledger — where did this process's wall clock actually go?
(the port of ``mxnet_tpu/telemetry/goodput.py``).

Attributes elapsed wall time into EXCLUSIVE buckets, entirely from series
the registry already carries (no new instrumentation on any hot path):

  compile           mxtpu_compile_wall_seconds_total (compile-ledger wall
                    seconds; falls back to mxtpu_serving_compile_seconds_total
                    when the ledger saw nothing) + executable-cache
                    deserialize seconds
  data_wait         mxtpu_dataloader_wait_us histogram sum
  step              mxtpu_train_step_latency_us + mxtpu_serving_step_latency_us
                    + mxtpu_decode_step_us + mxtpu_decode_prefill_us sums —
                    the bucket that IS goodput
  checkpoint_flush  mxtpu_checkpoint_save_duration_us +
                    mxtpu_preempt_flush_duration_us sums
  retry_recovery    mxtpu_span_duration_us sums for the recovery span names
                    (checkpoint.restore, resilience.retry, serving.failover)
  drain             mxtpu_span_duration_us{name="serving.drain"} (the span
                    InferenceServer.stop opens around its drain wait)
  idle              the residual: elapsed wall minus every active bucket,
                    clamped at zero

Invariants: buckets are exclusive — each comes from disjoint source
series; if the active sum exceeds elapsed wall (overlapped threads, clock
skew) every active bucket is scaled down proportionally so the total
reconciles; idle is the residual and never negative — so the buckets
always sum to elapsed wall exactly.

The port has no compile ledger yet (ROADMAP Q1.12c), so
``mxtpu_compile_wall_seconds_total`` is never registered and the compile
bucket always takes the fallback: the serving warm-ups' seconds plus the
executable cache's load seconds. The kernels' nvcc and NVRTC builds are
not counted in it until Q1.12c: their wall time falls into ``idle``, as
it would in the reference with an empty ledger.

The step bucket reads the step-latency histograms as the port records
them: host time around the step. A training step that returns before the
card finishes (``ParallelTrainStep`` does not synchronise) books its
dispatch time only, so ``step`` reads low and ``idle`` high by the device
time no host call waited for.

:func:`account` publishes the attribution as
``mxtpu_goodput_seconds_total{bucket=...}`` (monotone: each call emits the
delta since the previous accounting) plus the ``mxtpu_goodput_wall_seconds``
gauge, so snapshot dumps carry their own goodput table and
``tools/fleet_report.py`` can verify buckets-vs-wall offline.

:func:`utilization` is the roofline half in the reference (per-executable
achieved FLOP/s and bytes/s from compile records); the port has no compile
records until ROADMAP Q1.12c, so it returns ``[]``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .metrics import REGISTRY

__all__ = ["BUCKETS", "attribute", "account", "utilization", "reset",
           "wall_seconds"]

BUCKETS = ("compile", "data_wait", "step", "checkpoint_flush",
           "retry_recovery", "drain", "idle")

# span names whose durations count as recovery / drain time
RECOVERY_SPANS = ("checkpoint.restore", "resilience.retry",
                  "serving.failover")
DRAIN_SPANS = ("serving.drain",)

_GOODPUT = REGISTRY.counter(
    "mxtpu_goodput_seconds_total",
    "Process wall time attributed to exclusive buckets (compile / "
    "data_wait / step / checkpoint_flush / retry_recovery / drain / idle). "
    "Buckets sum to mxtpu_goodput_wall_seconds; step is the goodput share.",
    labelnames=("bucket",))
_WALL = REGISTRY.gauge(
    "mxtpu_goodput_wall_seconds",
    "Elapsed wall seconds the goodput buckets attribute (since process "
    "start / the last goodput.reset()).")

_LOCK = threading.Lock()
_T0 = time.perf_counter()
_LAST: Dict[str, float] = {}       # bucket -> absolute seconds last emitted


def _fam_sum(snap: Dict, name: str, value_key: str = "value") -> float:
    fam = (snap.get("metrics") or {}).get(name)
    if not fam:
        return 0.0
    return sum(float(s.get(value_key, 0.0) or 0.0)
               for s in fam.get("series", []))


def _span_sum_s(snap: Dict, names) -> float:
    """Summed duration (seconds) of mxtpu_span_duration_us series whose
    ``name`` label is in ``names``."""
    fam = (snap.get("metrics") or {}).get("mxtpu_span_duration_us")
    if not fam:
        return 0.0
    total = 0.0
    for s in fam.get("series", []):
        if (s.get("labels") or {}).get("name") in names:
            total += float(s.get("sum", 0.0) or 0.0)
    return total / 1e6


def attribute(snap: Dict, elapsed_s: Optional[float]) -> Dict[str, float]:
    """Pure attribution: registry snapshot + elapsed wall -> bucket dict.

    With ``elapsed_s`` None only the active buckets are reported (idle 0,
    no reconciliation) — the best an offline reader without a wall anchor
    can do.
    """
    compile_s = _fam_sum(snap, "mxtpu_compile_wall_seconds_total")
    if not compile_s:
        compile_s = _fam_sum(snap, "mxtpu_serving_compile_seconds_total")
    compile_s += _fam_sum(snap, "mxtpu_exec_cache_deserialize_seconds_total")
    buckets = {
        "compile": compile_s,
        "data_wait": _fam_sum(snap, "mxtpu_dataloader_wait_us", "sum") / 1e6,
        "step": (_fam_sum(snap, "mxtpu_train_step_latency_us", "sum")
                 + _fam_sum(snap, "mxtpu_serving_step_latency_us", "sum")
                 + _fam_sum(snap, "mxtpu_decode_step_us", "sum")
                 + _fam_sum(snap, "mxtpu_decode_prefill_us", "sum")) / 1e6,
        "checkpoint_flush":
            (_fam_sum(snap, "mxtpu_checkpoint_save_duration_us", "sum")
             + _fam_sum(snap, "mxtpu_preempt_flush_duration_us", "sum")) / 1e6,
        "retry_recovery": _span_sum_s(snap, RECOVERY_SPANS),
        "drain": _span_sum_s(snap, DRAIN_SPANS),
    }
    active = sum(buckets.values())
    if elapsed_s is None:
        buckets["idle"] = 0.0
        return buckets
    elapsed_s = max(0.0, float(elapsed_s))
    if active > elapsed_s and active > 0.0:
        # overlapped work (pipelined prep/step threads, N replicas in one
        # process) can book more active seconds than one wall clock holds;
        # scale proportionally so the attribution still reconciles
        scale = elapsed_s / active
        for k in buckets:
            buckets[k] *= scale
        active = elapsed_s
    buckets["idle"] = max(0.0, elapsed_s - active)
    return buckets


def wall_seconds() -> float:
    """Elapsed wall this process's goodput attributes over."""
    return time.perf_counter() - _T0


def account(snap: Optional[Dict] = None) -> Dict[str, float]:
    """Attribute wall time now and publish the result as metrics.

    Emits the per-bucket DELTA since the previous accounting into
    ``mxtpu_goodput_seconds_total{bucket=...}`` (so the counter stays
    monotone and its absolute value equals the current attribution) and
    refreshes ``mxtpu_goodput_wall_seconds``. Returns the absolute bucket
    attribution. A bucket whose absolute value shrank (proportional
    rescaling between calls) emits no negative delta — the counter keeps
    its high-water value and re-converges on the next call.
    """
    if snap is None:
        snap = REGISTRY.snapshot()
    elapsed = wall_seconds()
    buckets = attribute(snap, elapsed)
    with _LOCK:
        for bucket, absolute in buckets.items():
            delta = absolute - _LAST.get(bucket, 0.0)
            if delta > 0:
                _GOODPUT.labels(bucket).inc(delta)
                _LAST[bucket] = absolute
        _WALL.set(elapsed)
    return buckets


def utilization(snap: Optional[Dict] = None,
                records: Optional[List[Dict]] = None) -> List[Dict]:
    """Per-executable achieved-vs-peak utilization estimates: none yet.

    The reference computes them from its compile ledger's records (flops
    and bytes accessed of each executable over its observed mean step).
    The port has no compile records until ROADMAP Q1.12c, so this returns
    ``[]``; handing in records raises rather than ignoring them. The
    roofline arithmetic and its peak-rate knobs arrive with the records.
    """
    if records:
        raise NotImplementedError(
            "goodput.utilization over compile records waits for the port's "
            "compile ledger (ROADMAP Q1.12c)")
    return []


def reset(t0: Optional[float] = None):
    """Restart the attribution clock (tests; a scripted run sets its own t0
    on the perf_counter timebase). Also zeroes the emitted counter series —
    the ledger's invariant is "counter == the current attribution since the
    last reset", so a fresh clock must mean a fresh ledger."""
    global _T0
    with _LOCK:
        _T0 = time.perf_counter() if t0 is None else float(t0)
        _LAST.clear()
        for _labels, child in _GOODPUT._series():
            child._value = 0.0
        _WALL.set(0.0)
