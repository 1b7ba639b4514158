"""mxnet_tpu_torch.telemetry — the process-wide metrics registry and
cross-layer tracing (the port of ``mxnet_tpu/telemetry``).

Every instrumented subsystem of the port — the serving tier (stats,
server, endpoint, pipeline, tail guard, router, autoscaler, supervisor,
decode), ParallelTrainStep, the kvstore, the DataLoader, resilience
(faults, retry, checkpoint, watchdog, preemption, numerics), the embedding
tables, the executable cache and the serving fabric — reports into ONE
thread-safe registry under the reference's family names, exported two
ways:

    from mxnet_tpu_torch import telemetry

    telemetry.snapshot()          # whole registry as one JSON-able dict
    telemetry.prometheus_text()   # Prometheus text exposition (scrapable)
    telemetry.periodic_logger(10) # background heartbeat + snapshot file

    with telemetry.span("app.request", user="u1") as s:
        ...                       # nested spans share s.trace_id

Families are created by subsystems at import time via get-or-create, bumped
through pre-bound label children on the hot path, and linted at
registration (``^mxtpu_[a-z0-9_]+$``). A family is the one count: the
attributes and ``snapshot()``s subsystems kept before read its children
(``metrics.Baseline`` gives an owner its own share of a child). Spans nest,
carry a trace id across threads (a serving request's id survives queue ->
batch assembly -> device step), and feed both the profiler's chrome trace
(when a session runs) and ``mxtpu_span_duration_us`` (always). Flight
bundles (``flight``), device-memory attribution (``memstats``) and the
drift sentinel (``perf_sentinel``) sit beside them; ``slo`` is the
per-tenant SLO monitor.

Recording never waits for the card: counters, spans and events are host
operations on durations the caller measured; device memory is read only on
a scrape (``snapshot``, ``prometheus_text``), a dump or a trigger.

``goodput`` attributes the process's wall clock to exclusive buckets
(compile, data wait, step, checkpoint flush, recovery, drain, idle) from
the families above; ``fleet`` merges several processes' snapshots (the
live registry, ``dump()`` files, ``/metricsz?json=1`` scrapes) into one,
with a worst-of health rollup; ``DebugServer`` serves the -z pages on
loopback (``MXNET_DEBUG_PORT`` starts one at import).

Not ported yet (ROADMAP Q1.12c): the compile ledger and the cost model;
the debug server's ``/compilez`` and ``/costz`` answer 501 until then.
:data:`NOT_REGISTERED` lists every reference family the port does not
register, with the reason.
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      DEFAULT_BUCKETS, METRIC_NAME_RE)
from .flight import FlightRecorder, event
from .tracing import (Span, span, current_span, current_trace_id,
                      new_trace_id, spool_flush, read_spool, journey)
from .reporter import (PeriodicReporter, periodic_logger, dump,
                       sample_device_memory, summary_line)
from .slo import MONITOR, Objective, SLOMonitor
from . import flight, memstats, perf_sentinel, slo
from . import debug_server, fleet, goodput
from .debug_server import DebugServer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS", "METRIC_NAME_RE",
    "Span", "span", "current_span", "current_trace_id", "new_trace_id",
    "spool_flush", "read_spool", "journey",
    "PeriodicReporter", "periodic_logger", "dump", "sample_device_memory",
    "summary_line",
    "FlightRecorder", "event", "flight",
    "SLOMonitor", "Objective", "MONITOR", "slo",
    "memstats", "perf_sentinel", "DebugServer", "debug_server", "fleet",
    "goodput",
    "counter", "gauge", "histogram", "snapshot", "snapshot_json",
    "prometheus_text", "lint_names", "NOT_REGISTERED",
]

#: Reference families the port does not register, each with its reason.
NOT_REGISTERED = {
    # the per-(op, attributes) jax.jit cache: the port runs ops eagerly and
    # compiles nothing per op (ops/registry.py)
    "mxtpu_jit_cache_hits_total": "no per-op compile cache",
    "mxtpu_jit_cache_misses_total": "no per-op compile cache",
    "mxtpu_jit_cache_evictions_total": "no per-op compile cache",
    "mxtpu_jit_cache_size": "no per-op compile cache",
    # buffer donation: ParallelTrainStep updates its state in place
    # (optimizer steps write the parameters' own storage), nothing is donated
    "mxtpu_train_donated_replace_total": "no buffer donation",
    # modules that wait for ROADMAP Q1.12c: their reference reads
    # StableHLO, and the port's analog needs a design first
    "mxtpu_compile_records_total": "the compile ledger waits for Q1.12c",
    "mxtpu_compile_wall_seconds_total":
        "the compile ledger waits for Q1.12c",
    "mxtpu_compile_duplicates_total": "the compile ledger waits for Q1.12c",
    "mxtpu_compile_duplicate_waste_seconds_total":
        "the compile ledger waits for Q1.12c",
    "mxtpu_compile_text_retained_total":
        "the compile ledger waits for Q1.12c",
    "mxtpu_ir_guard_total": "the compile ledger waits for Q1.12c",
    "mxtpu_cost_predicted_us": "the cost model waits for Q1.12c",
    "mxtpu_cost_residual_ratio": "the cost model waits for Q1.12c",
    "mxtpu_cost_prior_used_total": "the cost model waits for Q1.12c",
    "mxtpu_cost_model_drift_total": "the cost model waits for Q1.12c",
}


# -- registry conveniences (the surface subsystems and users actually call) --

def counter(name, help="", labelnames=()) -> Counter:
    """Get-or-create a Counter in the default registry."""
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    """Get-or-create a Gauge in the default registry."""
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None) -> Histogram:
    """Get-or-create a Histogram (fixed log-spaced default buckets)."""
    return REGISTRY.histogram(name, help, labelnames, buckets)


def _refresh_memory_gauges():
    """On-demand gauge refresh for the operator's single-pane exports:
    device memory stats plus the memstats holder/attribution gauges (the
    scrape IS the sampling tick — no background thread required)."""
    sample_device_memory()
    try:
        memstats.reconcile()
    except Exception:
        pass


def snapshot() -> dict:
    """Whole-registry snapshot as one JSON-able dict (refreshes device
    memory + attribution gauges first — the snapshot is the operator's
    single pane)."""
    _refresh_memory_gauges()
    return REGISTRY.snapshot()


def snapshot_json(**dumps_kw) -> str:
    import json as _json
    return _json.dumps(snapshot(), **dumps_kw)


def prometheus_text() -> str:
    """Prometheus text exposition of the default registry."""
    _refresh_memory_gauges()
    return REGISTRY.prometheus_text()


def lint_names() -> list:
    """Metric-name lint violations in the default registry (empty = clean)."""
    return REGISTRY.lint_names()
