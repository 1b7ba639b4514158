"""Environment flag registry of the port (the counterpart of
``mxnet_tpu/config.py``).

``get("MXNET_...")`` reads a :func:`set` override, else the process
environment coerced to the flag's type, else the flag's default;
``describe()`` lists every flag. Names, defaults and types are the
reference's. Only flags that the port reads are registered, and the ones
the reference uses to tune XLA (its jit cache, op bulking, remat, PRNG
implementation and Pallas block sizes) are registered as not applicable:
``get`` and ``set`` refuse them, since nothing in the port compiles through
XLA and they have no PyTorch meaning.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

from .base import MXNetError

__all__ = ["register", "get", "set", "describe", "list_flags"]

_REGISTRY: Dict[str, dict] = {}
_OVERRIDES: Dict[str, Any] = {}
_LOCK = threading.Lock()


def register(name, default, type_=None, doc="", applicable=True):
    """Register a flag with its default, type and documentation; a flag
    that is not ``applicable`` is listed but cannot be read or set."""
    if type_ is None:
        type_ = type(default) if default is not None else str
    with _LOCK:
        _REGISTRY[name] = {"default": default, "type": type_, "doc": doc,
                           "applicable": applicable}
    return name


def _spec(name):
    spec = _REGISTRY.get(name)
    if spec is None:
        raise MXNetError(f"unknown flag {name!r}")
    if not spec["applicable"]:
        raise MXNetError(f"{name} tunes XLA in the JAX package and has no "
                         "meaning in the port")
    return spec


def _coerce(name, raw, type_):
    if type_ is bool:
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    try:
        return type_(raw)
    except (TypeError, ValueError) as e:
        raise MXNetError(f"{name}={raw!r}: expected {type_.__name__}") from e


def get(name: str):
    """A flag's value: a :func:`set` override, else the process
    environment's coerced to the flag's type, else its default."""
    spec = _spec(name)
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(name)
    if raw is None:
        return spec["default"]
    return _coerce(name, raw, spec["type"])


def set(name: str, value):  # noqa: A001  (the reference's name)
    """Override a flag for this process (over the environment); ``None``
    removes the override."""
    _spec(name)
    with _LOCK:
        if value is None:
            _OVERRIDES.pop(name, None)
        else:
            _OVERRIDES[name] = value


def list_flags():
    return sorted(_REGISTRY)


def describe() -> str:
    """One line per flag: default, current value and what it does."""
    lines = []
    for name in list_flags():
        spec = _REGISTRY[name]
        if spec["applicable"]:
            lines.append(f"{name} (default {spec['default']!r}, current "
                         f"{get(name)!r}): {spec['doc']}")
        else:
            lines.append(f"{name}: not applicable in the port "
                         f"({spec['doc']})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# flags the port reads
# ---------------------------------------------------------------------------
register("MXNET_USE_SIGNAL_HANDLER", True, bool,
         "Install the crash backtrace logger (faulthandler) at import.")
register("MXNET_SAFE_ACCUMULATION", True, bool,
         "Accumulate reductions over bf16/fp16 inputs in fp32.")
register("MXNET_BN_ONEPASS", "auto", str,
         "BatchNorm batch moments: 'auto' takes the one-pass E[x^2] - "
         "E[x]^2 form for bf16/fp16 input only, 1/0 forces one-pass/"
         "two-pass for every dtype.")
register("MXNET_BN_BF16_REDUCE", True, bool,
         "BatchNorm and LayerNorm on bf16 input: one-pass f32 moments and "
         "an f32 scale/shift applied to x, every materialized tensor bf16.")
register("MXNET_OPT_BF16_MOMENTS", False, bool,
         "Adam/AdamW: store the moments in bfloat16 (f32 arithmetic).")
register("MXNET_SUPERVISOR_POLL_S", 0.05, float,
         "PoolSupervisor and the decode scheduler's monitor: how often the "
         "serving worker/prep threads (or the decode worker) are checked "
         "for death or a wedged in-flight batch (stall detection itself "
         "rides the Watchdog).")
register("MXNET_SERVING_DRAIN_TIMEOUT_S", 30.0, float,
         "InferenceServer.stop(drain=True) and DecodeScheduler.stop: "
         "longest wait for the drain; past it the remaining requests fail "
         "(ServerClosedError queued, RequestTimeoutError inside a batch).")
register("MXNET_SERVING_PIPELINE_DEPTH", 1, int,
         "InferenceServer: prepared batches the prep thread may run ahead "
         "of the worker. Depth d cycles d+1 staging slots (pinned host "
         "buffers and device inputs); 1 is double buffering. "
         "pipeline=False ignores it.")
register("MXNET_SLO_TARGET", 0.999, float,
         "SLO monitor: default objective target (fraction of requests "
         "under the endpoint's slo_ms) when register() passes none.")
register("MXNET_SLO_FAST_WINDOW_S", 300.0, float,
         "SLO monitor: fast burn-rate window (seconds).")
register("MXNET_SLO_SLOW_WINDOW_S", 3600.0, float,
         "SLO monitor: slow burn-rate window (seconds).")
register("MXNET_SLO_BURN_THRESHOLD", 10.0, float,
         "SLO monitor: burn-rate multiple (bad ratio / error budget) both "
         "windows must exceed before the alert fires.")
register("MXNET_SLO_MIN_EVENTS", 10, int,
         "SLO monitor: fewest requests in the fast window before an alert "
         "may fire.")
register("MXNET_SLO_ESCALATE", False, bool,
         "SLO monitor: a firing alert forces the tenant's circuit breaker "
         "to DEGRADED (admission tightened to half its queue bound).")
register("MXNET_AUTOSCALE_MIN_REPLICAS", 1, int,
         "Autoscaler: floor on the replica count.")
register("MXNET_AUTOSCALE_MAX_REPLICAS", 4, int,
         "Autoscaler: ceiling on the replica count.")
register("MXNET_AUTOSCALE_POLL_S", 1.0, float,
         "Autoscaler: seconds between polls of its signals.")
register("MXNET_AUTOSCALE_UP_N", 2, int,
         "Autoscaler: consecutive over-pressure polls before a scale-up.")
register("MXNET_AUTOSCALE_DOWN_N", 5, int,
         "Autoscaler: consecutive idle polls before a scale-down.")
register("MXNET_AUTOSCALE_COOLDOWN_S", 10.0, float,
         "Autoscaler: least seconds between two scaling actions.")
register("MXNET_AUTOSCALE_QUEUE_HIGH", 0.5, float,
         "Autoscaler: queue pressure (worst endpoint's pending rows over "
         "its bound, averaged over replicas) at which a poll is over "
         "pressure.")
register("MXNET_AUTOSCALE_QUEUE_LOW", 0.05, float,
         "Autoscaler: queue pressure at or under which (no alert, burn "
         "under 1) a poll is idle.")
register("MXNET_HEDGE_ENABLE", True, bool,
         "ServingPool: duplicate a still-pending request onto the next "
         "replica after the adaptive hedge delay (first response wins, the "
         "loser is cancelled at batch assembly).")
register("MXNET_HEDGE_BUDGET_RATIO", 0.05, float,
         "Hedging: token-bucket income per primary submit (the ceiling on "
         "hedged traffic as a fraction of the total); <= 0 disables.")
register("MXNET_HEDGE_DELAY_FACTOR", 2.0, float,
         "Hedging: multiple of the predicted step cost in the hedge delay "
         "(max of the observed p95 latency and predicted step x factor).")
register("MXNET_HEDGE_DELAY_MIN_MS", 10.0, float,
         "Hedging: floor on the hedge delay, milliseconds.")
register("MXNET_RETRY_BUDGET_RATIO", 0.1, float,
         "Retry budgets: tokens a tier earns a unit of work done (a batch "
         "stepped, a decode step); a retry costs one; <= 0 disables "
         "budgeting.")
register("MXNET_RETRY_BUDGET_MIN", 50.0, float,
         "Retry budgets: the tokens each tier's bucket starts with.")
register("MXNET_RETRY_BUDGET_CAP", 500.0, float,
         "Retry budgets: ceiling on each tier's bucket.")
register("MXNET_BROWNOUT_ENABLE", True, bool,
         "Brownout ladder: let the controller leave level 0 under "
         "sustained SLO burn; 0 pins level 0.")
register("MXNET_BROWNOUT_UP_N", 2, int,
         "Brownout: consecutive burning ticks before one level down.")
register("MXNET_BROWNOUT_DOWN_N", 3, int,
         "Brownout: consecutive calm ticks before one level back up.")
register("MXNET_BROWNOUT_MAX_NEW_TOKENS", 32, int,
         "Brownout level >= 1: clamp on decode max_new_tokens.")
register("MXNET_BROWNOUT_TIMEOUT_BOOST", 4.0, float,
         "Brownout level >= 1: multiplier on batch timeouts.")
register("MXNET_KV_PAGE_SIZE", 16, int,
         "Paged KV cache: token positions per page.")
register("MXNET_KV_POOL_PAGES", 256, int,
         "Paged KV cache: pages per pool (page 0 is the scratch page).")
register("MXNET_KV_DEFRAG_RATIO", 0.0, float,
         "Paged KV cache: free() compacts the pool when the spread (highest "
         "live page id / pages in use) exceeds this; 0 never.")
register("MXNET_DECODE_MAX_BATCH", 8, int,
         "Decode scheduler: most sequences a decode step advances (the top "
         "of the pow2 decode-bucket ladder).")
register("MXNET_DECODE_MAX_TOKENS", 64, int,
         "Decode scheduler: submit()'s default max_new_tokens.")
register("MXNET_DECODE_STREAM_BUFFER", 64, int,
         "TokenStream: tokens buffered per stream before backpressure "
         "pauses the sequence.")
register("MXNET_DECODE_SLO_MS", 100.0, float,
         "Decode scheduler: default inter-token SLO (ms) of a tenant, "
         "priced into EDF admission; 0 means FIFO admission.")

register("MXNET_FABRIC_VNODES", 64, int,
         "Serving front door: virtual nodes per host on the consistent-"
         "hash tenant routing ring. More vnodes spread tenants more "
         "evenly; fewer make the ring cheaper to walk.")
register("MXNET_FABRIC_HEARTBEAT_S", 0.2, float,
         "Serving front door: host agent heartbeat cadence (seconds). Each "
         "tick touches the host's heartbeat file.")
register("MXNET_FABRIC_HOST_TIMEOUT_S", 2.0, float,
         "Serving front door: FrontDoor.check_hosts() declares a host dead "
         "when its agent heartbeat is older than this many seconds (or the "
         "agent process exited).")
register("MXNET_EXEC_CACHE_DIR", "", str,
         "Executable cache: directory for the compiled kernel binaries "
         "(nvcc libraries, NVRTC cubins), content-addressed by sources, "
         "flags, toolchain, runtime versions and device; shareable across "
         "processes. A build or CudaModule compile checks it first and "
         "stores after a miss. Empty disables the cache.")
register("MXNET_EXEC_CACHE_MAX_BYTES", 1 << 30, int,
         "Executable cache: byte budget for the on-disk store. After "
         "every write the least-recently-used entries (payload mtime, "
         "touched on hit) are evicted until the store fits. 0 disables "
         "eviction.")

register("MXNET_ENGINE_TYPE", "ThreadedEngine", str,
         "Engine for host tasks: ThreadedEngine (the native C++ pool) or "
         "NaiveEngine (synchronous, in Python).")
register("MXNET_CPU_WORKER_NTHREADS", 4, int,
         "Worker threads of the host-task dependency engine.")
register("MXNET_CPU_PRIORITY_NTHREADS", 4, int,
         "ImageRecordIter's default decode and augment threads.")
register("MXNET_HOME", os.path.join("~", ".mxnet"), str,
         "Root of the vision datasets' files (nothing is downloaded).")
register("MXNET_P3_SLICE_SIZE", 1 << 20, int,
         "p3 kvstore: elements per wire slice of a cross-worker reduce.")
register("MXNET_KVSTORE_ASYNC_MAX_STALENESS", -1, int,
         "dist_async: most whole-model push rounds a worker may run ahead "
         "of the slowest (SSP bound); -1 = unbounded, pure async apply.")
register("MXNET_KVSTORE_HEARTBEAT_DIR", "", str,
         "Shared directory of the workers' heartbeat files; empty disables "
         "failure detection (num_dead_node is 0).")
register("MXNET_KVSTORE_HEARTBEAT_INTERVAL", 5, int,
         "Seconds between a worker's heartbeat file writes.")
register("MXNET_DIST_TIMEOUT", 300.0, float,
         "Seconds a collective of a multi-process job may wait for its "
         "peers before it fails (the process group's timeout).")
register("MXNET_EMB_REPLICATE_MAX_BYTES", 1 << 20, int,
         "Embedding planner: tables at or under this footprint are "
         "replicated per shard instead of vocab-partitioned (a full copy "
         "is cheaper than any exchange for small tables).")
register("MXNET_EMB_ROWWISE_HOT_FRACTION", 0.25, float,
         "Embedding planner: when a table's observed top-K hot rows take "
         "at least this share of lookups, partition it row-wise (cyclic "
         "layout), so a frequency-sorted vocab's hot head spreads across "
         "shards.")
register("MXNET_EMB_HOT_TOPK", 64, int,
         "Embedding planner: K of the hot-row hit rate the row-wise "
         "decision reads.")
register("MXNET_EMB_HOTNESS_CAP", 1 << 16, int,
         "Embedding planner: rows of the (frequency-sorted) vocab head the "
         "HotnessTracker counts exactly; hits past it count toward the "
         "total only.")
register("MXNET_EMB_FEED_DEPTH", 2, int,
         "DeviceFeed: staged-batch buffer depth (2 = double-buffered; the "
         "stager runs at most this many batches ahead of the consumer).")

# resilience (CheckpointManager, PreemptionGuard, RetryPolicy, Watchdog,
# CircuitBreaker, NumericsGuard): the reference's names, defaults and types
register("MXNET_CKPT_KEEP", 3, int,
         "CheckpointManager: newest checkpoints retained after each save "
         "(the corrupt-fallback chain depth); 0 disables rotation.")
register("MXNET_CKPT_ASYNC", False, bool,
         "CheckpointManager default: snapshot synchronously but write/fsync "
         "in a background thread, overlapping checkpoint IO with compute "
         "(wait() joins and surfaces write errors).")
register("MXNET_CKPT_WAIT_TIMEOUT_S", 120.0, float,
         "CheckpointManager.wait()/save() bound on joining an outstanding "
         "async checkpoint write; past it wait() raises instead of hanging "
         "shutdown behind a wedged writer (<= 0 = unbounded).")
register("MXNET_PREEMPT_DEADLINE_S", 30.0, float,
         "PreemptionGuard grace budget: the preemption force-flush (join "
         "async checkpoint writes + final save + marker) is measured "
         "against this; a flush that cannot beat it is recorded as "
         "deadline_exceeded in PREEMPTED.json and "
         "mxtpu_preemptions_total.")
register("MXNET_CKPT_FSYNC", True, bool,
         "CheckpointManager: fsync every checkpoint file and directory "
         "rename (the crash-consistency barrier). Disable only for "
         "throwaway test directories.")
register("MXNET_RETRY_MAX_ATTEMPTS", 3, int,
         "RetryPolicy: total attempts (1 = no retries) for retryable "
         "failures (device OOM, UNAVAILABLE, transient compile errors); "
         "fatal errors (shape/dtype mismatch) never retry.")
register("MXNET_RETRY_BASE_MS", 50.0, float,
         "RetryPolicy: backoff before the first retry, milliseconds.")
register("MXNET_RETRY_MAX_MS", 2000.0, float,
         "RetryPolicy: backoff cap, milliseconds.")
register("MXNET_RETRY_MULTIPLIER", 2.0, float,
         "RetryPolicy: exponential backoff multiplier per attempt.")
register("MXNET_RETRY_JITTER", 0.1, float,
         "RetryPolicy: relative jitter (+/- fraction) on each backoff, drawn "
         "from a seeded generator so chaos runs replay exactly.")
register("MXNET_WATCHDOG_STALL_S", 30.0, float,
         "Watchdog: a watched region (device step, serving batch) alive "
         "longer than this counts as a stall — mxtpu_watchdog_stalls_total "
         "fires and the owner's stall callback runs (the serving server "
         "degrades its circuit breaker).")
register("MXNET_WATCHDOG_POLL_S", 0.0, float,
         "Watchdog monitor poll interval; 0 = auto (stall_s/4, clamped to "
         "[0.01, 0.25]s).")
register("MXNET_CIRCUIT_DEGRADED_AFTER", 3, int,
         "CircuitBreaker: consecutive failures before HEALTHY -> DEGRADED "
         "(admission tightens to half the queue bound).")
register("MXNET_CIRCUIT_OPEN_AFTER", 6, int,
         "CircuitBreaker: consecutive failures before -> OPEN (all "
         "admissions shed with ServerOverloadError until cooldown).")
register("MXNET_CIRCUIT_COOLDOWN_S", 5.0, float,
         "CircuitBreaker: seconds OPEN before HALF_OPEN probing begins.")
register("MXNET_NUMERICS_CHECK_EVERY_N", 10, int,
         "NumericsGuard: steps between boundary reads of the retained "
         "on-device health scalars (loss / global grad norm / all-finite "
         "flag). Detection lags by up to twice this many steps; the read "
         "is one host copy of scalars a window old.")
register("MXNET_NUMERICS_POLICY", "auto", str,
         "NumericsGuard recovery policy: skip (rewind to the last clean "
         "boundary snapshot and replay the window minus the offending "
         "batch — bitwise-equal to never having trained on it) | "
         "quarantine (skip + fingerprint/dump the batch and positionally "
         "exclude it from the DataLoader forever) | rewind (restore the "
         "last good checkpoint and fast-forward the loader past the "
         "poisoned window) | auto (skip first offenders, quarantine a "
         "fingerprint's second offense, rewind when exclusion cannot "
         "repair the window).")
register("MXNET_NUMERICS_SPIKE_ZSCORE", 8.0, float,
         "NumericsGuard: EWMA z-score above which a loss/grad-norm reading "
         "counts as a spike (one-sided; falling loss never flags).")
register("MXNET_NUMERICS_WARMUP_STEPS", 20, int,
         "NumericsGuard: accepted readings before the spike detector arms "
         "(early-training loss is legitimately wild).")
register("MXNET_NUMERICS_EWMA_ALPHA", 0.05, float,
         "NumericsGuard: EWMA smoothing factor for the loss/grad-norm "
         "mean/variance band.")
register("MXNET_NUMERICS_MAX_RECOVERIES", 4, int,
         "NumericsGuard: exclusion-replay attempts per window before the "
         "guard gives up (raises NumericsError, or rewinds under "
         "policy=auto with a CheckpointManager attached).")
register("MXNET_NUMERICS_QUARANTINE_DIR", "", str,
         "NumericsGuard: directory where quarantined batches are dumped "
         "(npz + json fingerprint/position metadata) for postmortem; empty "
         "disables the dump (positional exclusion still happens).")
register("MXNET_SDC_CHECK_EVERY_N", 0, int,
         "NumericsGuard SDC screening: steps between window re-executions "
         "(restore snapshot, replay retained batches with their exact "
         "generator states, compare parameter digests: a deterministic "
         "step makes any mismatch a silent-data-corruption suspect). 0 "
         "disables; the "
         "effective cadence rounds up to a multiple of "
         "MXNET_NUMERICS_CHECK_EVERY_N. Screening cost is one extra "
         "window of compute per cadence.")
register("MXNET_SDC_BUNDLE_DIR", "", str,
         "NumericsGuard: directory where SDC repro bundles land (pre-state "
         "+ batches + generator states + both digests; "
         "mxnet_tpu_torch/tools/replay_step.py re-executes them). Empty "
         "skips bundle writing.")

# telemetry: the profiler, the reporter, the flight recorder, memory
# attribution, the drift sentinel and the span spool
register("MXNET_PROFILER_AUTOSTART", False, bool,
         "Start the profiler at import (profiler.cc autostart parity).")
register("MXNET_TELEMETRY_DUMP_PATH", "", str,
         "When set, start a background telemetry reporter at import that "
         "writes the full metrics snapshot to this path every "
         "MXNET_TELEMETRY_DUMP_INTERVAL seconds (JSON; Prometheus text "
         "exposition if the path ends in .prom). tools/metrics_dump.py "
         "reads/watches the file while the run is live.")
register("MXNET_TELEMETRY_DUMP_INTERVAL", 10.0, float,
         "Seconds between background telemetry snapshot dumps/log lines.")
register("MXNET_FLIGHT_DIR", "", str,
         "FlightRecorder: directory where trigger-driven flight bundles "
         "(ring contents + metrics snapshot + knob/env fingerprint + "
         "thread stacks) are written, with rotation. Empty keeps the rings "
         "recording but disables automatic bundle dumps; explicit "
         "flight.dump() still works. Also arms the unhandled-exception "
         "crash hooks at import when set.")
register("MXNET_FLIGHT_SPANS", 512, int,
         "FlightRecorder: capacity of the finished-span ring buffer.")
register("MXNET_FLIGHT_EVENTS", 256, int,
         "FlightRecorder: capacity of the structured-event ring buffer "
         "(telemetry.event: breaker transitions, retries, failovers, "
         "hot-swaps, numerics anomalies, preemptions, SLO alerts).")
register("MXNET_FLIGHT_REQUESTS", 128, int,
         "FlightRecorder: capacity of the completed-serving-request ring "
         "(keyed by trace id).")
register("MXNET_FLIGHT_KEEP", 8, int,
         "FlightRecorder: newest bundles retained per directory; older "
         "flight-*.json files are rotated away after each dump.")
register("MXNET_FLIGHT_MIN_INTERVAL_S", 1.0, float,
         "FlightRecorder: per-trigger-kind dump rate limit; a re-trigger "
         "of the same kind inside the interval records the event but "
         "skips the bundle (mxtpu_flight_dumps_suppressed_total).")
register("MXNET_MEM_TRACK", True, bool,
         "Memstats: maintain the device-memory holder registry (endpoint "
         "params and staging slots / train state / KV pool) and reconcile "
         "it against torch.cuda.memory_stats(). 0 turns register() into a "
         "no-op.")
register("MXNET_MEM_HOLDERS_KEEP", 32, int,
         "Memstats: ranked holders shown in breakdown() (OOM flight "
         "bundles); the rest fold into an omitted-bytes line.")
register("MXNET_PERF_SENTINEL", True, bool,
         "Perf sentinel: feed train-step and serving-step latencies into "
         "per-stream EWMA drift detectors that fire a perf_regression "
         "flight event on sustained regression. 0 disables.")
register("MXNET_PERF_EWMA_ALPHA", 0.05, float,
         "Perf sentinel: baseline EWMA smoothing factor (the fast 'now' "
         "track uses 4x this).")
register("MXNET_PERF_REGRESSION_RATIO", 1.5, float,
         "Perf sentinel: fast-track / baseline ratio that counts as "
         "regressed; must hold for MXNET_PERF_SUSTAIN_N consecutive "
         "observations to fire.")
register("MXNET_PERF_SUSTAIN_N", 8, int,
         "Perf sentinel: consecutive over-ratio observations required "
         "before the perf_regression trigger fires (one spike never "
         "pages).")
register("MXNET_PERF_WARMUP_N", 50, int,
         "Perf sentinel: observations per stream before the detector "
         "arms — compile-time outliers and cold caches train the "
         "baseline instead of firing it.")
register("MXNET_SPAN_SPOOL_DIR", "", str,
         "Span spool: directory for per-pid append-only span JSONL files "
         "(spool-<pid>.jsonl) — the cross-process raw material "
         "tools/trace_journey.py assembles into one timeline per trace "
         "id. Empty (the default) keeps the spool in-memory only: span "
         "exits pay a bounded buffer append and no file I/O ever runs.")
register("MXNET_SPAN_SPOOL_MAX_BYTES", 8 << 20, int,
         "Span spool: size cap per spool file; exceeding it rotates the "
         "file to spool-<pid>.jsonl.1 (one generation kept) before the "
         "append. 0 disables rotation.")
register("MXNET_SPAN_SPOOL_FLUSH_N", 32, int,
         "Span spool: buffered spans per flush — the spool drains to disk "
         "in one O_APPEND write every this-many spans (and at interpreter "
         "exit), never per-span.")
register("MXNET_TRACE_ID", "", str,
         "Trace inheritance: a trace id handed to a child process at "
         "spawn (ServingPool warm restarts, loadgen --restart phases, "
         "chaos subprocesses). The child's first root span joins this "
         "trace instead of minting a fresh id, so one logical request is "
         "one journey across process boundaries. Read once per process.")
register("MXNET_DEBUG_PORT", 0, int,
         "Debug server: TCP port for the localhost HTTP introspection "
         "pages (/metricsz /healthz /statusz /tracez /flightz). 0 (the "
         "default) disables the server entirely.")
register("MXNET_DEBUG_HOST", "127.0.0.1", str,
         "Debug server: bind address. Keep it loopback unless a scrape "
         "sidecar genuinely lives off-host — the pages expose knobs and "
         "thread stacks.")
register("MXNET_FLEET_DUMP_GLOB", "", str,
         "Fleet collector: glob of telemetry snapshot JSON files "
         "(telemetry.dump() / MXNET_TELEMETRY_DUMP_PATH outputs) from "
         "sibling processes to merge into the fleet view alongside the "
         "live in-process registry.")

# ---------------------------------------------------------------------------
# flags that tune XLA in the JAX package: listed, not applicable
# ---------------------------------------------------------------------------
for _name, _default, _doc in (
        ("MXNET_JIT_CACHE_SIZE", 4096,
         "capacity of the eager per-op jax.jit executable cache"),
        ("MXNET_EXEC_BULK_EXEC_TRAIN", True,
         "op bulking, subsumed by XLA fusion"),
        ("MXNET_TRAIN_REMAT", "none",
         "jax.checkpoint policy of ParallelTrainStep"),
        ("MXNET_PRNG_IMPL", "auto", "the JAX PRNG implementation"),
        ("MXNET_FLASH_BWD_BLOCK_Q", 0,
         "q-block size of the Pallas flash-attention backward"),
        ("MXNET_FLASH_BWD_BLOCK_K", 0,
         "k-block size of the Pallas flash-attention backward")):
    register(_name, _default, doc=_doc, applicable=False)
del _name, _default, _doc
