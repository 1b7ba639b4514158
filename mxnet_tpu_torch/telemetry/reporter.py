"""Background reporting: periodic logger, snapshot files, device memory
(the port of ``mxnet_tpu/telemetry/reporter.py``).

``periodic_logger(interval)`` starts a daemon thread that, every ``interval``
seconds, samples device memory gauges and emits a one-line summary through
``logging`` (and optionally writes the full JSON snapshot to a file that
``tools/metrics_dump.py`` — or any sidecar scraper — can read while the run
is still going). Never waits for the card: the only device interaction is
``torch.cuda.memory_stats``, a host-side read of the caching allocator's
counters (mapped onto the reference's stat names in ``memstats``).

Auto-start: setting ``MXNET_TELEMETRY_DUMP_PATH`` makes every process start
a periodic reporter at import (interval ``MXNET_TELEMETRY_DUMP_INTERVAL``),
so long-running jobs are observable without code changes.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import threading
from typing import Optional

from .metrics import REGISTRY

__all__ = ["sample_device_memory", "periodic_logger", "PeriodicReporter",
           "dump", "summary_line"]

_LOG = logging.getLogger(__name__.rpartition(".")[0])

_DEVICE_MEMORY = REGISTRY.gauge(
    "mxtpu_device_memory_bytes",
    "Per-device memory stats from PJRT device.memory_stats() "
    "(bytes_in_use / peak_bytes_in_use / bytes_limit), sampled host-side.",
    labelnames=("device", "stat"))

_SAMPLE_STATS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                 "largest_alloc_size")


def sample_device_memory() -> int:
    """Refresh ``mxtpu_device_memory_bytes`` from every card's caching
    allocator (``gpu:<i>``; the CPU reports nothing). Returns the number of
    devices sampled. Never raises: observability must not take a training
    job down."""
    from .memstats import _device_stats
    try:
        devices = _device_stats()
    except Exception:
        return 0
    for label_dev, stats in devices.items():
        for key in _SAMPLE_STATS:
            if key in stats:
                _DEVICE_MEMORY.labels(label_dev, key).set(stats[key])
    return len(devices)


def summary_line() -> str:
    """One human-readable line of the load-bearing series (the heartbeat the
    periodic logger prints)."""
    snap = REGISTRY.snapshot()
    parts = []

    def total(name):
        fam = snap["metrics"].get(name)
        if not fam:
            return None
        return sum(s.get("value", s.get("count", 0)) for s in fam["series"])

    for label, name in (("req", "mxtpu_serving_requests_total"),
                        ("batches", "mxtpu_serving_batches_total"),
                        ("steps", "mxtpu_train_steps_total"),
                        ("jit_miss", "mxtpu_jit_cache_misses_total"),
                        ("compile_s", "mxtpu_serving_compile_seconds_total")):
        v = total(name)
        if v:
            parts.append(f"{label}={v:g}")
    spans = snap["metrics"].get("mxtpu_span_duration_us")
    if spans:
        for s in spans["series"]:
            if s["count"]:
                parts.append(f"{s['labels'].get('name', '?')}"
                             f".p50={s['p50'] / 1e3:.2f}ms")
    return "telemetry: " + (" ".join(parts) if parts else "no activity")


def dump(path: str, prometheus: bool = False):
    """Atomically write the current snapshot (JSON, or Prometheus text) to
    ``path`` — the file ``tools/metrics_dump.py`` reads."""
    payload = (REGISTRY.prometheus_text() if prometheus
               else json.dumps(REGISTRY.snapshot(), indent=1, sort_keys=True))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


class PeriodicReporter:
    """Daemon-thread reporter; ``stop()`` (or context-exit) halts it."""

    def __init__(self, interval: float = 10.0, path: Optional[str] = None,
                 logger: Optional[logging.Logger] = None,
                 prometheus: bool = False):
        if interval <= 0:
            raise ValueError("interval must be > 0")
        self.interval = float(interval)
        self.path = path
        self.prometheus = prometheus
        self._log = logger or _LOG
        self._stop = threading.Event()
        self._stopped = False
        self._stop_lock = threading.Lock()
        # interpreter exit between ticks would silently drop the final
        # interval's snapshot — atexit guarantees one last dump lands
        atexit.register(self.stop)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-telemetry-reporter")
        self._thread.start()

    def _tick(self):
        sample_device_memory()
        self._log.info("%s", summary_line())
        if self.path:
            try:
                dump(self.path, prometheus=self.prometheus)
            except OSError as e:
                self._log.warning("telemetry dump to %s failed: %s",
                                  self.path, e)

    def _run(self):
        while not self._stop.wait(self.interval):
            self._tick()

    def stop(self, final_tick: bool = True):
        """Stop the reporter; by default take one last sample/dump so the
        file on disk reflects end-of-run state. Idempotent: the atexit hook
        and an explicit stop() cannot double-tick."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        atexit.unregister(self.stop)
        self._stop.set()
        self._thread.join(timeout=self.interval + 5)
        if final_tick:
            self._tick()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def periodic_logger(interval: float = 10.0, path: Optional[str] = None,
                    logger: Optional[logging.Logger] = None,
                    prometheus: bool = False) -> PeriodicReporter:
    """Start a background reporter; returns its handle (call ``.stop()``)."""
    return PeriodicReporter(interval, path=path, logger=logger,
                            prometheus=prometheus)


def _autostart() -> Optional[PeriodicReporter]:
    """Env-driven reporter start (called once from the package's
    ``__init__``)."""
    from .. import config
    path = config.get("MXNET_TELEMETRY_DUMP_PATH")
    if not path:
        return None
    interval = config.get("MXNET_TELEMETRY_DUMP_INTERVAL")
    return periodic_logger(interval, path=path,
                           prometheus=path.endswith(".prom"))
