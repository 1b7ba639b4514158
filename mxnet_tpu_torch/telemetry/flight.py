"""FlightRecorder — the black box that makes a dead process explainable
(the port of ``mxnet_tpu/telemetry/flight.py``; a bundle keeps the
reference's on-disk format, schema 2, so its ``load_bundle`` and
``tools/flight_inspect.py`` read the port's bundles).

Always-on bounded ring buffers (spans, structured events, completed serving
requests) plus a trigger-driven bundle writer: the moment something breaks —
a watchdog stall, a circuit opening, a failover, a numerics anomaly, an SDC
suspect, a preemption, an unhandled exception — the recorder atomically
writes a timestamped JSON bundle to ``MXNET_FLIGHT_DIR`` capturing the last
seconds of activity (ring contents), the full metrics snapshot, the knob/env
fingerprint, and every live thread's stack (``sys._current_frames``).
``tools/flight_inspect.py`` renders a bundle into a human timeline.

Hot-path discipline: ring appends are single ``deque.append`` calls on
bounded deques — atomic under the GIL, no lock, no allocation beyond the
entry itself — so recording rides inside the eager-dispatch overhead gate.
All the expensive work (snapshotting, JSON encoding, fsync-free atomic
rename) happens only on a trigger, rate-limited per trigger kind.

Subsystems emit structured events through ``telemetry.event(kind, **attrs)``
(record-only) or ``flight.trigger(kind, **attrs)`` (record *and* dump when a
flight directory is configured). Triggers never raise: a broken disk must
not take down the serving path it is trying to explain.

The port has no compile ledger (its ops compile nothing; the kernels' build
cache is ``cache/executable_cache.py``), so a bundle's ``compile_records``
section is always empty. The ``memstats`` section is the holder breakdown
over ``torch.cuda.memory_stats``.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from .metrics import REGISTRY

__all__ = ["FlightRecorder", "RECORDER", "event", "record_request",
           "trigger", "dump", "recent_spans", "recent_events",
           "recent_requests", "install_excepthooks", "uninstall_excepthooks",
           "list_bundles", "load_bundle"]

_EVENTS = REGISTRY.counter(
    "mxtpu_flight_events_total",
    "Structured events recorded into the flight ring, by kind "
    "(circuit_transition, retry, failover, hot_swap, numerics_anomaly, "
    "preemption, ...).",
    labelnames=("kind",))
_DUMPS = REGISTRY.counter(
    "mxtpu_flight_dumps_total",
    "Flight bundles written, by trigger kind.",
    labelnames=("trigger",))
_SUPPRESSED = REGISTRY.counter(
    "mxtpu_flight_dumps_suppressed_total",
    "Trigger dumps suppressed by the per-kind MXNET_FLIGHT_MIN_INTERVAL_S "
    "rate limit (the event is still recorded in the ring).")

_SCHEMA = 2   # 2: + compile_records / memstats sections (perf observability)
_JSONABLE = (str, int, float, bool, type(None))


def _cfg(name, default):
    """Read a knob through the port's config, tolerating the partially
    initialized package (telemetry can be imported before
    ``mxnet_tpu_torch.config`` is bound during package init)."""
    try:
        from .. import config
    except ImportError:
        return default
    return config.get(name)


def _knobs() -> Dict:
    """Every flag the port reads, with its current value."""
    from .. import config
    from ..base import MXNetError
    out = {}
    for name in config.list_flags():
        try:
            out[name] = config.get(name)
        except MXNetError:        # listed but not applicable in the port
            continue
    return out


def _clean_attrs(attrs: Dict) -> Dict:
    """Attrs are small JSON-able values; anything else renders as repr so a
    bundle never fails to serialize."""
    out = {}
    for k, v in attrs.items():
        out[str(k)] = v if isinstance(v, _JSONABLE) else repr(v)
    return out


def _span_entry(s) -> Dict:
    return {
        "name": s.name,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "t0_us": s.t0_us,
        "dur_us": s.dur_us,
        "attrs": _clean_attrs(s.attrs) if s.attrs else {},
    }


def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        stacks[f"{name} ({ident})"] = traceback.format_stack(frame)
    return stacks


class FlightRecorder:
    """Bounded recorder + trigger-driven bundle writer.

    Ring capacities are fixed at construction (knob-driven for the process
    RECORDER); ``directory`` / ``keep`` / ``min_interval_s`` re-read their
    knobs on every use when not pinned, so ``config.set`` takes effect on
    the live recorder.
    """

    def __init__(self, span_capacity: Optional[int] = None,
                 event_capacity: Optional[int] = None,
                 request_capacity: Optional[int] = None,
                 directory: Optional[str] = None,
                 keep: Optional[int] = None,
                 min_interval_s: Optional[float] = None):
        spans = span_capacity if span_capacity is not None else \
            int(_cfg("MXNET_FLIGHT_SPANS", 512))
        events = event_capacity if event_capacity is not None else \
            int(_cfg("MXNET_FLIGHT_EVENTS", 256))
        requests = request_capacity if request_capacity is not None else \
            int(_cfg("MXNET_FLIGHT_REQUESTS", 128))
        self._spans: deque = deque(maxlen=max(1, spans))
        self._events: deque = deque(maxlen=max(1, events))
        self._requests: deque = deque(maxlen=max(1, requests))
        self._directory = directory
        self._keep = keep
        self._min_interval_s = min_interval_s
        self._dump_lock = threading.Lock()
        self._last_dump: Dict[str, float] = {}
        self._seq = itertools.count()
        self.bundles_written: List[str] = []

    # -- knob-backed settings ----------------------------------------------
    @property
    def directory(self) -> str:
        if self._directory is not None:
            return self._directory
        return str(_cfg("MXNET_FLIGHT_DIR", "") or "")

    @property
    def keep(self) -> int:
        if self._keep is not None:
            return self._keep
        return int(_cfg("MXNET_FLIGHT_KEEP", 8))

    @property
    def min_interval_s(self) -> float:
        if self._min_interval_s is not None:
            return self._min_interval_s
        return float(_cfg("MXNET_FLIGHT_MIN_INTERVAL_S", 1.0))

    # -- hot-path recording (GIL-atomic deque appends, no locks) -----------
    def record_span(self, s):
        self._spans.append(s)

    def record_event(self, kind: str, attrs: Dict) -> Dict:
        entry = {"ts": time.time(), "kind": str(kind),
                 "attrs": _clean_attrs(attrs)}
        self._events.append(entry)
        _EVENTS.labels(kind).inc()
        return entry

    def record_request(self, trace_id: str, endpoint: str, latency_us: float,
                       rows: int = 0, ok: bool = True, **attrs):
        entry = {"ts": time.time(), "trace_id": trace_id,
                 "endpoint": endpoint, "latency_us": float(latency_us),
                 "rows": int(rows), "ok": bool(ok)}
        if attrs:
            entry.update(_clean_attrs(attrs))
        self._requests.append(entry)

    # -- ring introspection -------------------------------------------------
    def recent_spans(self) -> List[Dict]:
        return [_span_entry(s) for s in list(self._spans)]

    def recent_events(self) -> List[Dict]:
        return list(self._events)

    def recent_requests(self) -> List[Dict]:
        return list(self._requests)

    def clear(self):
        self._spans.clear()
        self._events.clear()
        self._requests.clear()

    def reset_rate_limit(self):
        """Forget per-kind dump timestamps (chaos harnesses run scenarios
        back-to-back and each must be able to dump immediately)."""
        with self._dump_lock:
            self._last_dump.clear()

    # -- triggers & bundles -------------------------------------------------
    def trigger(self, kind: str, /, **attrs) -> Optional[str]:
        """Record ``kind`` as an event and, when a flight directory is
        configured, write a bundle (rate-limited per kind). Never raises;
        returns the bundle path or None."""
        try:
            self.record_event(kind, attrs)
            if not self.directory:
                return None
            now = time.monotonic()
            with self._dump_lock:
                last = self._last_dump.get(kind)
                if last is not None and now - last < self.min_interval_s:
                    _SUPPRESSED.inc()
                    return None
                self._last_dump[kind] = now
            return self.dump(trigger=kind, attrs=attrs)
        except Exception:
            return None

    def bundle(self, trigger: str = "manual",
               attrs: Optional[Dict] = None) -> Dict:
        """Everything an on-call human needs, as one JSON-able dict."""
        try:
            knobs = _knobs()
        except Exception:
            knobs = {}
        env = {k: v for k, v in os.environ.items()
               if k.startswith(("MXNET_", "CUDA_", "TORCH_", "PYTORCH_",
                                "NCCL_"))}
        compile_records, compile_summary = [], {}
        try:
            from . import memstats as _memstats
            mem = _memstats.breakdown()
        except Exception:
            mem = {}
        return {
            "schema": _SCHEMA,
            "ts": time.time(),
            "trigger": {"kind": str(trigger),
                        "attrs": _clean_attrs(attrs or {})},
            "spans": self.recent_spans(),
            "events": self.recent_events(),
            "requests": self.recent_requests(),
            "metrics": REGISTRY.snapshot(),
            "compile_records": {"summary": compile_summary,
                                "records": compile_records},
            "memstats": mem,
            "config": knobs,
            "fingerprint": {
                "pid": os.getpid(),
                "argv": list(sys.argv),
                "python": sys.version.split()[0],
                "platform": sys.platform,
                "env": env,
            },
            "threads": _thread_stacks(),
        }

    def dump(self, path: Optional[str] = None, trigger: str = "manual",
             attrs: Optional[Dict] = None) -> str:
        """Write a bundle atomically (tmp + rename) and rotate old bundles.
        With no explicit ``path`` the bundle lands in ``directory`` (or the
        cwd when no flight directory is configured)."""
        payload = json.dumps(self.bundle(trigger, attrs), indent=1,
                             sort_keys=True, default=repr)
        with self._dump_lock:
            if path is None:
                d = self.directory or "."
                os.makedirs(d, exist_ok=True)
                slug = "".join(c if c.isalnum() or c in "_-" else "_"
                               for c in str(trigger)) or "manual"
                stamp = time.strftime("%Y%m%d-%H%M%S")
                path = os.path.join(
                    d, f"flight-{stamp}-{next(self._seq):04d}-{slug}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            # _dump_lock exists solely to serialize bundle IO + rotation
            # (the ring-buffer lock is separate and stays free): blocking
            # here only queues other dumpers, which is its purpose
            with open(tmp, "w") as f:  # mxlint: disable=CONC202
                f.write(payload)
            os.replace(tmp, path)
            self.bundles_written.append(path)
            self._rotate(os.path.dirname(path) or ".")
        _DUMPS.labels(trigger).inc()
        return path

    def _rotate(self, d: str):  # mxlint: disable=CONC200
        """Keep the newest ``keep`` bundles in ``d`` (caller holds
        ``_dump_lock``)."""
        keep = self.keep
        if keep <= 0:
            return
        try:
            bundles = list_bundles(d)
        except OSError:
            return
        for stale in bundles[:-keep]:
            try:
                os.remove(stale)
            except OSError:
                pass


def list_bundles(d: str) -> List[str]:
    """Flight bundle paths in ``d``, oldest first (name-sorted: the
    timestamp+sequence filename makes that write order)."""
    if not d or not os.path.isdir(d):
        return []
    return sorted(
        os.path.join(d, f) for f in os.listdir(d)
        if f.startswith("flight-") and f.endswith(".json"))


def load_bundle(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


# the process-wide recorder: tracing and the serving/resilience layers feed it
RECORDER = FlightRecorder()


# -- module-level conveniences (the API subsystems call) -----------------------

def event(kind: str, /, **attrs) -> Dict:
    """Record a structured event into the flight ring (and bump
    ``mxtpu_flight_events_total{kind=...}``). Cheap and always on."""
    return RECORDER.record_event(kind, attrs)


def record_request(trace_id: str, endpoint: str, latency_us: float,
                   rows: int = 0, ok: bool = True, **attrs):
    RECORDER.record_request(trace_id, endpoint, latency_us, rows=rows,
                            ok=ok, **attrs)


def trigger(kind: str, /, **attrs) -> Optional[str]:
    return RECORDER.trigger(kind, **attrs)


def dump(path: Optional[str] = None, trigger: str = "manual",
         **attrs) -> str:
    return RECORDER.dump(path=path, trigger=trigger, attrs=attrs)


def recent_spans() -> List[Dict]:
    return RECORDER.recent_spans()


def recent_events() -> List[Dict]:
    return RECORDER.recent_events()


def recent_requests() -> List[Dict]:
    return RECORDER.recent_requests()


# -- crash hooks ---------------------------------------------------------------

_PREV_HOOKS = None


def install_excepthooks():
    """Chain ``sys.excepthook`` and ``threading.excepthook`` so an unhandled
    exception anywhere dumps a flight bundle before the previous hook runs.
    Idempotent; undo with :func:`uninstall_excepthooks`."""
    global _PREV_HOOKS
    if _PREV_HOOKS is not None:
        return
    prev_sys, prev_thread = sys.excepthook, threading.excepthook

    def _sys_hook(tp, val, tb):
        RECORDER.trigger("unhandled_exception", error=tp.__name__,
                         message=str(val)[:500], thread="MainThread")
        prev_sys(tp, val, tb)

    def _thread_hook(args):
        if args.exc_type is not SystemExit:
            name = args.thread.name if args.thread else "?"
            RECORDER.trigger("unhandled_exception",
                             error=args.exc_type.__name__,
                             message=str(args.exc_value)[:500], thread=name)
        prev_thread(args)

    sys.excepthook = _sys_hook
    threading.excepthook = _thread_hook
    _PREV_HOOKS = (prev_sys, prev_thread)


def uninstall_excepthooks():
    global _PREV_HOOKS
    if _PREV_HOOKS is None:
        return
    sys.excepthook, threading.excepthook = _PREV_HOOKS
    _PREV_HOOKS = None


def _autostart():
    """Env-driven crash-hook installation (called once from the package's
    ``__init__``): a configured flight directory means the operator
    wants bundles on every unhandled exception."""
    if RECORDER.directory:
        install_excepthooks()
