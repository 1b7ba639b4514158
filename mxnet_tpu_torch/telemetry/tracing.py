"""Structured span tracing with cross-layer trace-id propagation (the port
of ``mxnet_tpu/telemetry/tracing.py``; the spool's lines are the
reference's, so its ``read_spool``/``journey`` and
``tools/trace_journey.py`` read the port's spool files).

``telemetry.span(name, **attrs)`` opens a nested, timed span:

  - spans nest via a contextvar; a child inherits its parent's ``trace_id``
    so one logical operation (a serving request, a training step) is one
    trace across layers, even when the layers are different subsystems.
  - a span can be *adopted* across threads by passing an explicit
    ``trace_id=...`` — the serving path stamps each admitted request with
    the submitter's trace id, and the worker thread re-opens the trace
    around batch assembly and the compiled device step, so a request's
    trace id survives the queue hop.
  - on exit every span feeds BOTH sinks: the profiler's chrome-trace event
    stream (when a profiler session is running — the span lands in the same
    ``traceEvents`` timeline as per-op events, with the trace id in
    ``args``; the session's torch trace holds the device kernels), and the
    registry's ``mxtpu_span_duration_us{name=...}`` histogram (always on —
    spans are the latency series dashboards scrape).

Span names are dot-scoped ``layer.operation`` (``serving.batch``,
``train.step``, ``dataloader.wait`` — see OBSERVABILITY.md for the
convention); attrs are small JSON-able values, never tensors. A span's duration is host
time: recording one never waits for the card.

Cross-process journeys (the fleet plane): every finished span also lands in
a bounded in-memory spool buffer; when ``MXNET_SPAN_SPOOL_DIR`` is set the
buffer drains — every ``MXNET_SPAN_SPOOL_FLUSH_N`` spans, and at interpreter
exit — into an append-only per-pid JSONL file (``spool-<pid>.jsonl``, the
compile-ledger file pattern: one ``O_APPEND`` write per batch, size-capped
and rotated). Each line carries the pid and a wall-clock anchor, so
``tools/trace_journey.py`` can assemble one ordered timeline for a trace id
across every process that touched it. A child process inherits its parent's
trace via the ``MXNET_TRACE_ID`` env knob: the first *root* span of the
process adopts it instead of minting a fresh id.
"""
from __future__ import annotations

import atexit
import contextvars
import json
import os
import random
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from .metrics import REGISTRY
from .flight import RECORDER as _FLIGHT_RECORDER, _clean_attrs

__all__ = ["Span", "span", "current_span", "current_trace_id",
           "new_trace_id", "spool_flush", "spool_path", "read_spool",
           "journey"]

# pre-bound deque.append: the flight span ring rides every span exit, so the
# hot path pays one bounded-deque append (GIL-atomic) and nothing else
_record_flight_span = _FLIGHT_RECORDER._spans.append

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "mxtpu_current_span", default=None)

# per-process random source; seeded from urandom, independent of user PRNGs
_RNG = random.Random()
_SPAN_DURATION = REGISTRY.histogram(
    "mxtpu_span_duration_us",
    "Duration of telemetry spans by span name (microseconds).",
    labelnames=("name",))


def new_trace_id() -> str:
    return f"{_RNG.getrandbits(64):016x}"


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


def _cfg(name, default):
    """Knob read tolerating the partially initialized package (tracing can be
    imported before the port's ``config`` is bound during package init)."""
    try:
        from .. import config
    except ImportError:
        return default
    return config.get(name)


# the port's profiler module, looked up by name so tracing never imports it
_PROFILER_MODULE = __name__.rpartition(".telemetry")[0] + ".profiler"


# -- cross-process trace inheritance ------------------------------------------
# Resolved once per process: MXNET_TRACE_ID is the parent's trace id handed
# to a child at spawn (env), so the child's first root span joins the
# parent's journey instead of minting a fresh id.
_INHERITED_TRACE: Optional[str] = None
_INHERITED_RESOLVED = False


def _inherited_trace_id() -> Optional[str]:
    global _INHERITED_TRACE, _INHERITED_RESOLVED
    if not _INHERITED_RESOLVED:
        _INHERITED_TRACE = str(_cfg("MXNET_TRACE_ID", "") or "") or None
        _INHERITED_RESOLVED = True
    return _INHERITED_TRACE


class Span:
    """One timed region. Created by :func:`span`; read-only for users."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "t0_us", "dur_us")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{_RNG.getrandbits(64):016x}"
        self.parent_id = parent_id
        self.attrs = attrs
        self.t0_us = _now_us()
        self.dur_us = None

    def __repr__(self):
        return (f"<Span {self.name} trace={self.trace_id} "
                f"dur={self.dur_us}us attrs={self.attrs}>")


@contextmanager
def span(name: str, trace_id: Optional[str] = None, **attrs):
    """Open a nested span. ``trace_id`` adopts an existing trace (cross-thread
    propagation); otherwise the parent's trace is inherited, or a fresh trace
    is started at the root. Yields the Span (``.trace_id`` is the handle to
    stamp onto queue items / requests for later adoption)."""
    parent = _CURRENT.get()
    if trace_id is None:
        if parent is not None:
            trace_id = parent.trace_id
        else:
            trace_id = _inherited_trace_id() or new_trace_id()
    s = Span(name, trace_id, parent.span_id if parent is not None else None,
             attrs)
    token = _CURRENT.set(s)
    try:
        yield s
    finally:
        _CURRENT.reset(token)
        s.dur_us = _now_us() - s.t0_us
        _SPAN_DURATION.labels(name).observe(s.dur_us)
        _record_flight_span(s)
        _record_spool_span(s)
        if len(_SPOOL_BUF) >= _SPOOL_FLUSH_N:
            spool_flush()
        _emit_profiler(s)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    s = _CURRENT.get()
    return s.trace_id if s is not None else None


# -- per-pid span spool (the fleet plane's raw material) ----------------------
#
# Hot-path discipline mirrors the flight ring: every span exit pays one
# bounded-deque append; file I/O happens only on a flush (every
# MXNET_SPAN_SPOOL_FLUSH_N spans, or at exit), and only when a spool
# directory is configured. With no directory the flush is a buffer clear.

_SPOOL_BUF: deque = deque(maxlen=2048)  # bounded: backlog drops oldest
_record_spool_span = _SPOOL_BUF.append
_SPOOL_LOCK = threading.Lock()
_SPOOL_FLUSH_N = 32          # refreshed from its knob at every flush
# perf_counter -> wall-clock anchor: spans are timed on the monotonic clock
# (in-proc ordering), but cross-process assembly needs wall time
_WALL_ANCHOR_S = time.time() - time.perf_counter()

_SPOOL_SPANS = REGISTRY.counter(
    "mxtpu_span_spool_spans_total",
    "Spans spilled to the per-pid spool file under MXNET_SPAN_SPOOL_DIR.")
_SPOOL_ROTATIONS = REGISTRY.counter(
    "mxtpu_span_spool_rotations_total",
    "Spool-file rotations forced by the MXNET_SPAN_SPOOL_MAX_BYTES size cap.")


def spool_path(d: Optional[str] = None) -> str:
    """This process's spool file ('' when no spool directory is set)."""
    d = d if d is not None else str(_cfg("MXNET_SPAN_SPOOL_DIR", "") or "")
    return os.path.join(d, f"spool-{os.getpid()}.jsonl") if d else ""


def _spool_line(s: Span) -> Dict:
    return {
        "pid": os.getpid(),
        "name": s.name,
        "trace_id": s.trace_id,
        "span_id": s.span_id,
        "parent_id": s.parent_id,
        "t0_wall": round(_WALL_ANCHOR_S + s.t0_us / 1e6, 6),
        "dur_us": s.dur_us,
        "attrs": _clean_attrs(s.attrs) if s.attrs else {},
    }


def spool_flush():
    """Drain the buffered spans into ``spool-<pid>.jsonl`` (one ``O_APPEND``
    write for the whole batch; atomic line appends even with several
    processes sharing the directory). Rotates the file to ``.1`` when it
    would exceed ``MXNET_SPAN_SPOOL_MAX_BYTES``. Never raises — a broken
    disk must not take down the span it is trying to record."""
    global _SPOOL_FLUSH_N
    try:
        _SPOOL_FLUSH_N = max(1, int(_cfg("MXNET_SPAN_SPOOL_FLUSH_N", 32)))
    except Exception:
        pass
    with _SPOOL_LOCK:
        if not _SPOOL_BUF:
            return
        batch = list(_SPOOL_BUF)
        _SPOOL_BUF.clear()
        path = spool_path()
        if not path:
            return
        try:
            lines = [json.dumps(_spool_line(s), sort_keys=True) + "\n"
                     for s in batch if s.dur_us is not None]
            if not lines:
                return
            data = "".join(lines).encode("utf-8")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            cap = int(_cfg("MXNET_SPAN_SPOOL_MAX_BYTES", 8 << 20))
            try:
                if cap > 0 and os.path.getsize(path) + len(data) > cap:
                    os.replace(path, path + ".1")
                    _SPOOL_ROTATIONS.inc()
            except OSError:
                pass
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
            _SPOOL_SPANS.inc(len(lines))
        except Exception:
            pass


# short-lived children (loadgen restart phases, chaos subprocesses) must
# spill their tail before exiting, or the journey loses its last hop
atexit.register(spool_flush)


def read_spool(d: Optional[str] = None) -> List[Dict]:
    """Every span line in the spool directory — all processes, rotated
    ``.1`` files included — as dicts (file order within a file)."""
    d = d if d is not None else str(_cfg("MXNET_SPAN_SPOOL_DIR", "") or "")
    out: List[Dict] = []
    if not d or not os.path.isdir(d):
        return out
    for n in sorted(os.listdir(d)):
        if not (n.startswith("spool-") and
                (n.endswith(".jsonl") or n.endswith(".jsonl.1"))):
            continue
        try:
            with open(os.path.join(d, n)) as f:
                for line in f:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return out


def journey(trace_id: str, d: Optional[str] = None) -> List[Dict]:
    """One ordered cross-process timeline for ``trace_id``: every spooled
    span carrying that id, across every process's spool file, sorted by
    wall-clock start. The raw material of ``tools/trace_journey.py``."""
    hops = [e for e in read_spool(d) if e.get("trace_id") == trace_id]
    hops.sort(key=lambda e: (e.get("t0_wall", 0.0), e.get("dur_us") or 0))
    return hops


def _reset_spool_for_tests():
    """Forget buffered spans and the cached inherited trace id (tests that
    flip MXNET_TRACE_ID / spool knobs mid-process)."""
    global _INHERITED_RESOLVED, _INHERITED_TRACE
    with _SPOOL_LOCK:
        _SPOOL_BUF.clear()
    _INHERITED_RESOLVED = False
    _INHERITED_TRACE = None


def _emit_profiler(s: Span):
    """Mirror a finished span into the profiler's chrome trace (only when a
    session is running; module looked up lazily so telemetry never forces the
    profiler onto the import path of lightweight processes)."""
    prof = sys.modules.get(_PROFILER_MODULE)
    if prof is None or not prof._STATE["running"]:
        return
    args = {"trace_id": s.trace_id, "span_id": s.span_id}
    if s.parent_id:
        args["parent_id"] = s.parent_id
    for k, v in s.attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            args[k] = v
    prof._record(s.name, "span", s.t0_us, s.dur_us, args=args)
