"""Profiler frontend (the port of ``mxnet_tpu/profiler.py``; parity:
python/mxnet/profiler.py over src/profiler/profiler.h:251).

The framework layer is the reference's: the chrome://tracing JSON dump
(profiler.cc:166-239 emits "traceEvents"), the per-op aggregate stats table
(aggregate_stats.cc) for scopes recorded via profiler.scope()/Task/Frame
markers, op dispatch and telemetry spans, counters, markers and the
continuous dump.

Where the reference starts ``jax.profiler`` (XPlane traces) under
``set_config(profile_all=True)``, the port starts a ``torch.profiler``
session with CPU and (on a card) CUDA activities; ``stop()`` exports it as
a chrome trace, ``trace.json`` in a temporary directory
(``_STATE["torch_dir"]``, the counterpart of ``jax_dir``), whose device
events are the kernels the card ran, K1 among them. The session keeps its
events in memory until then: keep it short. Scopes and op dispatch are
``torch.profiler.record_function`` ranges, so the torch trace nests the
kernels under the framework's names.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

_STATE = {
    "config": {"profile_all": False, "filename": "profile.json",
               "aggregate_stats": False, "continuous_dump": False},
    "running": False,
    "events": [],          # chrome trace events from framework scopes
    "agg": {},             # name -> [count, total_us, min_us, max_us]
    "torch_dir": None,     # where stop() exports the torch session's trace
    "torch_session": None,
    "lock": threading.Lock(),
    "continuous_path": None,   # open incremental-dump target (continuous_dump)
}


def set_config(profile_all=False, filename="profile.json", aggregate_stats=False,
               profile_symbolic=True, profile_imperative=True, profile_memory=True,
               profile_api=True, continuous_dump=False, **kwargs):
    _STATE["config"].update(profile_all=profile_all, filename=filename,
                            aggregate_stats=aggregate_stats,
                            continuous_dump=continuous_dump)
    if not continuous_dump:
        _STATE["continuous_path"] = None


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


def start(profile_process="worker"):
    _STATE["running"] = True
    cfg = _STATE["config"]
    if cfg.get("profile_all") and _STATE["torch_session"] is None:
        import tempfile
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        session = profile(activities=activities)
        session.start()
        _STATE["torch_session"] = session
        _STATE["torch_dir"] = tempfile.mkdtemp(prefix="mxtpu_torch_trace_")


def stop(profile_process="worker"):
    session = _STATE["torch_session"]
    if session is not None:
        _STATE["torch_session"] = None
        session.stop()
        session.export_chrome_trace(torch_trace_path())
    _STATE["running"] = False


def torch_trace_path() -> Optional[str]:
    """The chrome trace the last ``profile_all`` session exported at
    ``stop()`` (None before one ran)."""
    d = _STATE["torch_dir"]
    return os.path.join(d, "trace.json") if d else None


def pause(profile_process="worker"):
    _STATE["running"] = False


def resume(profile_process="worker"):
    _STATE["running"] = True


def dump(finished=True, profile_process="worker"):
    """Write chrome://tracing JSON (profiler.cc:184 'traceEvents' format).

    With ``set_config(continuous_dump=True)`` the dump is *incremental*:
    events accumulated since the previous dump are appended to the file (the
    chrome JSON Array Format — a ``[``-opened event list that tracing UIs
    accept without a closing bracket) and cleared from memory, so long runs
    can dump periodically without unbounded event growth. ``finished=True``
    closes the array, making the file strict JSON; the next dump then starts
    the file over."""
    cfg = _STATE["config"]
    path = cfg["filename"]
    if not cfg.get("continuous_dump"):
        with _STATE["lock"]:
            trace = {"traceEvents": list(_STATE["events"]),
                     "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(trace, f)
        return
    with _STATE["lock"]:
        events = list(_STATE["events"])
        _STATE["events"].clear()
        fresh = _STATE["continuous_path"] != path
        if fresh:
            _STATE["continuous_path"] = path
        if finished:
            _STATE["continuous_path"] = None
    mode = "w" if fresh else "a"
    with open(path, mode) as f:
        if fresh:
            f.write("[\n")
        for ev in events:
            f.write(json.dumps(ev) + ",\n")
        if finished:
            f.write("{}]\n")   # sentinel closes the trailing comma -> strict JSON


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Aggregate per-scope stats (aggregate_stats.cc analog).

    ``format="table"`` (default) returns the fixed-width text table;
    ``format="json"`` returns the same aggregate as a JSON object string:
    ``{name: {count, total_us, min_us, max_us, avg_us}}`` (the
    machine-readable face tools/parse_log.py-style consumers want)."""
    if format not in ("table", "json"):
        raise ValueError(f"format must be 'table' or 'json', got {format!r}")
    with _STATE["lock"]:
        rows = [(name, c, tot, mn, mx, tot / max(c, 1))
                for name, (c, tot, mn, mx) in _STATE["agg"].items()]
        if reset:
            _STATE["agg"].clear()
    rows.sort(key=lambda r: r[2], reverse=not ascending)
    if format == "json":
        return json.dumps({name: {"count": c, "total_us": tot, "min_us": mn,
                                  "max_us": mx, "avg_us": avg}
                           for name, c, tot, mn, mx, avg in rows})
    lines = [f"{'Name':<48}{'Calls':>8}{'Total(us)':>14}{'Min(us)':>12}"
             f"{'Max(us)':>12}{'Avg(us)':>12}"]
    for name, c, tot, mn, mx, avg in rows:
        lines.append(f"{name:<48}{c:>8}{tot:>14.1f}{mn:>12.1f}{mx:>12.1f}{avg:>12.1f}")
    return "\n".join(lines)


def _record(name, cat, t0_us, dur_us, args=None):
    ev = {"name": name, "cat": cat, "ph": "X", "ts": t0_us, "dur": dur_us,
          "pid": 0, "tid": threading.get_ident() % 100000}
    if args:
        ev["args"] = args
    with _STATE["lock"]:
        _STATE["events"].append(ev)
        agg = _STATE["agg"].setdefault(name, [0, 0.0, float("inf"), 0.0])
        agg[0] += 1
        agg[1] += dur_us
        agg[2] = min(agg[2], dur_us)
        agg[3] = max(agg[3], dur_us)


def _dispatch_profiled(name, thunk, cat="operator"):
    """Run ``thunk`` as one recorded per-op event (shared by op dispatch,
    hybridized blocks, ParallelTrainStep and the serving worker — the
    ProfileOperator-per-engine-op analog, src/profiler/profiler.h:251).
    Records the host dispatch duration and scopes the device work with a
    ``record_function`` range so the torch trace attributes its kernels."""
    from torch.profiler import record_function
    t0 = time.perf_counter_ns() // 1000
    with record_function(name):
        out = thunk()
    _record(name, cat, t0, time.perf_counter_ns() // 1000 - t0)
    return out


def record_duration(name, t0_us, dur_us, cat="operator"):
    """Record an externally-timed duration event (e.g. a serving batch step
    or request latency measured by its own clock) into the chrome trace and
    aggregate table. No-op unless the profiler is running; timestamps must be
    perf_counter-based microseconds to land coherently in the trace."""
    if _STATE["running"]:
        _record(name, cat, t0_us, dur_us)


@contextmanager
def scope(name: str, cat: str = "operator"):
    """Profile a code region; also opens a ``record_function`` range so the
    region shows up around its kernels in the torch trace."""
    from torch.profiler import record_function
    t0 = time.perf_counter_ns() // 1000
    with record_function(name):
        yield
    if _STATE["running"]:
        _record(name, cat, t0, time.perf_counter_ns() // 1000 - t0)


class Task:
    """Named task marker (profiler.py Task parity)."""

    def __init__(self, name, domain=None):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter_ns() // 1000

    def stop(self):
        if self._t0 is not None and _STATE["running"]:
            _record(self.name, "task", self._t0,
                    time.perf_counter_ns() // 1000 - self._t0)


Frame = Task
Event = Task


class Counter:
    """Chrome-trace counter track. increment/decrement are atomic: the
    read-modify-write of ``value`` AND its event emission happen under one
    ``_STATE["lock"]`` acquisition, so concurrent bumps can neither lose
    updates nor emit out-of-order counter samples (pre-r7 the RMW ran
    outside the lock and concurrent increments dropped counts)."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value

    def _set_and_emit_locked(self, value):
        # caller holds _STATE["lock"]
        self.value = value
        if _STATE["running"]:
            _STATE["events"].append({"name": self.name, "ph": "C",
                                     "ts": time.perf_counter_ns() // 1000,
                                     "pid": 0, "args": {"value": value}})

    def set_value(self, value):
        with _STATE["lock"]:
            self._set_and_emit_locked(value)

    def increment(self, delta=1):
        with _STATE["lock"]:
            self._set_and_emit_locked(self.value + delta)

    def decrement(self, delta=1):
        with _STATE["lock"]:
            self._set_and_emit_locked(self.value - delta)


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        if _STATE["running"]:
            with _STATE["lock"]:
                _STATE["events"].append({"name": self.name, "ph": "i",
                                         "ts": time.perf_counter_ns() // 1000,
                                         "pid": 0, "s": "p"})


def profiler_set_config(**kwargs):
    set_config(**kwargs)


def profiler_set_state(state):
    set_state(state)
