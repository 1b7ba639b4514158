"""Watchdog (hang detection) and CircuitBreaker (graceful degradation):
the port of ``mxnet_tpu/resilience/watchdog.py``.

A :class:`Watchdog` monitor thread flags a region wrapped in
``watch(name)`` (or a gap between ``beat(name)`` calls) that outlives
``stall_s``: the count goes up and ``on_stall(name, elapsed)`` runs. The
watched call is never interrupted; the owner acts.

The :class:`CircuitBreaker` state machine::

    HEALTHY --(failures >= degraded_after)--> DEGRADED
    DEGRADED --(failures >= open_after)-----> OPEN
    OPEN --(cooldown elapsed)---------------> HALF_OPEN
    HALF_OPEN --(probe succeeds)------------> HEALTHY
    HALF_OPEN --(probe fails)---------------> OPEN
    any state --(success)-------------------> HEALTHY

``allow()`` is the admission gate (False while OPEN; a bounded number of
probes while HALF_OPEN). The serving ``InferenceServer`` keeps a breaker
per tenant behind admission and ``health()``, and a Watchdog on each
device step whose stall degrades the tenant.

Telemetry: a stall counts in ``mxtpu_watchdog_stalls_total`` (by watch
name; a watchdog's ``stalls`` is its share) and fires the
``watchdog_stall`` flight trigger while the hung thread is still hung; a
breaker's state is its ``mxtpu_circuit_state`` gauge (by scope; ``code``
reads it as of now), every transition a ``circuit_transition`` event and an
opening the ``circuit_open`` trigger.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..telemetry import flight as _flight
from ..telemetry.metrics import Baseline

__all__ = ["Watchdog", "CircuitBreaker",
           "HEALTHY", "DEGRADED", "OPEN", "HALF_OPEN"]

_STALLS = _telemetry.counter(
    "mxtpu_watchdog_stalls_total",
    "Watched regions (device steps, serving batches) that exceeded the "
    "hang threshold, by watch name.", labelnames=("name",))

_CIRCUIT = _telemetry.gauge(
    "mxtpu_circuit_state",
    "Circuit-breaker state by scope: 0 healthy, 1 degraded, 2 open, "
    "3 half_open.", labelnames=("scope",))

HEALTHY, DEGRADED, OPEN, HALF_OPEN = ("healthy", "degraded", "open",
                                      "half_open")
_STATE_CODE = {HEALTHY: 0, DEGRADED: 1, OPEN: 2, HALF_OPEN: 3}


class Watchdog:
    """Monitor thread that flags watched regions exceeding ``stall_s``.

    Usage::

        wd = Watchdog(stall_s=30.0, on_stall=lambda name, dt: ...)
        with wd.watch("serving[resnet50]"):
            run_batch(...)      # if this outlives stall_s, on_stall fires
        wd.stop()

    Each watch instance fires at most once; ``on_stall`` runs on the monitor
    thread and must not block. The monitor thread starts lazily on the first
    watch and is a daemon, so a forgotten watchdog never blocks exit.
    """

    def __init__(self, stall_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[str, float], None]] = None):
        self.stall_s = float(stall_s if stall_s is not None
                             else _config.get("MXNET_WATCHDOG_STALL_S"))
        if self.stall_s <= 0:
            raise MXNetError("stall_s must be > 0")
        cfg_poll = float(poll_s if poll_s is not None
                         else _config.get("MXNET_WATCHDOG_POLL_S"))
        # auto poll: sample each watch several times within its threshold
        self.poll_s = cfg_poll if cfg_poll > 0 else \
            min(max(self.stall_s / 4.0, 0.01), 0.25)
        self._on_stall = on_stall
        self._ids = itertools.count()
        self._active = {}       # id -> [name, start_monotonic, fired]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalls = Baseline()     # this watchdog's share, by name

    @property
    def stalls(self) -> int:
        return sum(self._stalls.as_dict().values())

    # -- the watched-region surface -----------------------------------------
    @contextmanager
    def watch(self, name: str):
        token = next(self._ids)
        with self._lock:
            self._active[token] = [name, time.monotonic(), False]
            self._ensure_thread()
        try:
            yield
        finally:
            with self._lock:
                self._active.pop(token, None)

    def beat(self, name: str = "heartbeat"):
        """Heartbeat alternative to ``watch``: re-arms a named one-shot timer;
        a gap longer than ``stall_s`` between beats counts as a stall."""
        with self._lock:
            self._active[name] = [name, time.monotonic(), False]
            self._ensure_thread()

    # -- monitor ------------------------------------------------------------
    def _ensure_thread(self):  # caller holds the lock
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="mxt-watchdog", daemon=True)
            self._thread.start()

    def _run(self):
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            fired = []
            with self._lock:
                for rec in self._active.values():
                    name, start, already = rec
                    if not already and now - start >= self.stall_s:
                        rec[2] = True
                        fired.append((name, now - start))
            for name, elapsed in fired:
                self._stalls.add(name, _STALLS.labels(name)).inc()
                # a stall is a flight trigger: the bundle captures the hung
                # thread's stack while it is still hung
                _flight.trigger("watchdog_stall", watch=name,
                                elapsed_s=round(elapsed, 3))
                cb = self._on_stall
                if cb is not None:
                    try:
                        cb(name, elapsed)
                    except Exception:
                        pass        # a broken callback must not kill the monitor

    def stop(self):
        # take the lock: a beat()/watch() racing this stop could otherwise
        # resurrect the monitor via _ensure_thread between the event set and
        # the handle clear, leaving a live thread with no handle to join
        with self._lock:
            self._stop.set()
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=self.poll_s * 4 + 1.0)


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probing.

    ``allow()`` is the admission gate (False = shed the request),
    ``record_success()``/``record_failure()`` are the outcome feed, and
    ``state()`` reads the current state (performing the time-based
    OPEN -> HALF_OPEN transition). ``force_degraded()`` is the watchdog's
    lever: a detected stall degrades the circuit without waiting for the
    hung call to return an error.
    """

    def __init__(self, scope: str = "server",
                 degraded_after: Optional[int] = None,
                 open_after: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 half_open_probes: int = 1,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        g = _config.get
        self.scope = scope
        self.degraded_after = int(degraded_after if degraded_after is not None
                                  else g("MXNET_CIRCUIT_DEGRADED_AFTER"))
        self.open_after = int(open_after if open_after is not None
                              else g("MXNET_CIRCUIT_OPEN_AFTER"))
        if not 0 < self.degraded_after <= self.open_after:
            raise MXNetError("need 0 < degraded_after <= open_after")
        self.cooldown_s = float(cooldown_s if cooldown_s is not None
                                else g("MXNET_CIRCUIT_COOLDOWN_S"))
        self.half_open_probes = int(half_open_probes)
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._failures = 0          # consecutive
        self._opened_at = 0.0
        self._probes = 0            # in flight while HALF_OPEN
        self._gauge = _CIRCUIT.labels(scope)
        self._gauge.set(0)
        self.transitions = []       # recent (old, new) pairs, bounded

    # -- internals (caller holds the lock) ----------------------------------
    def _set(self, new: str):
        old = self._state
        if old == new:
            return
        self._state = new
        self._gauge.set(_STATE_CODE[new])
        self.transitions.append((old, new))
        del self.transitions[:-16]
        _telemetry.event("circuit_transition", scope=self.scope,
                         old=old, new=new)
        if new == OPEN:
            # a circuit opening means a tenant just lost admission: dump
            # the last seconds of spans and events while they are in-ring
            _flight.trigger("circuit_open", scope=self.scope,
                            failures=self._failures)
        if self._on_transition is not None:
            try:
                self._on_transition(old, new)
            except Exception:
                pass

    def _tick(self):
        if self._state == OPEN and \
                time.monotonic() - self._opened_at >= self.cooldown_s:
            self._probes = 0
            self._set(HALF_OPEN)

    # -- public surface -----------------------------------------------------
    @property
    def code(self) -> int:
        """The ``mxtpu_circuit_state`` gauge of this scope, after the
        cooldown's OPEN -> HALF_OPEN check: 0 healthy, 1 degraded, 2 open,
        3 half_open."""
        self.state()
        return int(self._gauge.value)

    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def allow(self) -> bool:
        """Admission gate: False while OPEN (shed), bounded probes while
        HALF_OPEN, True otherwise."""
        with self._lock:
            self._tick()
            if self._state == OPEN:
                return False
            if self._state == HALF_OPEN:
                if self._probes >= self.half_open_probes:
                    return False
                self._probes += 1
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._probes = 0
            self._set(HEALTHY)

    def record_failure(self):
        with self._lock:
            self._tick()
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.open_after:
                self._opened_at = time.monotonic()
                self._probes = 0
                self._set(OPEN)
            elif self._failures >= self.degraded_after:
                self._set(DEGRADED)

    def force_degraded(self, reason: str = ""):
        """Degrade a healthy circuit (the watchdog's stall hook)."""
        with self._lock:
            if self._state == HEALTHY:
                self._set(DEGRADED)

    def snapshot(self) -> dict:
        with self._lock:
            self._tick()
            return {"scope": self.scope, "state": self._state,
                    "consecutive_failures": self._failures,
                    "degraded_after": self.degraded_after,
                    "open_after": self.open_after,
                    "cooldown_s": self.cooldown_s,
                    "transitions": list(self.transitions)}

    def __repr__(self):
        return f"CircuitBreaker({self.scope!r}, state={self.state()!r})"
