"""SLO-driven autoscaler over a replica pool of InferenceServers (the port
of ``mxnet_tpu/serving/autoscaler.py``).

**ServingPool** owns replicas built by ``replica_factory(replica_id)``
(each an InferenceServer with its endpoints registered). ``submit`` routes
to the least-loaded replica in rotation (queued requests over capacity);
a replica that sheds (overload, mid-cutover close) falls through to the
next before the client sees an error. A replica leaves rotation before it
drains, so scale-down drops no admitted request. With hedging
(``MXNET_HEDGE_ENABLE``, two or more replicas) a request still pending
after the tail guard's hedge delay is duplicated onto the next replica;
the first response settles the client's Future and the loser is cancelled
(dropped at batch assembly).

**Autoscaler** polls every ``MXNET_AUTOSCALE_POLL_S``: the worst fast-window
burn rate and the active alerts across the SLO monitor's objectives, and
the pool's queue pressure (worst endpoint's pending rows over its bound,
averaged over replicas). Over pressure (an alert, fast burn at the
monitor's threshold, or pressure at ``MXNET_AUTOSCALE_QUEUE_HIGH``) on
``MXNET_AUTOSCALE_UP_N`` consecutive polls scales up by one; idleness (no
alert, burn under 1, pressure at most ``MXNET_AUTOSCALE_QUEUE_LOW``) on
``MXNET_AUTOSCALE_DOWN_N`` consecutive polls scales down by one, through
the bounded drain. Every action respects ``MXNET_AUTOSCALE_{MIN,MAX}_
REPLICAS`` and ``MXNET_AUTOSCALE_COOLDOWN_S`` and is kept in ``actions``
with the signals that justified it. ``tick(now)`` is the whole loop body,
deterministic for tests; the brownout ladder ticks with it.

The reference prices a fresh replica's warm-up with its learned compile
cost model (StableHLO); the port has none, so ``predicted_warmup_s`` is 0
and the scale-up hysteresis is the configured one.

Telemetry: ``mxtpu_autoscale_replicas`` is the rotation's size,
``mxtpu_pool_replica_capacity`` each replica's devices (by replica id),
and every action counts in ``mxtpu_autoscale_events_total`` (by
direction) and records an ``autoscale_up``/``autoscale_down`` flight event
naming its signals.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Callable, List, Optional, Tuple

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..resilience import faults as _faults
from ..telemetry import debug_server as _debug
from ..telemetry import flight as _flight
from ..telemetry.slo import MONITOR as _SLO_MONITOR
from . import tailguard as _tailguard
from .batcher import fail as _fail_fut, now_us, resolve as _resolve_fut
from .errors import ServerClosedError, ServerOverloadError
from .server import InferenceServer

__all__ = ["ServingPool", "Autoscaler"]

_REPLICAS_G = _telemetry.gauge(
    "mxtpu_autoscale_replicas",
    "Serving replicas currently in the pool's rotation.")
_EVENTS = _telemetry.counter(
    "mxtpu_autoscale_events_total",
    "Autoscaler actions taken, by direction (up / down).",
    labelnames=("direction",))
_CAPACITY_G = _telemetry.gauge(
    "mxtpu_pool_replica_capacity",
    "Devices backing each pool replica (a mesh-sharded replica reports its "
    "slice size; single-chip replicas report 1) — the weight submit() "
    "divides queue load by.",
    labelnames=("rid",))

log = logging.getLogger("mxnet_tpu_torch.serving.autoscaler")


class _Replica:
    __slots__ = ("rid", "server", "capacity")

    def __init__(self, rid: int, server: InferenceServer, capacity: int = 1):
        self.rid = rid
        self.server = server
        self.capacity = max(int(capacity), 1)


class ServingPool:
    """A replica set of InferenceServers behind one ``submit``.

    Parameters
    ----------
    replica_factory : callable
        ``replica_factory(replica_id) -> InferenceServer`` builds one
        replica with its endpoints registered; the pool starts it if the
        factory did not.
    initial_replicas : int
        Replicas built at once (default 1).
    """

    def __init__(self, replica_factory: Callable[[int], InferenceServer],
                 initial_replicas: int = 1):
        self._factory = replica_factory
        self._lock = threading.Lock()
        self._replicas: List[_Replica] = []
        self._next_rid = 0
        _debug.attach_pool(self)      # weak: /statusz + /fleetz render us
        for _ in range(max(int(initial_replicas), 0)):
            self.scale_up()

    # ------------------------------------------------------------------
    # elasticity
    # ------------------------------------------------------------------
    def scale_up(self) -> int:
        """Build, start and put one replica in rotation; returns its id.
        The factory and warm-up run outside the pool lock, so traffic keeps
        flowing to the others."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        server = self._factory(rid)
        if server.state != "running":
            server.start()
        with server._cond:
            capacity = max((getattr(t.endpoint, "capacity", 1)
                            for t in server._router.tenants()), default=1)
        with self._lock:
            self._replicas.append(_Replica(rid, server, capacity))
            n = len(self._replicas)
        _REPLICAS_G.set(n)
        _CAPACITY_G.labels(str(rid)).set(capacity)
        return rid

    def scale_down(self, drain_timeout_s: Optional[float] = None
                   ) -> Optional[int]:
        """Take the newest replica out of rotation, then drain it: every
        admitted request completes while new traffic goes elsewhere.
        Returns its id, or None at one replica (the last never drains)."""
        with self._lock:
            if len(self._replicas) <= 1:
                return None
            victim = self._replicas.pop()
            n = len(self._replicas)
        _REPLICAS_G.set(n)
        victim.server.stop(drain=True, timeout=drain_timeout_s)
        return victim.rid

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def _rotation(self) -> List[_Replica]:
        with self._lock:
            return list(self._replicas)

    def submit(self, name: str, inputs, deadline_ms: Optional[float] = None,
               deadline=None) -> Future:
        """Route one request to the least-loaded replica in rotation (a
        shedding replica falls through to the next); with hedging, a
        request still pending after the hedge delay is duplicated onto the
        next replica and the first response wins. ``deadline`` (a
        ``tailguard.Deadline``) rides into the replica's queue."""
        _faults.check("pool_submit")
        if deadline is not None:
            deadline.check("pool_submit")
        replicas = self._rotation()
        if not replicas:
            raise ServerClosedError("serving pool has no replicas")
        ranked = sorted(replicas, key=self._load_of)
        _tailguard.hedge_deposit()
        born_us = now_us()
        primary, primary_rep = self._submit_ranked(
            name, inputs, deadline_ms, deadline, ranked)
        hedge_pool = [r for r in ranked if r is not primary_rep]
        if not (_tailguard.HEDGER.enabled() and hedge_pool):
            primary.add_done_callback(
                lambda f: _tailguard.HEDGER.observe_latency(
                    now_us() - born_us))
            return primary
        return self._hedged(name, inputs, deadline_ms, deadline,
                            hedge_pool, primary, born_us)

    def _submit_ranked(self, name: str, inputs,
                       deadline_ms: Optional[float], deadline,
                       ranked: List[_Replica]) -> Tuple[Future, _Replica]:
        """Try the replicas in load order; returns the admitted Future and
        the replica that took it."""
        last_exc: Optional[Exception] = None
        for rep in ranked:
            try:
                # the span stamps this attempt's replica into the journey
                # and hands its trace id to the request submit() builds
                with _telemetry.span("pool.submit", replica=rep.rid,
                                     endpoint=name):
                    return rep.server.submit(
                        name, inputs, deadline_ms=deadline_ms,
                        deadline=deadline), rep
            except (ServerOverloadError, ServerClosedError) as e:
                last_exc = e
        raise last_exc

    def _predicted_step_us(self, name: str) -> float:
        """The Router's step-time estimate of this endpoint's next batch
        (the hedge delay's prior), 0.0 when unknown."""
        replicas = self._rotation()
        if not replicas:
            return 0.0
        srv = replicas[0].server
        with srv._cond:
            tenant = srv._router.find(name)
            return 0.0 if tenant is None else \
                float(srv._router.est_step_us(tenant))

    def _hedged(self, name: str, inputs, deadline_ms: Optional[float],
                deadline, hedge_pool: List[_Replica], primary: Future,
                born_us: int) -> Future:
        """The hedge race around an admitted primary: after the delay a
        budgeted duplicate goes to the next replica; the first successful
        arm settles the client's Future (a failed arm defers to the other
        while it is pending) and the loser is cancelled."""
        out: Future = Future()
        lock = threading.Lock()
        state = {"done": False, "hedge": None, "timer": None}

        def settle(f: Future, is_hedge: bool):
            try:
                err = f.exception()
            except CancelledError:
                return                    # the cancelled loser reporting in
            with lock:
                if state["done"]:
                    return
                other = primary if is_hedge else state["hedge"]
                if err is not None and other is not None \
                        and not other.done():
                    return                # lost by failing; the other decides
                state["done"] = True
                timer = state["timer"]
                loser = other
            if timer is not None:
                timer.cancel()
            _tailguard.HEDGER.observe_latency(now_us() - born_us)
            if is_hedge and err is None:
                _tailguard.hedge_won()
            if loser is not None:
                if loser.cancel():
                    _tailguard.hedge_cancelled()
                else:
                    _tailguard.hedge_wasted()
            if err is not None:
                _fail_fut(out, err)
            else:
                _resolve_fut(out, f.result())

        def launch_hedge():
            with lock:
                if state["done"]:
                    return
            if deadline is not None and deadline.expired():
                return                    # no budget left to speculate into
            if not _tailguard.hedge_allowed():
                return
            try:
                hf, _rep = self._submit_ranked(
                    name, inputs, deadline_ms, deadline, hedge_pool)
            except (ServerOverloadError, ServerClosedError):
                return                    # no replica would take the hedge
            _tailguard.hedge_launched()
            with lock:
                lost_race = state["done"]
                if not lost_race:
                    state["hedge"] = hf
            if lost_race:                 # the primary settled meanwhile
                if hf.cancel():
                    _tailguard.hedge_cancelled()
                else:
                    _tailguard.hedge_wasted()
                return
            hf.add_done_callback(lambda f: settle(f, True))

        delay_s = _tailguard.HEDGER.delay_s(self._predicted_step_us(name))
        timer = threading.Timer(delay_s, launch_hedge)
        timer.daemon = True
        state["timer"] = timer
        primary.add_done_callback(lambda f: settle(f, False))
        with lock:
            fast = state["done"]
        if not fast:                      # no timer for a settled request
            timer.start()
        return out

    def predict(self, name: str, inputs, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        return self.submit(name, inputs, deadline_ms).result(timeout=timeout)

    @staticmethod
    def _raw_load(rep: _Replica) -> int:
        srv = rep.server
        with srv._cond:
            return sum(len(t.queue) for t in srv._router.tenants())

    @classmethod
    def _load_of(cls, rep: _Replica) -> float:
        return cls._raw_load(rep) / rep.capacity

    # ------------------------------------------------------------------
    # signals / lifecycle
    # ------------------------------------------------------------------
    def queue_pressure(self) -> float:
        """Worst endpoint's pending rows over its bound, averaged over the
        replicas in rotation (0.0 idle, 1.0 every queue full)."""
        replicas = self._rotation()
        if not replicas:
            return 0.0
        vals = []
        for rep in replicas:
            srv = rep.server
            with srv._cond:
                tenants = srv._router.tenants()
                vals.append(max((t.queue.pending_rows /
                                 max(t.queue.max_queue_rows, 1)
                                 for t in tenants), default=0.0))
        return sum(vals) / len(vals)

    def size(self) -> int:
        with self._lock:
            return len(self._replicas)

    def snapshot(self) -> dict:
        replicas = self._rotation()
        return {"replicas": [{"rid": r.rid, "state": r.server.state,
                              "capacity": r.capacity,
                              "load": self._raw_load(r),
                              "weighted_load": round(self._load_of(r), 4)}
                             for r in replicas],
                "size": len(replicas),
                "queue_pressure": round(self.queue_pressure(), 4)}

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop every replica (drained by default)."""
        with self._lock:
            replicas, self._replicas = self._replicas, []
        _REPLICAS_G.set(0)
        for rep in replicas:
            rep.server.stop(drain=drain, timeout=timeout)

    def __enter__(self) -> "ServingPool":
        return self

    def __exit__(self, *exc):
        self.stop(drain=True)
        return False


class Autoscaler:
    """The control loop: SLO burn and queue pressure in, scale actions out.

    Every constructor argument pins its ``MXNET_AUTOSCALE_*`` flag (None:
    read it at every poll). ``tick()`` is the loop body; ``start()`` runs
    it on a poll thread."""

    def __init__(self, pool: ServingPool, monitor=None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 up_n: Optional[int] = None,
                 down_n: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 queue_high: Optional[float] = None,
                 queue_low: Optional[float] = None,
                 time_fn=time.monotonic):
        self.pool = pool
        self._monitor = monitor if monitor is not None else _SLO_MONITOR
        self._min = min_replicas
        self._max = max_replicas
        self._poll = poll_s
        self._up_n = up_n
        self._down_n = down_n
        self._cooldown = cooldown_s
        self._q_high = queue_high
        self._q_low = queue_low
        self._now = time_fn
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._over_polls = 0
        self._idle_polls = 0
        self._last_action_ts: Optional[float] = None
        self.actions: list = []      # action reports, newest last
        _debug.attach_autoscaler(self)   # weak: /statusz + /fleetz

    @property
    def min_replicas(self) -> int:
        return self._min if self._min is not None else \
            int(_config.get("MXNET_AUTOSCALE_MIN_REPLICAS"))

    @property
    def max_replicas(self) -> int:
        return self._max if self._max is not None else \
            int(_config.get("MXNET_AUTOSCALE_MAX_REPLICAS"))

    @property
    def poll_s(self) -> float:
        return self._poll if self._poll is not None else \
            float(_config.get("MXNET_AUTOSCALE_POLL_S"))

    @property
    def up_n(self) -> int:
        return self._up_n if self._up_n is not None else \
            int(_config.get("MXNET_AUTOSCALE_UP_N"))

    @property
    def down_n(self) -> int:
        return self._down_n if self._down_n is not None else \
            int(_config.get("MXNET_AUTOSCALE_DOWN_N"))

    @property
    def cooldown_s(self) -> float:
        return self._cooldown if self._cooldown is not None else \
            float(_config.get("MXNET_AUTOSCALE_COOLDOWN_S"))

    @property
    def queue_high(self) -> float:
        return self._q_high if self._q_high is not None else \
            float(_config.get("MXNET_AUTOSCALE_QUEUE_HIGH"))

    @property
    def queue_low(self) -> float:
        return self._q_low if self._q_low is not None else \
            float(_config.get("MXNET_AUTOSCALE_QUEUE_LOW"))

    # ------------------------------------------------------------------
    # signals + decision
    # ------------------------------------------------------------------
    def signals(self) -> dict:
        """One poll's evidence: the worst fast-window burn and the active
        alerts across the SLO objectives, the pool's queue pressure and
        size (``predicted_warmup_s`` is 0: no compile cost model)."""
        max_fast = 0.0
        alerts = 0
        for st in self._monitor.check_all():
            max_fast = max(max_fast, float(st.get("fast_burn", 0.0)))
            alerts += 1 if st.get("alert_active") else 0
        return {"max_fast_burn": round(max_fast, 3),
                "alerts_active": alerts,
                "queue_pressure": round(self.pool.queue_pressure(), 4),
                "predicted_warmup_s": 0.0,
                "replicas": self.pool.size()}

    def _decide(self, sig: dict, now: float) -> Optional[str]:
        """Decision core: updates the hysteresis counters and returns 'up',
        'down' or None, under the cooldown and the bounds. A predicted
        warm-up of whole poll periods shaves that many polls off the
        scale-up hysteresis (never below one)."""
        over = (sig["alerts_active"] > 0
                or sig["max_fast_burn"] >= self._monitor.burn_threshold
                or sig["queue_pressure"] >= self.queue_high)
        idle = (sig["alerts_active"] == 0
                and sig["max_fast_burn"] < 1.0
                and sig["queue_pressure"] <= self.queue_low)
        up_need = self.up_n
        lead = float(sig.get("predicted_warmup_s", 0.0) or 0.0)
        if lead > 0.0:
            up_need = max(1, up_need - int(lead // max(self.poll_s, 1e-9)))
        with self._lock:
            self._over_polls = self._over_polls + 1 if over else 0
            self._idle_polls = self._idle_polls + 1 if idle else 0
            if self._last_action_ts is not None and \
                    now - self._last_action_ts < self.cooldown_s:
                return None
            if over and self._over_polls >= up_need \
                    and sig["replicas"] < self.max_replicas:
                self._over_polls = 0
                self._last_action_ts = now
                return "up"
            if idle and self._idle_polls >= self.down_n \
                    and sig["replicas"] > self.min_replicas:
                self._idle_polls = 0
                self._last_action_ts = now
                return "down"
        return None

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One control turn: tick the brownout ladder, read the signals,
        decide, act. Returns the action report or None."""
        if now is None:
            now = self._now()
        _tailguard.BROWNOUT.tick(now)
        sig = self.signals()
        verdict = self._decide(sig, now)
        if verdict is None:
            return None
        if verdict == "up":
            rid = self.pool.scale_up()
        else:
            rid = self.pool.scale_down()
            if rid is None:          # the pool refused (its last replica)
                return None
        report = dict(sig, action=verdict, rid=rid,
                      replicas=self.pool.size())
        _EVENTS.labels(verdict).inc()
        _flight.event(f"autoscale_{verdict}", **report)
        with self._lock:
            self.actions.append(report)
        return report

    # ------------------------------------------------------------------
    # poll thread
    # ------------------------------------------------------------------
    def start(self) -> "Autoscaler":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            if self.poll_s <= 0:
                raise MXNetError("MXNET_AUTOSCALE_POLL_S must be > 0")
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._run, name="mxt-autoscaler", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop_ev.set()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.poll_s * 4 + 1.0)

    def _run(self):
        while not self._stop_ev.wait(self.poll_s):
            try:
                self.tick()
            except Exception:   # scaling outlives any one bad poll
                log.exception("autoscaler poll failed")

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def snapshot(self) -> dict:
        with self._lock:
            actions = list(self.actions)
            over, idle = self._over_polls, self._idle_polls
            last_ts = self._last_action_ts
        age = (self._now() - last_ts) if last_ts is not None else None
        return {"pool": self.pool.snapshot(), "actions": actions,
                "over_polls": over, "idle_polls": idle,
                "up_n": self.up_n, "down_n": self.down_n,
                "cooldown_s": self.cooldown_s,
                "last_action_age_s": round(age, 3) if age is not None
                else None,
                "in_cooldown": bool(age is not None
                                    and age < self.cooldown_s),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas}
