"""InferenceServer: the request -> batch -> device -> response loop (the port
of ``mxnet_tpu/serving/server.py``).

Three coupled pieces make the multi-tenant server:

**Router** (``router.py``): many ModelEndpoints (tenants) share the one
device-owning dispatch path; the next batch is picked earliest-deadline-
first across tenants, priced by each bucket's measured step-time EWMA,
shortest job first among late tenants, with an anti-starvation backstop.
Batches assemble at the last moment, so rows arriving during step k join
batch k+1: the prep stage holds a batch short of a full bucket until the
worker is predicted to be free less the predicted prep time (the
step-cost and prep-cost EWMAs), so sealing early does not split a
tenant's traffic into smaller batches.

**Host pipeline** (``pipeline.py``, ``pipeline=True``): a prep thread
assembles batch k+1 into its staging slot and starts the copy to the card
on a prep stream while the worker executes batch k on the worker stream;
the worker's stream waits on the copy's event. Only the worker runs the
model. Each thread enters ``torch.inference_mode()`` and runs its device
work on its own stream (``torch.cuda.stream``), so K1 launches on the
worker's stream. The default, ``pipeline=False``, is the serial
prepare-then-execute loop (same scheduler, same slots, same forward: the
bitwise reference of the pipelined path). It is the default because the
port's eager forward is bound by the host's launch work, so the prep
thread hides almost nothing and only competes with the worker for the
interpreter; under closed-loop clients the pipelined server served
fewer requests a second (PERF.md, ROADMAP SV1).

**Per-tenant shedding**: each tenant has its own CircuitBreaker (unless the
server was built with a shared ``breaker``), so one tenant's failures or
stalls tighten that tenant's admission (DEGRADED: half its queue bound;
OPEN: shed all) while the others keep serving; ``health()`` reports the
worst circuit and each tenant's.

Every device step runs under a ``RetryPolicy`` (backoff clamped to the
batch's earliest deadline, retries drawn from the tail guard's ``execute``
budget) and a ``Watchdog`` (a stall degrades the tenant's breaker and
notifies stall listeners: the ``PoolSupervisor`` confirms the wedge and
calls :meth:`InferenceServer.failover`). ``hot_swap`` verifies a checkpoint
on the caller's thread and cuts over on the worker between two batches.
``stop(drain=True)`` serves admitted work for at most ``drain_timeout_s``
and then abandons it, failing every waiting client. A served response is
the output tensor rows on the endpoint's device; a failure of the model
(K1 included) fails its batch through the retry policy and the breaker,
never falling back to another device.

Generative models ride beside it: ``register_generator`` puts a
``generate.DecodeEndpoint`` behind its own ``DecodeScheduler``, which
starts and stops with the server, and ``generate`` streams tokens from it.

Telemetry: each batch runs inside a ``serving.batch`` span that adopts
its oldest request's trace id (stamped at submit, so the id crosses the
queue hop), with the endpoint's ``serving.device_step`` and the prep's
``serving.prep`` under the same trace; a draining stop runs inside
``serving.drain``. Every completed or failed request lands in the flight
recorder's request ring, a failover fires the ``failover`` trigger and a
routed hot swap records a ``hot_swap`` event. ``failovers``,
``failover_reasons``, ``failover_requeued`` and ``drain_abandoned`` read
this server's share of ``mxtpu_serving_failovers_total``,
``mxtpu_serving_failover_requeued_total`` and
``mxtpu_drain_abandoned_total``. While a profiler session runs, each batch
step is also one profiler event and each request one duration.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..ops.registry import _profiler_running
from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy
from ..resilience.watchdog import (CircuitBreaker, Watchdog, DEGRADED,
                                   HALF_OPEN, HEALTHY, OPEN)
from ..telemetry import debug_server as _debug
from ..telemetry import flight as _flight
from ..telemetry.metrics import Baseline
from ..telemetry.slo import MONITOR as _SLO
from . import bucketing, tailguard as _tailguard
from .batcher import EndpointQueue, Request, fail, now_us, resolve
from .endpoint import ModelEndpoint
from .errors import (HotSwapError, RequestTimeoutError, ServerClosedError,
                     ServerOverloadError)
from .generate import DecodeScheduler
from .pipeline import OverlapTracker, PreparedBatch, prepare_batch
from .router import Router, Tenant

__all__ = ["InferenceServer"]

_RUNNING, _DRAINING, _STOPPED = "running", "draining", "stopped"

#: returned by the wait loops to a worker/prep thread whose generation a
#: failover replaced: it exits, a replacement is already running
_SUPERSEDED = object()

#: how bad a circuit state is, for the worst-of health aggregation
_CIRCUIT_SEVERITY = {HEALTHY: 0, DEGRADED: 1, HALF_OPEN: 2, OPEN: 3}

_DRAIN_ABANDONED = _telemetry.counter(
    "mxtpu_drain_abandoned_total",
    "Requests abandoned because stop(drain=True) hit its timeout with the "
    "worker wedged: queued-never-batched ones failed with ServerClosedError, "
    "ones already inside a prepared/in-flight batch with "
    "RequestTimeoutError — never left to hang a waiting client.")

_FAILOVERS = _telemetry.counter(
    "mxtpu_serving_failovers_total",
    "Worker failovers performed, by reason: worker_dead (thread crashed) / "
    "worker_wedged (in-flight batch outlived the watchdog stall threshold) "
    "/ prep_dead (prep thread crashed).", labelnames=("reason",))
_FAILOVER_REQUEUED = _telemetry.counter(
    "mxtpu_serving_failover_requeued_total",
    "Requests returned to the front of their tenant queues by a failover "
    "(from prepared / in-flight batches of the dead worker); deadlines are "
    "re-checked at re-assembly.")


class _SwapRequest:
    """One routed hot swap: verified host weights and their probe, applied
    by the worker between two batches."""

    __slots__ = ("tenant", "host_params", "probe", "label", "future")

    def __init__(self, tenant, host_params, probe, label):
        self.tenant = tenant
        self.host_params = host_params
        self.probe = probe
        self.label = label
        self.future = Future()


class InferenceServer:
    """Pipelined, multi-tenant dynamic-batching front end over registered
    ModelEndpoints.

    Parameters
    ----------
    batch_timeout_ms : float
        Longest time the oldest queued request waits before a partial batch
        runs anyway.
    max_queue : int
        Default admission bound, in rows, per endpoint (override at
        :meth:`register`).
    retry_policy : resilience.RetryPolicy, optional
        Per-batch retry of the device step and the prep (default: the
        ``MXNET_RETRY_*`` flags).
    breaker : resilience.CircuitBreaker, optional
        Shared by every tenant when given; else each tenant gets its own
        ``CircuitBreaker(scope="serving:<name>")``.
    watchdog_stall_s : float, optional
        Hang threshold of one device step (default
        ``MXNET_WATCHDOG_STALL_S``).
    drain_timeout_s : float, optional
        Bound on ``stop(drain=True)`` (default
        ``MXNET_SERVING_DRAIN_TIMEOUT_S``).
    pipeline : bool
        True: a prep thread overlaps batch k+1's assembly and copy with
        step k. False (default): serial prepare-then-execute on the
        worker.
    pipeline_depth : int, optional
        Prepared batches allowed to wait for the worker (default
        ``MXNET_SERVING_PIPELINE_DEPTH``); depth d cycles d+1 slots.
    """

    def __init__(self, batch_timeout_ms: float = 2.0, max_queue: int = 256,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 watchdog_stall_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None,
                 pipeline: bool = False,
                 pipeline_depth: Optional[int] = None):
        self._batch_timeout_us = int(batch_timeout_ms * 1000)
        self._max_queue_rows = int(max_queue)
        self._pipeline = bool(pipeline)
        depth = int(pipeline_depth if pipeline_depth is not None
                    else _config.get("MXNET_SERVING_PIPELINE_DEPTH"))
        if depth < 1:
            raise MXNetError(f"pipeline_depth must be >= 1, got {depth}")
        self._depth = depth
        self._router = Router(self._batch_timeout_us)
        self._cond = threading.Condition(threading.Lock())
        self._state = _STOPPED
        self._thread: Optional[threading.Thread] = None       # worker
        self._prep_thread: Optional[threading.Thread] = None  # prep stage
        self._prep_done = True
        self._prepared: "list[PreparedBatch]" = []
        # failover bookkeeping: the current thread generation (superseded
        # threads exit), what each stage holds now (a failover requeues
        # it), and pending hot-swap commands
        self._epoch = 0
        self._inflight: Optional[PreparedBatch] = None
        self._inflight_since = 0        # us: when the running step began
        self._preparing = None          # (tenant, [requests]) during prep
        self._swaps: "list[_SwapRequest]" = []
        self._stall_listeners: list = []
        # this server's share of the failover and drain families
        self._own = Baseline({"requeued": _FAILOVER_REQUEUED,
                              "abandoned": _DRAIN_ABANDONED})
        self._failover_reasons = Baseline()
        self._overlap = OverlapTracker()
        self._retry = retry_policy if retry_policy is not None \
            else RetryPolicy.from_config()
        self._shared_breaker = breaker
        self._breaker = breaker if breaker is not None \
            else CircuitBreaker(scope="serving")
        self._watchdog = Watchdog(stall_s=watchdog_stall_s,
                                  on_stall=self._on_stall)
        self._drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else _config.get("MXNET_SERVING_DRAIN_TIMEOUT_S"))
        self._streams: Dict[tuple, object] = {}
        self._streams_lock = threading.Lock()
        self._generators: Dict[str, DecodeScheduler] = {}

    # ------------------------------------------------------------------
    # endpoint management
    # ------------------------------------------------------------------
    def register(self, endpoint: ModelEndpoint, warmup: bool = True,
                 max_queue: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 slo_target: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 tier: str = "gold") -> ModelEndpoint:
        """Attach an endpoint as a tenant; by default runs every bucket
        once now on the worker's stream (seeding the step-cost EWMA and
        that stream's memory pool) and allocates its staging slots.

        ``max_queue`` overrides the tenant's row quota; ``slo_ms`` is its
        scheduling SLO (requests without a deadline are scheduled as due
        ``slo_ms`` after submit) and its latency objective in the SLO
        monitor against ``slo_target`` (default ``MXNET_SLO_TARGET``);
        ``breaker`` overrides its circuit breaker; ``tier`` ("gold",
        "silver", "bulk") is its brownout criticality."""
        if tier not in _tailguard.TIER_RANKS:
            raise MXNetError(
                f"unknown tenant tier {tier!r}; expected one of "
                f"{sorted(_tailguard.TIER_RANKS)}")
        with self._cond:
            if endpoint.name in self._router:
                raise MXNetError(f"endpoint {endpoint.name!r} already "
                                 "registered")
            q = EndpointQueue(
                endpoint, int(max_queue) if max_queue is not None
                else self._max_queue_rows, self._batch_timeout_us)
            if breaker is None:
                breaker = self._shared_breaker if self._shared_breaker \
                    is not None else CircuitBreaker(
                        scope=f"serving:{endpoint.name}")
            self._router.add(Tenant(
                endpoint.name, endpoint, q, breaker,
                slo_us=int(slo_ms * 1000) if slo_ms is not None else None,
                slo_target=slo_target, tier=tier))
        if slo_ms is not None:
            _SLO.register(endpoint.name, threshold_us=slo_ms * 1000.0,
                          target=slo_target, breaker=breaker)
        if warmup:
            # on the worker's stream: the caching allocator keeps a pool a
            # stream, so warm-up on another stream would leave the served
            # forwards to allocate their activations anew
            with self._on_stream(endpoint, "worker"):
                endpoint.warmup()
            # and the staging slots this server's first generation writes,
            # so no first batch of a bucket pays for pinned memory
            for b in endpoint.buckets:
                for parity in range(self._depth + 1 if self._pipeline
                                    else 1):
                    endpoint.staging_buffers(b, parity)
        return endpoint

    def register_generator(self, engine, warmup: bool = True,
                           tenants: Optional[Dict[str, float]] = None,
                           default_slo_ms: Optional[float] = None
                           ) -> DecodeScheduler:
        """Attach a generative ``DecodeEndpoint`` behind its own
        ``DecodeScheduler``; returns the scheduler.

        ``tenants`` maps tenant name -> inter-token SLO in ms per token (a
        ``default`` tenant always exists). With ``warmup`` every prefill and
        decode bucket runs once now, seeding the step-cost EWMAs. The
        scheduler starts with the server (at once if it is running)."""
        with self._cond:
            if engine.name in self._generators:
                raise MXNetError(
                    f"generator {engine.name!r} already registered")
        sched = DecodeScheduler(engine, default_slo_ms=default_slo_ms)
        for tname, slo_ms in (tenants or {}).items():
            sched.add_tenant(tname, slo_ms)
        if warmup:
            engine.warmup()
        with self._cond:
            self._generators[engine.name] = sched
            running = self._state == _RUNNING
        if running:
            sched.start()
        return sched

    def generate(self, name: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 tenant: str = "default", eos_id: Optional[int] = None,
                 on_token=None, deadline=None):
        """Queue one sequence on the generator ``name``; returns its
        ``TokenStream``."""
        with self._cond:
            sched = self._generators.get(name)
            names = sorted(self._generators)
        if sched is None:
            raise MXNetError(f"unknown generator {name!r}; registered: "
                             f"{names}")
        return sched.submit(prompt, max_new_tokens=max_new_tokens,
                            tenant=tenant, eos_id=eos_id, on_token=on_token,
                            deadline=deadline)

    def endpoints(self):
        with self._cond:
            return self._router.names()

    def breaker_for(self, name: str) -> CircuitBreaker:
        """The named tenant's circuit breaker."""
        with self._cond:
            return self._tenant(name).breaker

    def _tenant(self, name: str) -> Tenant:  # caller holds the lock
        tenant = self._router.find(name)
        if tenant is None:
            raise MXNetError(f"unknown endpoint {name!r}; registered: "
                             f"{self._router.names()}")
        return tenant

    # ------------------------------------------------------------------
    # zero-downtime weight hot swap (routed through the worker)
    # ------------------------------------------------------------------
    def hot_swap(self, name: str, source, timeout: Optional[float] = None
                 ) -> dict:
        """Swap the named endpoint's weights to ``source`` (a checkpoint
        directory or state tree) without dropping a request.

        The checkpoint is checksum-verified and shape-checked here on the
        caller's thread; staging, the probe and the cutover run on the
        worker between two batches, so every batch runs on the complete old
        or the complete new weights. A failed probe rolls back (the old
        weights keep serving) and raises HotSwapError; a corrupt
        checkpoint is refused before anything is staged. Blocks for the
        outcome (at most ``timeout`` seconds; None waits)."""
        with self._cond:
            tenant = self._tenant(name)
        host_params, probe, label = tenant.endpoint.load_swap_source(source)
        req = _SwapRequest(tenant, host_params, probe, label)
        with self._cond:
            if self._state != _RUNNING:
                raise ServerClosedError(
                    f"server is {self._state}; hot_swap needs a running "
                    "worker (use endpoint.hot_swap() on a stopped one)")
            self._swaps.append(req)
            self._cond.notify_all()
        return req.future.result(timeout=timeout)

    def _apply_swap(self, req: _SwapRequest):
        """Worker half of a routed hot swap (between batches)."""
        ep = req.tenant.endpoint
        try:
            with self._on_stream(ep, "worker"):
                staged = ep.stage_weights(req.host_params)
                report = ep.validate_and_commit(staged, req.probe)
            report["source"] = req.label
            _telemetry.event("hot_swap", endpoint=ep.name, ok=True,
                             source=str(req.label),
                             weights_epoch=ep.weights_epoch)
            resolve(req.future, report)
        except Exception as e:      # the caller's future carries it
            _telemetry.event("hot_swap", endpoint=ep.name, ok=False,
                             source=str(req.label), error=str(e)[:200])
            fail(req.future, e if isinstance(e, HotSwapError) else
                 HotSwapError(f"hot swap of {ep.name!r} failed: {e}"))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "InferenceServer":
        with self._cond:
            if self._state != _STOPPED:
                raise MXNetError(f"server is {self._state}")
            for t in (self._thread, self._prep_thread):
                if t is not None and t.is_alive():
                    raise MXNetError(
                        "a previous worker is still inside a device call "
                        "(abandoned drain); this server cannot be restarted")
            self._state = _RUNNING
            self._prepared.clear()
            self._spawn_threads()
            gens = list(self._generators.values())
        for g in gens:
            g.start()
        _debug.attach(self)     # /healthz + /statusz see every live server
        return self

    def _spawn_threads(self):  # caller holds the lock
        """Start a worker (+ prep) generation: by start(), and by failover()
        after it bumped the epoch (a surviving stale thread exits at its
        next loop turn)."""
        epoch = self._epoch
        self._prep_done = not self._pipeline
        self._inflight = None
        self._preparing = None
        self._thread = threading.Thread(
            target=self._loop_exec if self._pipeline else self._loop_serial,
            args=(epoch,), name=f"mxt-serving-worker-e{epoch}", daemon=True)
        if self._pipeline:
            self._prep_thread = threading.Thread(
                target=self._loop_prep, args=(epoch,),
                name=f"mxt-serving-prep-e{epoch}", daemon=True)
            self._prep_thread.start()
        else:
            self._prep_thread = None
        self._thread.start()

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop serving. ``drain=True`` serves every admitted request first,
        for at most ``timeout`` seconds (default ``drain_timeout_s``); past
        it the rest is abandoned and counted in ``drain_abandoned``: queued
        requests fail with ServerClosedError, those inside a prepared or
        running batch with RequestTimeoutError. ``drain=False`` fails
        everything queued at once. The generators stop first, each
        draining (or not) on its own."""
        timeout = self._drain_timeout_s if timeout is None else float(timeout)
        with self._cond:
            gens = list(self._generators.values())
        for g in gens:
            g.stop(drain=drain, timeout=timeout)
        with self._cond:
            if self._state == _STOPPED and self._thread is None and \
                    self._prep_thread is None:
                return
            worker, prep = self._thread, self._prep_thread
            if drain:
                if self._state == _RUNNING:
                    self._state = _DRAINING
            else:
                self._state = _STOPPED
                exc = ServerClosedError("server stopped without drain")
                self._router.fail_all(exc)
                self._fail_prepared(exc)
                self._fail_swaps(exc)
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        # a draining stop is one span: the wall time spent flushing
        # admitted work
        with (_telemetry.span("serving.drain", timeout_s=round(timeout, 3))
              if drain and (prep is not None or worker is not None)
              else contextlib.nullcontext()):
            for t in (prep, worker):
                if t is not None:
                    t.join(max(deadline - time.monotonic(), 0.0))
        if any(t is not None and t.is_alive() for t in (prep, worker)):
            # the drain is wedged (a hung device step): abandon it. The
            # daemon threads find the state stopped when they return, and
            # resolve() on a future already failed here is a no-op
            with self._cond:
                self._state = _STOPPED
                abandoned = self._router.fail_all(ServerClosedError(
                    f"drain abandoned after {timeout:.1f}s (worker wedged)"))
                timed_out = RequestTimeoutError(
                    f"request abandoned inside a batch after the drain "
                    f"timeout ({timeout:.1f}s) with the worker wedged")
                abandoned += self._fail_prepared(timed_out)
                abandoned += self._fail_in_stage(timed_out)
                self._fail_swaps(ServerClosedError(
                    "drain abandoned (worker wedged)"))
                _DRAIN_ABANDONED.inc(abandoned)
                self._cond.notify_all()
            for t in (prep, worker):
                if t is not None:
                    t.join(1.0)
            if any(t is not None and t.is_alive() for t in (prep, worker)):
                # keep the handles: start() refuses a second worker beside
                # a wedged one
                self._watchdog.stop()
                return
        with self._cond:
            if self._thread is worker:
                self._thread = None
            if self._prep_thread is prep:
                self._prep_thread = None
        self._watchdog.stop()

    @property
    def state(self) -> str:
        return self._state

    @property
    def failovers(self) -> int:
        return sum(self._failover_reasons.as_dict().values())

    @property
    def failover_reasons(self) -> Dict[str, int]:
        return self._failover_reasons.as_dict()

    @property
    def failover_requeued(self) -> int:
        return int(self._own["requeued"])

    @property
    def drain_abandoned(self) -> int:
        return int(self._own["abandoned"])

    def health(self) -> dict:
        """Lifecycle state, the worst circuit across tenants (and each
        tenant's breaker), each endpoint's queue, circuit, SLO, weights
        epoch and step-cost estimates, each generator's snapshot, the prep
        overlap ratio, watchdog stalls and failovers."""
        with self._cond:
            state = self._state
            tenants = self._router.tenants()
            generators = {n: g.snapshot()
                          for n, g in self._generators.items()}
        breakers = [self._breaker]
        endpoints = {}
        for t in tenants:
            if all(t.breaker is not b for b in breakers):
                breakers.append(t.breaker)
            endpoints[t.name] = {
                "pending_requests": len(t.queue),
                "pending_rows": t.queue.pending_rows,
                "circuit": t.breaker.state(),
                "slo_ms": t.slo_us / 1000.0 if t.slo_us else None,
                "slo_target": t.slo_target,
                "tier": t.tier,
                "weights_epoch": t.endpoint.weights_epoch,
                "step_cost": t.endpoint.step_cost.snapshot(),
            }
        worst = max((b.state() for b in breakers),
                    key=lambda s: _CIRCUIT_SEVERITY[s])
        return {"state": state,
                "circuit": worst,
                "breaker": self._breaker.snapshot(),
                "tenants": {t.name: t.breaker.snapshot() for t in tenants},
                "endpoints": endpoints,
                "generators": generators,
                "prep_overlap_ratio": self._overlap.ratio(),
                "watchdog_stalls": self._watchdog.stalls,
                "worker_epoch": self._epoch,
                "failovers": self.failovers,
                "failover_requeued": self.failover_requeued,
                "drain_abandoned": self.drain_abandoned}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)
        return False

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, name: str, inputs, deadline_ms: Optional[float] = None,
               deadline=None) -> Future:
        """Enqueue a request; returns a Future resolving to the endpoint's
        output tensor (a tuple for multi-output models) on its device. A
        single example (no batch axis) resolves without a batch axis.

        ``deadline`` is a propagated ``tailguard.Deadline`` (minted once at
        ingress); it overrides ``deadline_ms``, and a spent one raises
        DeadlineExceeded before admission.

        Raises ServerOverloadError when the tenant's bounded queue is full,
        its breaker is shedding (OPEN: all; HALF_OPEN: beyond the probe;
        DEGRADED: beyond half the queue bound) or the brownout ladder
        refuses its tier, and ServerClosedError when the server is not
        accepting work."""
        if deadline is not None:
            deadline.check("ingress")
        with self._cond:
            tenant = self._tenant(name)
        q = tenant.queue
        stats = q.endpoint.stats
        if _tailguard.BROWNOUT.shed_tier(tenant.tier):
            stats.bump("rejected")
            stats.record_shed("brownout")
            raise ServerOverloadError(
                f"endpoint {name!r} (tier {tenant.tier!r}) shed by brownout "
                f"level {_tailguard.BROWNOUT.level}; retry with backoff")
        if not tenant.breaker.allow():
            stats.bump("rejected")
            stats.record_shed(f"circuit_{tenant.breaker.state()}")
            raise ServerOverloadError(
                f"endpoint {name!r} circuit {tenant.breaker.state()}: "
                "shedding load until the device recovers; retry with backoff")
        req = self._make_request(q.endpoint, inputs, deadline_ms, deadline)
        with self._cond:
            if self._state != _RUNNING:
                raise ServerClosedError(f"server is {self._state}")
            if tenant.breaker.state() == DEGRADED and \
                    q.pending_rows + req.rows > q.max_queue_rows // 2:
                stats.bump("rejected")
                stats.record_shed("degraded")
                raise ServerOverloadError(
                    f"endpoint {name!r} degraded: admission tightened to "
                    f"{q.max_queue_rows // 2} rows; retry with backoff")
            if not q.offer(req):
                stats.record_shed("queue_full")
                raise ServerOverloadError(
                    f"endpoint {name!r} queue full ({q.pending_rows} rows, "
                    f"bound {q.max_queue_rows}); retry with backoff")
            self._cond.notify_all()
        return req.future

    def predict(self, name: str, inputs, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(name, inputs, deadline_ms).result(timeout=timeout)

    @staticmethod
    def _make_request(ep: ModelEndpoint, inputs,
                      deadline_ms: Optional[float], deadline=None) -> Request:
        """Validate and host-normalize one request outside the lock: every
        input becomes a contiguous numpy batch in the endpoint's dtype."""
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        if len(inputs) != len(ep.input_shapes):
            raise MXNetError(f"endpoint {ep.name!r} takes "
                             f"{len(ep.input_shapes)} inputs, got {len(inputs)}")
        host = []
        rows = squeeze = None
        for i, (x, shape, npdt) in enumerate(
                zip(inputs, ep.input_shapes, ep.np_dtypes)):
            a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            if a.shape == shape:
                a, sq = a[None], True
            elif a.shape[1:] == shape:
                sq = False
            else:
                raise MXNetError(
                    f"endpoint {ep.name!r} input {i}: expected per-example "
                    f"shape {shape} (optionally batched), got {a.shape}")
            if rows is None:
                rows, squeeze = a.shape[0], sq
            elif a.shape[0] != rows:
                raise MXNetError(f"endpoint {ep.name!r}: inputs disagree on "
                                 f"batch rows ({rows} vs {a.shape[0]})")
            host.append(np.ascontiguousarray(a, dtype=npdt))
        if rows < 1 or rows > ep.max_batch_size:
            raise MXNetError(
                f"request of {rows} rows: endpoint {ep.name!r} takes 1 to "
                f"max_batch_size={ep.max_batch_size}; split the request")
        return Request(tuple(host), rows, squeeze, deadline_ms,
                       deadline=deadline)

    # ------------------------------------------------------------------
    # streams: each stage runs its device work on a stream of its own
    # ------------------------------------------------------------------
    def _on_stream(self, ep: ModelEndpoint, role: str):
        """Context that makes ``role``'s stream (worker or prep) on the
        endpoint's card the current stream; nothing on the CPU."""
        if ep.device.type != "cuda":
            return contextlib.nullcontext()
        key = (ep.device, role)
        with self._streams_lock:
            s = self._streams.get(key)
            if s is None:
                s = self._streams[key] = torch.cuda.Stream(ep.device)
        return torch.cuda.stream(s)

    # ------------------------------------------------------------------
    # shared scheduling helpers (caller holds the condition lock)
    # ------------------------------------------------------------------
    def _next_assembly(self, epoch: int, take_swaps: bool = False,
                       hold: bool = False):
        """Block until the Router yields a tenant whose batch should
        assemble now: returns (tenant, requests) (requests may be [] when
        every ready request had expired), None once stopped or drained,
        _SUPERSEDED when a failover replaced this generation.
        ``take_swaps`` (the serial worker) also returns pending
        _SwapRequests, ahead of assembly: a swap lands at the next batch
        boundary. ``hold`` (the prep stage) keeps a batch short of a full
        bucket queued until the worker is predicted to be free less the
        batch's predicted prep time, so it can still take rows."""
        while True:
            if self._state == _STOPPED:
                return None
            if self._epoch != epoch:
                return _SUPERSEDED
            if take_swaps and self._swaps:
                return self._swaps.pop(0)
            now = now_us()
            flush = self._state == _DRAINING
            if len(self._prepared) >= self._depth:
                # the handoff is full until the worker pops (it notifies);
                # bounded in case the worker dies mid-batch
                self._cond.wait(timeout=0.25)
                continue
            tenant = self._router.select(now, flush)
            if tenant is not None:
                until = self._assemble_at_us(tenant, now) \
                    if hold and not flush else now
                if now < until:
                    # rows or the step's end notify; else wake at `until`
                    self._cond.wait(timeout=(until - now) / 1e6)
                    continue
                return tenant, tenant.queue.take_batch(now)
            if flush:
                return None       # handoff free, nothing ready: drained
            wakeup = self._router.next_wakeup_us()
            self._cond.wait(timeout=max(wakeup - now, 0) / 1e6
                            if wakeup is not None else None)

    def _assemble_at_us(self, tenant: Tenant, now: int) -> float:
        """When the prep stage should assemble ``tenant``'s next batch
        (caller holds the lock): now for a full bucket, else the predicted
        end of the running step and of the batches already prepared, less
        this batch's predicted prep time."""
        q, ep = tenant.queue, tenant.endpoint
        if q.pending_rows >= ep.max_batch_size:
            return now
        free = now
        pb = self._inflight
        if pb is not None:
            free = max(free, self._inflight_since + pb.tenant.endpoint
                       .step_cost.estimate(pb.staged.bucket))
        for pb in self._prepared:
            free += pb.tenant.endpoint.step_cost.estimate(pb.staged.bucket)
        bucket = bucketing.bucket_for(min(q.pending_rows, ep.max_batch_size),
                                      ep.buckets)
        return free - ep.prep_cost.estimate(bucket)

    def _fail_prepared(self, exc: Exception) -> int:  # caller holds the lock
        """Fail every prepared, unexecuted batch; returns how many
        requests."""
        n = 0
        while self._prepared:
            pb = self._prepared.pop(0)
            for r in pb.requests:
                pb.tenant.endpoint.stats.bump("cancelled")
                fail(r.future, exc)
                n += 1
        return n

    def _fail_in_stage(self, exc: Exception) -> int:  # caller holds the lock
        """Fail the requests of the running step and of the prep stage; a
        wedged thread that returns later resolves futures already
        settled (a no-op)."""
        n = 0
        for holder in (self._inflight, self._preparing):
            if holder is None:
                continue
            tenant, requests = (holder.tenant, holder.requests) \
                if isinstance(holder, PreparedBatch) else holder
            for r in requests:
                tenant.endpoint.stats.bump("cancelled")
                fail(r.future, exc)
                n += 1
        self._inflight = None
        self._preparing = None
        return n

    def _fail_swaps(self, exc: Exception):  # caller holds the lock
        while self._swaps:
            fail(self._swaps.pop(0).future, exc)

    def _on_stall(self, name: str, dt: float):
        """Watchdog hook: a stalled step degrades the stalled tenant's
        circuit (the server breaker for another watch name), then tells the
        stall listeners (the PoolSupervisor confirms and fails over)."""
        ep_name = name.partition("[")[2].rstrip("]")
        tenant = self._router.find(ep_name)
        br = tenant.breaker if tenant is not None else self._breaker
        br.force_degraded(f"stall {name} {dt:.1f}s")
        for cb in list(self._stall_listeners):
            cb(name, dt)

    def add_stall_listener(self, cb):
        """Subscribe ``cb(watch_name, elapsed_s)`` to watchdog stalls; it
        runs on the watchdog's thread and must not block."""
        self._stall_listeners.append(cb)

    def remove_stall_listener(self, cb):
        if cb in self._stall_listeners:
            self._stall_listeners.remove(cb)

    # ------------------------------------------------------------------
    # worker failover (driven by the PoolSupervisor)
    # ------------------------------------------------------------------
    def failover(self, reason: str, tenant_name: Optional[str] = None
                 ) -> Optional[dict]:
        """Replace a dead or wedged worker generation without restarting
        the server: requeue every batch it held (prepared, in prep, in
        flight) at the front of its tenant's queue in order, deadlines
        kept; trip only the affected tenant's breaker; bump the epoch (a
        surviving stale thread exits at its next turn, and its late
        resolutions are no-ops); start fresh threads. Returns the report,
        or None when the server is not running."""
        with self._cond:
            if self._state != _RUNNING:
                return None
            self._epoch += 1
            requeued = 0
            # newest-assembled first, so the oldest work ends at the head
            for pb in reversed(self._prepared):
                pb.tenant.queue.requeue_front(pb.requests)
                requeued += len(pb.requests)
            self._prepared.clear()
            if self._preparing is not None:
                tenant, batch = self._preparing
                tenant.queue.requeue_front(batch)
                requeued += len(batch)
                self._preparing = None
            inflight = self._inflight
            if inflight is not None:
                inflight.tenant.queue.requeue_front(inflight.requests)
                requeued += len(inflight.requests)
                if tenant_name is None:
                    tenant_name = inflight.tenant.name
                self._inflight = None
            affected = self._router.find(tenant_name) \
                if tenant_name is not None else None
            if affected is not None:
                affected.breaker.record_failure()
            self._failover_reasons.add(
                reason, _FAILOVERS.labels(reason)).inc()
            if requeued:
                _FAILOVER_REQUEUED.inc(requeued)
            epoch = self._epoch
            self._spawn_threads()
            self._cond.notify_all()
        report = {"reason": reason, "epoch": epoch, "requeued": requeued,
                  "tenant": tenant_name}
        _flight.trigger("failover", **report)
        return report

    def _parity_base(self, epoch: int) -> int:
        """First slot parity of a generation: a new generation never writes
        the slots a superseded one (a zombie still inside a step) reads."""
        return epoch * (self._depth + 1)

    # ------------------------------------------------------------------
    # serial worker (pipeline=False): assemble -> prepare -> execute
    # ------------------------------------------------------------------
    def _loop_serial(self, epoch: int):
        with torch.inference_mode():
            while True:
                with self._cond:
                    item = self._next_assembly(epoch, take_swaps=True)
                    if item is _SUPERSEDED:
                        return
                    if item is None:
                        self._state = _STOPPED
                        self._fail_swaps(ServerClosedError("server stopped"))
                        self._cond.notify_all()
                        return
                    if not isinstance(item, _SwapRequest) and item[1]:
                        # recorded in the critical section that took it,
                        # so a failover always finds it
                        self._preparing = item
                if isinstance(item, _SwapRequest):
                    self._apply_swap(item)    # a batch boundary
                    continue
                tenant, batch = item
                if not batch:
                    continue
                # no finally: a thread-killing BaseException leaves the
                # record for failover to requeue
                pb = self._prepare(tenant, batch, self._parity_base(epoch),
                                   "worker")
                with self._cond:
                    if self._epoch != epoch:
                        # superseded mid-prepare: failover requeued the
                        # batch for the replacement generation
                        return
                    self._preparing = None
                    if pb is None:
                        continue          # prep failed; futures failed
                    self._start_step(pb)
                self._execute(pb)

    # ------------------------------------------------------------------
    # pipelined prep stage: assemble + copy batch k+1 during step k
    # ------------------------------------------------------------------
    def _loop_prep(self, epoch: int):
        k = 0
        with torch.inference_mode():
            while True:
                with self._cond:
                    item = self._next_assembly(epoch, hold=True)
                    if item is _SUPERSEDED:
                        return
                    if item is None:
                        self._prep_done = True
                        self._cond.notify_all()
                        return
                    if item[1]:
                        self._preparing = item
                tenant, batch = item
                if not batch:
                    continue
                pb = self._prepare(tenant, batch,
                                   self._parity_base(epoch) + k, "prep")
                with self._cond:
                    if self._epoch != epoch:
                        # superseded mid-prepare: failover requeued the
                        # batch for the replacement generation
                        return
                    self._preparing = None
                    if pb is None:
                        continue          # prep failed; futures failed
                    # cycle over depth + 1 parities: with d batches queued
                    # and one running, the slot rewritten is always retired
                    k = (k + 1) % (self._depth + 1)
                    if self._state == _STOPPED:
                        exc = ServerClosedError("server stopped")
                        for r in pb.requests:
                            tenant.endpoint.stats.bump("cancelled")
                            fail(r.future, exc)
                        continue
                    self._prepared.append(pb)
                    self._cond.notify_all()

    def _prepare(self, tenant: Tenant, batch, parity: int, role: str
                 ) -> Optional[PreparedBatch]:
        """Host prep of one assembled batch on ``role``'s stream (lock not
        held); a failure fails the batch's futures and counts against the
        tenant's breaker."""
        try:
            with self._on_stream(tenant.endpoint, role):
                return prepare_batch(tenant, batch, parity, self._overlap,
                                     self._retry)
        except Exception as e:      # fails this batch, not the server
            tenant.breaker.record_failure()
            for r in batch:
                fail(r.future, e)
            return None

    # ------------------------------------------------------------------
    # pipelined worker: execute prepared batches (the only model caller)
    # ------------------------------------------------------------------
    def _loop_exec(self, epoch: int):
        with torch.inference_mode():
            while True:
                with self._cond:
                    item = self._next_prepared(epoch)
                    if item is _SUPERSEDED:
                        return
                    if item is None:
                        self._state = _STOPPED
                        self._fail_swaps(ServerClosedError("server stopped"))
                        self._cond.notify_all()
                        return
                if isinstance(item, _SwapRequest):
                    self._apply_swap(item)    # between batches
                    continue
                self._execute(item)       # _next_prepared marked it running

    def _next_prepared(self, epoch: int):  # caller holds the lock
        """Block for the next hot-swap command (first: they cut over at the
        batch boundary) or prepared batch; None on stop or a finished
        drain, _SUPERSEDED on failover."""
        while True:
            if self._state == _STOPPED:
                return None
            if self._epoch != epoch:
                return _SUPERSEDED
            if self._swaps:
                return self._swaps.pop(0)
            if self._prepared:
                pb = self._prepared.pop(0)
                self._start_step(pb)
                self._cond.notify_all()   # the handoff has room again
                return pb
            if self._state == _DRAINING and self._prep_done:
                return None
            self._cond.wait()

    # ------------------------------------------------------------------
    # device dispatch (worker thread only)
    # ------------------------------------------------------------------
    def _start_step(self, pb: PreparedBatch):  # caller holds the lock
        """Mark ``pb`` as the running step, in the same critical section
        that took it (and checked the generation): a failover requeues it
        from here, and the prep stage's hold reads when it began."""
        self._inflight = pb
        self._inflight_since = now_us()

    def _execute(self, pb: PreparedBatch):
        ep = pb.tenant.endpoint
        profiling = _profiler_running()

        def run_step():
            _faults.check("serving_dispatch")
            if profiling:
                from .. import profiler
                return profiler._dispatch_profiled(
                    f"serving[{ep.name}]b{pb.rows}",
                    lambda: ep.execute(pb.staged, pb.rows), cat="serving")
            return ep.execute(pb.staged, pb.rows)

        # `killed` guards the in-flight record: a thread-killing
        # BaseException leaves it set for failover to requeue the batch
        killed = True
        self._overlap.step_begin()
        try:
            # adopt the oldest request's trace id for the whole batch step:
            # its trace (submit -> batch -> device) is the one closest to
            # the latency budget
            with _telemetry.span("serving.batch",
                                 trace_id=pb.requests[0].trace_id,
                                 endpoint=ep.name, rows=pb.rows,
                                 requests=len(pb.requests)), \
                    self._on_stream(ep, "worker"), \
                    self._watchdog.watch(f"serving[{ep.name}]"):
                # retries never back off past the batch's earliest deadline
                outs = self._retry.run(run_step, site="serving_dispatch",
                                       deadline_us=pb.deadline_us,
                                       budget_tier="execute")
            killed = False
        except Exception as e:      # retries spent or fatal: fail the batch
            killed = False
            pb.tenant.breaker.record_failure()
            failed_at = now_us()
            for r in pb.requests:
                fail(r.future, e)
                _flight.record_request(r.trace_id, ep.name,
                                       failed_at - r.enqueue_us,
                                       rows=r.rows, ok=False,
                                       error=type(e).__name__)
                _SLO.record(ep.name, failed_at - r.enqueue_us, ok=False)
            return
        finally:
            self._overlap.step_end()
            if not killed:
                with self._cond:
                    # after a failover the slot is the replacement's
                    if self._inflight is pb:
                        self._inflight = None
                    self._cond.notify_all()   # a held prep may assemble
        pb.tenant.breaker.record_success()
        _tailguard.retry_deposit("execute")   # work funds the retry budget
        if ep.device.type == "cuda":
            # clients read the rows on their own streams: the allocator
            # must not hand these blocks to the worker stream before the
            # default stream's work queued by then has run
            consumer = torch.cuda.default_stream(ep.device)
            for o in outs:
                o.record_stream(consumer)
        done = now_us()
        off = 0
        for r in pb.requests:
            sliced = tuple(o[off] if r.squeeze else o[off:off + r.rows]
                           for o in outs)
            off += r.rows
            # a superseded worker's late result settles nothing: the request
            # counts once, where its future was settled
            if resolve(r.future,
                       sliced[0] if ep.num_outputs == 1 else sliced):
                ep.stats.record_latency(done - r.enqueue_us)
                ep.stats.bump("completed")
                _flight.record_request(r.trace_id, ep.name,
                                       done - r.enqueue_us, rows=r.rows)
                _SLO.record(ep.name, done - r.enqueue_us)
                if profiling:
                    from .. import profiler
                    profiler.record_duration(
                        f"serving[{ep.name}].request", r.enqueue_us,
                        done - r.enqueue_us, cat="serving")
