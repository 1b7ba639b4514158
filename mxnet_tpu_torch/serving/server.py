"""InferenceServer: the request -> batch -> device -> response loop (the port
of the serial worker of ``mxnet_tpu/serving/server.py``, its
``pipeline=False`` path).

Client threads validate a request, cast it to host numpy and enqueue it;
one worker thread assembles batches (a queue is ready when it holds a full
batch or its oldest request waited ``batch_timeout_ms``), pads them to a
bucket, runs the model and resolves each request's Future with its rows.
Admission is bounded per endpoint (ServerOverloadError), per-request
deadlines drop expired work before it takes device rows
(RequestTimeoutError), and ``stop(drain=True)`` serves every admitted
request first, for a bounded time.

Generative models ride beside it: ``register_generator`` puts a
``generate.DecodeEndpoint`` behind its own continuous-batching
``DecodeScheduler`` (the decode loop owns its device work; it does not ride
the request-batching worker), which starts and stops with the server, and
``generate`` streams tokens from it.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError
from .batcher import EndpointQueue, Request, concat_inputs, fail, now_us, resolve
from .endpoint import ModelEndpoint
from .errors import RequestTimeoutError, ServerClosedError, ServerOverloadError
from .generate import DecodeScheduler

__all__ = ["InferenceServer"]

_RUNNING, _DRAINING, _STOPPED = "running", "draining", "stopped"


class InferenceServer:
    """Dynamic-batching front end over registered ModelEndpoints, served by
    one worker thread.

    Parameters
    ----------
    batch_timeout_ms : float
        Longest time the oldest queued request waits before a partial batch
        runs anyway.
    max_queue : int
        Default admission bound, in rows, per endpoint (override at
        :meth:`register`).
    """

    def __init__(self, batch_timeout_ms: float = 2.0, max_queue: int = 256):
        self._batch_timeout_us = int(batch_timeout_ms * 1000)
        self._max_queue_rows = int(max_queue)
        self._cond = threading.Condition(threading.Lock())
        self._queues: Dict[str, EndpointQueue] = {}
        self._state = _STOPPED
        self._thread: Optional[threading.Thread] = None
        self._inflight: list = []          # requests of the executing batch
        self._generators: Dict[str, DecodeScheduler] = {}

    # ------------------------------------------------------------------
    def register(self, endpoint: ModelEndpoint, warmup: bool = True,
                 max_queue: Optional[int] = None) -> ModelEndpoint:
        """Attach an endpoint; by default runs every bucket once now."""
        with self._cond:
            if endpoint.name in self._queues:
                raise MXNetError(f"endpoint {endpoint.name!r} already "
                                 "registered")
            self._queues[endpoint.name] = EndpointQueue(
                endpoint, int(max_queue) if max_queue is not None
                else self._max_queue_rows, self._batch_timeout_us)
        if warmup:
            endpoint.warmup()
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
                 on_token=None):
        """Queue one sequence on the generator ``name``; returns its
        ``TokenStream``."""
        with self._cond:
            sched = self._generators.get(name)
            names = sorted(self._generators)
        if sched is None:
            raise MXNetError(f"unknown generator {name!r}; registered: "
                             f"{names}")
        return sched.submit(prompt, max_new_tokens=max_new_tokens,
                            tenant=tenant, eos_id=eos_id, on_token=on_token)

    def health(self) -> dict:
        """Lifecycle state, each endpoint's queue depth and each
        generator's scheduler snapshot (its ``state`` among them)."""
        with self._cond:
            return {"state": self._state,
                    "endpoints": {n: {"pending_requests": len(q),
                                      "pending_rows": q.pending_rows}
                                  for n, q in self._queues.items()},
                    "generators": {n: g.snapshot()
                                   for n, g in self._generators.items()}}

    def endpoints(self):
        with self._cond:
            return sorted(self._queues)

    def start(self) -> "InferenceServer":
        with self._cond:
            if self._state != _STOPPED:
                raise MXNetError(f"server is {self._state}")
            if self._thread is not None and self._thread.is_alive():
                raise MXNetError("a previous worker is still inside a device "
                                 "call (abandoned drain); this server cannot "
                                 "be restarted")
            self._state = _RUNNING
            self._thread = threading.Thread(target=self._loop,
                                            name="mxt-serving-worker",
                                            daemon=True)
            self._thread.start()
            gens = list(self._generators.values())
        for g in gens:
            g.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0):
        """Stop serving. ``drain=True`` serves every admitted request first,
        for at most ``timeout`` seconds; past it the remaining requests fail
        (queued ones with ServerClosedError, the in-flight batch's with
        RequestTimeoutError) instead of hanging their clients.
        ``drain=False`` fails everything queued with ServerClosedError.
        The generators stop first, each draining (or not) on its own."""
        with self._cond:
            gens = list(self._generators.values())
        for g in gens:
            g.stop(drain=drain, timeout=timeout)
        with self._cond:
            worker = self._thread
            if worker is None:
                return
            if drain:
                if self._state == _RUNNING:
                    self._state = _DRAINING
            else:
                self._state = _STOPPED
                self._fail_queued(ServerClosedError(
                    "server stopped without drain"))
            self._cond.notify_all()
        worker.join(timeout)
        if worker.is_alive():
            with self._cond:
                self._state = _STOPPED
                self._fail_queued(ServerClosedError(
                    f"drain abandoned after {timeout:.1f}s"))
                exc = RequestTimeoutError(
                    f"request abandoned inside a batch after the drain "
                    f"timeout ({timeout:.1f}s)")
                for r in self._inflight:
                    fail(r.future, exc)
                self._cond.notify_all()
            return                          # keep the handle: start() refuses
        with self._cond:
            self._thread = None

    # ------------------------------------------------------------------
    def submit(self, name: str, inputs,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue a request; returns a Future resolving to the endpoint's
        output tensor (a tuple for multi-output models) on its device. A
        single example (no batch axis) resolves without a batch axis.

        Raises ServerOverloadError when the endpoint's bounded queue is
        full and ServerClosedError when the server is not accepting work."""
        with self._cond:
            q = self._queues.get(name)
        if q is None:
            raise MXNetError(f"unknown endpoint {name!r}; registered: "
                             f"{self.endpoints()}")
        req = self._make_request(q.endpoint, inputs, deadline_ms)
        with self._cond:
            if self._state != _RUNNING:
                raise ServerClosedError(f"server is {self._state}")
            if not q.offer(req):
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
                      deadline_ms: Optional[float]) -> Request:
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
        return Request(tuple(host), rows, squeeze, deadline_ms)

    # ------------------------------------------------------------------
    # worker (holds the only right to run the model)
    # ------------------------------------------------------------------
    def _fail_queued(self, exc: Exception):
        for q in self._queues.values():
            q.fail_all(exc)

    def _next_batch(self):
        """Block (holding the lock) until a queue should assemble now;
        returns ``(queue, requests)``, or None once stopped or drained."""
        while True:
            if self._state == _STOPPED:
                return None
            at = now_us()
            flush = self._state == _DRAINING
            ready = [q for q in self._queues.values() if q.ready(at, flush)]
            if ready:
                q = min(ready, key=lambda q: q.head_enqueue_us())
                return q, q.take_batch(at)
            if flush:
                return None              # draining and every queue is empty
            wakeups = [w for w in (q.next_wakeup_us()
                                   for q in self._queues.values())
                       if w is not None]
            self._cond.wait(timeout=max(min(wakeups) - at, 0) / 1e6
                            if wakeups else None)

    def _loop(self):
        while True:
            with self._cond:
                item = self._next_batch()
                if item is None:
                    self._state = _STOPPED
                    self._cond.notify_all()
                    return
                q, batch = item
                self._inflight = batch
            if batch:
                self._run(q.endpoint, batch)
            with self._cond:
                self._inflight = []

    def _run(self, ep: ModelEndpoint, batch):
        rows = sum(r.rows for r in batch)
        try:
            ins, bucket = ep.prepare(
                concat_inputs(batch, len(ep.input_shapes)), rows)
            outs = ep.execute(ins, bucket, rows)
        except Exception as e:    # a failed step fails its batch, not the server
            for r in batch:
                fail(r.future, e)
            return
        done = now_us()
        off = 0
        for r in batch:
            sliced = tuple(o[off] if r.squeeze else o[off:off + r.rows]
                           for o in outs)
            resolve(r.future, sliced[0] if ep.num_outputs == 1 else sliced)
            ep.stats.record_latency(done - r.enqueue_us)
            ep.stats.bump("completed")
            off += r.rows
