"""DecodeScheduler: token-granularity continuous batching for one endpoint
(the port of ``mxnet_tpu/serving/generate/scheduler.py``).

The decode batch is re-formed every step: a finished sequence leaves at the
step boundary it emits its last token (its pages free at once), and a
waiting sequence joins as soon as a slot and pages are available. Admission
is EDF over waiting sequences, slack priced with the live per-token step
cost (``StepCostEWMA`` over decode buckets), against per-tenant SLOs
expressed as inter-token latency.

Invariants:

- **Atomic emission**: a token is appended to the client stream and the
  sequence's position advanced under one lock, after the device step
  completes. A worker that dies mid-step has emitted nothing for that step.
- **Whole-budget reservation**: ``ceil((prompt + max_new) / page_size)``
  pages are reserved at admission, so KV exhaustion can only happen before
  a sequence starts: it stays queued (``KVPoolExhausted`` is absorbed).
- **Failover requeues, never replays**: a monitor thread polls the worker's
  liveness; on its death every RUNNING sequence goes back to the waiting
  queue with its pages, position and emitted tokens intact (no re-prefill),
  the epoch fences the dead generation out, and a fresh worker continues
  each sequence at exactly the next token: no duplicates, no drops.

Backpressure is lossless: a full client stream pauses the sequence (state
PAUSED, pages kept, not stepped); the stream's resume callback re-runs it.

Fault points (``resilience.faults``, site ``decode``): an injected fault at
the step boundary is absorbed and the batch re-formed next iteration;
``decode_stall`` is a ``WorkerKilled`` that takes the worker down, and the
failover above requeues its sequences; ``kv_exhausted`` fires in
``PagedKVPool.reserve`` and leaves the sequence queued.

Tail guard (``serving/tailguard.py``): a propagated ``Deadline`` bounds a
whole generation (an expired one refuses admission, and the loop retires
a sequence whose budget ran out before it costs another step, site
``decode_token``); under brownout (level >= 1) ``max_new_tokens`` is
clamped to ``MXNET_BROWNOUT_MAX_NEW_TOKENS``; every decode step deposits
into the ``decode`` retry budget and every failover requeue spends a token
from it, so a worker that dies on every step ends in bounded shed (its
sequences fail with ServerClosedError) instead of requeueing forever.

Telemetry: the endpoint's ``DecodeStats`` feed the ``mxtpu_decode_*``
families (sequence events, tokens, inter-token gaps by tenant, the waiting
queue's depth, stream backpressure, failovers by reason); an injected
decode fault that the loop absorbs records a ``decode_fault_absorbed``
event, and a failover a ``decode_failover`` event and flight trigger.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ... import config as _config
from ... import telemetry as _telemetry
from ...base import MXNetError
from ...resilience import faults as _faults
from ...telemetry import flight as _flight
from .. import tailguard as _tailguard
from ..errors import DeadlineExceeded, KVPoolExhausted, ServerClosedError
from .streams import TokenStream

__all__ = ["DecodeScheduler"]

_RUNNING, _DRAINING, _STOPPED = "running", "draining", "stopped"

# sequence states
_S_WAITING, _S_RUNNING, _S_PAUSED = "waiting", "running", "paused"
_S_DONE, _S_FAILED, _S_CANCELLED = "done", "failed", "cancelled"


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class _Tenant:
    __slots__ = ("name", "slo_us")

    def __init__(self, name: str, slo_us: float):
        self.name = name
        self.slo_us = float(slo_us)


class _Seq:
    __slots__ = ("sid", "tenant", "prompt", "max_new", "eos_id", "stream",
                 "state", "emitted", "pos", "prefilled", "enqueue_us",
                 "last_token_us", "deadline")

    def __init__(self, sid: int, tenant: _Tenant, prompt: Sequence[int],
                 max_new: int, eos_id: Optional[int], stream: TokenStream,
                 deadline=None):
        self.sid = sid
        self.tenant = tenant
        self.prompt = list(prompt)
        self.max_new = max_new
        self.eos_id = eos_id
        self.stream = stream
        self.state = _S_WAITING
        self.emitted: List[int] = []
        self.pos = len(self.prompt)      # tokens materialised in the KV cache
        self.prefilled = False
        self.enqueue_us = _now_us()
        self.last_token_us = 0
        self.deadline = deadline         # propagated tailguard.Deadline


class DecodeScheduler:
    """Continuous-batching loop over one
    :class:`~.engine.DecodeEndpoint`.

    One worker thread owns all device work (prefill and decode steps); a
    monitor thread supervises it and drives failover. Clients interact only
    through :meth:`submit` and the returned :class:`TokenStream`.
    """

    def __init__(self, engine, *, default_slo_ms: Optional[float] = None,
                 stream_buffer: Optional[int] = None,
                 poll_s: Optional[float] = None):
        self.engine = engine
        self._stats = engine.stats
        if default_slo_ms is None:
            default_slo_ms = float(_config.get("MXNET_DECODE_SLO_MS"))
        self._default_slo_us = default_slo_ms * 1000.0
        self._stream_buffer = int(
            stream_buffer if stream_buffer is not None
            else _config.get("MXNET_DECODE_STREAM_BUFFER"))
        self._poll_s = float(poll_s if poll_s is not None
                             else _config.get("MXNET_SUPERVISOR_POLL_S"))
        self._cond = threading.Condition(threading.Lock())
        self._state = _STOPPED
        self._epoch = 0
        self._thread: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._waiting: deque = deque()
        self._active: List[_Seq] = []       # RUNNING + PAUSED, batch order
        self._by_sid: Dict[int, _Seq] = {}
        self._sids = itertools.count(1)
        self._tenants: Dict[str, _Tenant] = {
            "default": _Tenant("default", self._default_slo_us)}
        self.reports: list = []             # failover reports, newest last

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def add_tenant(self, name: str, slo_ms: Optional[float] = None
                   ) -> "DecodeScheduler":
        """Register a tenant with its inter-token SLO (ms per token)."""
        slo_us = (float(slo_ms) * 1000.0 if slo_ms is not None
                  else self._default_slo_us)
        with self._cond:
            self._tenants[name] = _Tenant(name, slo_us)
        return self

    def start(self) -> "DecodeScheduler":
        with self._cond:
            if self._state == _RUNNING:
                return self
            self._state = _RUNNING
            self._spawn_worker_locked()
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop,
            name=f"mxt-decode-mon-{self.engine.name}", daemon=True)
        self._monitor.start()
        return self

    def _spawn_worker_locked(self):
        self._epoch += 1
        self._thread = threading.Thread(
            target=self._loop, args=(self._epoch,),
            name=f"mxt-decode-{self.engine.name}-gen{self._epoch}",
            daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the loop. ``drain=True`` (graceful) finishes every in-flight
        and waiting sequence first, refusing new submits; past ``timeout``
        seconds (``MXNET_SERVING_DRAIN_TIMEOUT_S`` by default) the remainder
        fail with ServerClosedError."""
        if timeout is None:
            timeout = float(_config.get("MXNET_SERVING_DRAIN_TIMEOUT_S"))
        with self._cond:
            if self._state == _STOPPED and self._thread is None:
                return
            self._state = _DRAINING if drain else _STOPPED
            t = self._thread
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=timeout if drain else 2.0)
        self._monitor_stop.set()
        m, self._monitor = self._monitor, None
        with self._cond:
            self._state = _STOPPED
            self._cond.notify_all()
            leftovers = list(self._active) + list(self._waiting)
            self._active.clear()
            self._waiting.clear()
            for seq in leftovers:
                self._retire_locked(
                    seq, _S_FAILED, "failed",
                    error=ServerClosedError(
                        f"decode scheduler for {self.engine.name!r} stopped "
                        f"before sequence {seq.sid} finished"))
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        if m is not None:
            m.join(timeout=self._poll_s * 4 + 1.0)

    def __enter__(self) -> "DecodeScheduler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               tenant: str = "default", eos_id: Optional[int] = None,
               on_token=None, deadline=None) -> TokenStream:
        """Queue one generation; returns its :class:`TokenStream`.

        The prompt plus generation budget (``MXNET_DECODE_MAX_TOKENS`` by
        default) must fit the endpoint's ``max_seq_len``: the whole KV
        budget is reserved at admission, so a running sequence never meets
        pool exhaustion mid-generation. ``deadline`` (a propagated
        ``tailguard.Deadline``) bounds the whole generation; under brownout
        ``max_new_tokens`` is clamped."""
        if deadline is not None:
            deadline.check("ingress")
        if max_new_tokens is None:
            max_new_tokens = int(_config.get("MXNET_DECODE_MAX_TOKENS"))
        max_new_tokens = _tailguard.BROWNOUT.clamp_max_new_tokens(
            max_new_tokens)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise MXNetError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = len(prompt) + max_new_tokens
        if total > self.engine.max_seq_len:
            raise MXNetError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds max_seq_len "
                f"{self.engine.max_seq_len}")
        with self._cond:
            if self._state != _RUNNING:
                raise ServerClosedError(
                    f"decode scheduler for {self.engine.name!r} is "
                    f"{self._state}; not accepting new sequences")
            ten = self._tenants.get(tenant)
            if ten is None:
                raise MXNetError(f"unknown tenant {tenant!r}; registered: "
                                 f"{sorted(self._tenants)}")
            sid = next(self._sids)
            stream = TokenStream(sid, self._stream_buffer,
                                 on_token=on_token, resume_cb=self._resume)
            seq = _Seq(sid, ten, prompt, int(max_new_tokens), eos_id, stream,
                       deadline=deadline)
            self._waiting.append(seq)
            self._by_sid[sid] = seq
            self._stats.seq_event("submitted")
            self._stats.set_queue_depth(len(self._waiting))
            self._cond.notify_all()
        return stream

    def _resume(self, sid: int):
        """Stream resume callback (consumer thread, stream lock NOT held)."""
        with self._cond:
            seq = self._by_sid.get(sid)
            if seq is not None and seq.state == _S_PAUSED:
                seq.state = _S_RUNNING
                self._stats.seq_event("resumed")
                self._cond.notify_all()

    # ------------------------------------------------------------------
    # the decode loop (worker thread)
    # ------------------------------------------------------------------
    def _loop(self, epoch: int):
        while True:
            with self._cond:
                if self._epoch != epoch:
                    return              # fenced-out dead generation
                if self._state == _STOPPED:
                    return
                if self._state == _DRAINING and not self._waiting \
                        and not self._active:
                    return
                if self._state == _RUNNING and not self._waiting \
                        and not self._active:
                    self._cond.wait(0.05)
                    continue
                admits = self._admit_locked()
            for seq in admits:
                if seq.prefilled:
                    continue            # requeued by failover: pages intact
                try:
                    tok = self.engine.prefill(
                        seq.prompt, self.engine.pool.table(seq.sid))
                except BaseException as e:
                    with self._cond:
                        self._fail_seq_locked(seq, e)
                    if not isinstance(e, Exception):
                        raise           # the thread dies; failover follows
                    continue
                seq.prefilled = True
                with self._cond:
                    if self._epoch != epoch:
                        return
                    self._emit_locked(seq, tok)
            with self._cond:
                if self._epoch != epoch:
                    return
                # the per-token deadline hop: a sequence whose budget ran
                # out is retired before it costs another step
                for s in list(self._active):
                    if s.state == _S_RUNNING and s.deadline is not None \
                            and s.deadline.expired():
                        _tailguard.deadline_expired("decode_token")
                        self._fail_seq_locked(s, DeadlineExceeded(
                            f"sequence {s.sid} overran its deadline after "
                            f"{len(s.emitted)} of {s.max_new} tokens"))
                rows = [s for s in self._active if s.state == _S_RUNNING]
                if not rows:
                    if not admits:
                        self._cond.wait(0.005)   # all paused / pool-blocked
                    continue
                batch = [(s, s.emitted[-1], s.pos,
                          self.engine.pool.table(s.sid)) for s in rows]
            try:
                _faults.check("decode")
                toks = self.engine.decode_step(
                    [(tok, pos, table) for _, tok, pos, table in batch])
            except _faults.FaultInjected as e:
                _telemetry.event("decode_fault_absorbed", kind=e.kind,
                                 endpoint=self.engine.name)
                continue                # transient: re-form and retry
            except Exception as e:
                with self._cond:
                    for s, _, _, _ in batch:
                        self._fail_seq_locked(s, e)
                continue
            # one decode step: a unit of work funding the decode tier's
            # retry budget (failover requeues spend from it)
            _tailguard.retry_deposit("decode")
            with self._cond:
                if self._epoch != epoch:
                    return              # replaced mid-step: the new
                                        # generation owns these sequences;
                                        # emitting now would duplicate
                for (s, _, _, _), tok in zip(batch, toks):
                    if s.state not in (_S_RUNNING, _S_PAUSED):
                        continue        # retired concurrently (cancel)
                    s.pos += 1
                    self._emit_locked(s, tok)

    def _admit_locked(self) -> List[_Seq]:
        """EDF admission: pull waiting sequences into free batch slots,
        most-negative slack first, reserving their whole KV budget. A
        sequence the pool cannot host yet stays queued (smaller later
        arrivals may still fit: no head-of-line blocking)."""
        free = self.engine.max_batch_size - len(self._active)
        if free <= 0 or not self._waiting:
            return []
        now = _now_us()
        rows = max(1, len(self._active))
        bucket = self.engine.decode_buckets[-1]
        for b in self.engine.decode_buckets:
            if rows <= b:
                bucket = b
                break
        per_tok = self.engine.step_cost.estimate(bucket) / max(1, rows)
        ordered = sorted(self._waiting,
                         key=lambda s: self._slack(s, now, per_tok))
        admits: List[_Seq] = []
        for seq in ordered:
            if len(admits) >= free:
                break
            try:
                self.engine.pool.reserve(seq.sid,
                                         len(seq.prompt) + seq.max_new)
            except KVPoolExhausted:
                continue                # stays queued; retried next step
            self._waiting.remove(seq)
            seq.state = _S_RUNNING
            self._active.append(seq)
            self._stats.seq_event("admitted")
            admits.append(seq)
        self._stats.set_queue_depth(len(self._waiting))
        return admits

    @staticmethod
    def _slack(seq: _Seq, now: int, per_tok_us: float) -> float:
        """EDF key: time left until the sequence's next token misses its
        tenant's inter-token SLO, minus the predicted cost of producing it.
        A requeued sequence's deadline anchors on its last emitted token, a
        fresh one on its enqueue time."""
        anchor = seq.last_token_us or seq.enqueue_us
        slo = seq.tenant.slo_us or 1e9      # SLO-less: FIFO by anchor
        return (anchor + slo) - now - per_tok_us

    # ------------------------------------------------------------------
    # emission / retirement (caller holds self._cond)
    # ------------------------------------------------------------------
    def _emit_locked(self, seq: _Seq, tok: int):
        now = _now_us()
        seq.emitted.append(tok)
        self._stats.tokens(1)
        if seq.last_token_us:
            self._stats.record_intertoken(seq.tenant.name,
                                          now - seq.last_token_us)
        seq.last_token_us = now
        delivered = seq.stream.put(tok)
        if seq.stream.cancelled:
            self._retire_locked(seq, _S_CANCELLED, "cancelled")
            return
        if (seq.eos_id is not None and tok == seq.eos_id) \
                or len(seq.emitted) >= seq.max_new:
            self._retire_locked(seq, _S_DONE, "finished")
            return
        if not delivered and seq.state == _S_RUNNING:
            seq.state = _S_PAUSED
            self._stats.seq_event("paused")
            self._stats.backpressure()

    def _retire_locked(self, seq: _Seq, state: str, event: str,
                       error: Optional[BaseException] = None):
        seq.state = state
        if seq in self._active:
            self._active.remove(seq)
        self.engine.pool.free(seq.sid)
        self._by_sid.pop(seq.sid, None)
        seq.stream.close(error)
        self._stats.seq_event(event)

    def _fail_seq_locked(self, seq: _Seq, error: BaseException):
        if seq in self._waiting:
            self._waiting.remove(seq)
        self._retire_locked(seq, _S_FAILED, "failed", error=error)

    # ------------------------------------------------------------------
    # supervision (monitor thread)
    # ------------------------------------------------------------------
    def _monitor_loop(self):
        while not self._monitor_stop.wait(self._poll_s):
            self._check_worker()

    def _check_worker(self):
        with self._cond:
            if self._state == _STOPPED:
                return
            t = self._thread
            if t is None or t.is_alive():
                return
            if self._state == _DRAINING and not self._waiting \
                    and not self._active:
                return      # drained: the worker left as stop() asked
            requeued, shed = [], 0
            for seq in [s for s in self._active if s.state == _S_RUNNING]:
                # a requeue retries the sequence's remaining tokens: it
                # must win a decode-budget token, so a crash-looping
                # worker ends in bounded shed
                if not _tailguard.retry_allowed("decode"):
                    self._retire_locked(seq, _S_FAILED, "failed",
                                        error=ServerClosedError(
                                            f"sequence {seq.sid} shed: decode "
                                            "retry budget exhausted during "
                                            "worker failover"))
                    shed += 1
                    continue
                self._active.remove(seq)
                seq.state = _S_WAITING
                self._waiting.appendleft(seq)
                self._stats.seq_event("requeued")
                requeued.append(seq)
            report = {
                "endpoint": self.engine.name,
                "reason": "worker_dead",
                "requeued": len(requeued),
                "shed": shed,
                "paused_kept": len(self._active),
                "epoch": self._epoch,
            }
            self.reports.append(report)
            self._stats.failover("worker_dead")
            self._spawn_worker_locked()
        _telemetry.event("decode_failover", **report)
        _flight.trigger("decode_failover", **report)

    @property
    def failovers(self) -> int:
        with self._cond:
            return len(self.reports)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._cond:
            return {
                "state": self._state,
                "epoch": self._epoch,
                "waiting": len(self._waiting),
                "running": sum(1 for s in self._active
                               if s.state == _S_RUNNING),
                "paused": sum(1 for s in self._active
                              if s.state == _S_PAUSED),
                "tenants": {n: t.slo_us / 1000.0
                            for n, t in self._tenants.items()},
                "failovers": len(self.reports),
            }
