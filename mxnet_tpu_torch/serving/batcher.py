"""Dynamic batcher: per-endpoint bounded request queue + batch assembly
(the port of ``mxnet_tpu/serving/batcher.py``).

A queue is *ready* when it holds ``max_batch_size`` rows, when its oldest
request has waited the batch timeout (widened by the brownout ladder's
boost), or when the server drains. Assembly fails and drops requests whose
deadline passed before they take device rows; a request's deadline is its
propagated ``tailguard.Deadline`` when it carries one, else its own
``deadline_ms``. Admission is row-based: ``offer`` refuses once
``max_queue_rows`` rows wait; ``requeue_front`` puts a failed-over
worker's requests back at the head. All mutation happens under the
server's condition lock; the batcher never blocks and never touches the
device.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import telemetry as _telemetry
from . import tailguard as _tailguard
from .errors import RequestTimeoutError

__all__ = ["Request", "EndpointQueue", "resolve", "fail"]


def resolve(fut: Future, value) -> bool:
    """set_result that tolerates an already-settled future (a cancelled
    hedge loser, a request a failover handed to another worker); returns
    whether this call settled it."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        return False
    return True


def fail(fut: Future, exc: Exception):
    """set_exception with the same narrow tolerance as :func:`resolve`."""
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


def now_us() -> int:
    return time.perf_counter_ns() // 1000


class Request:
    """One admitted request: host input rows and the Future the worker
    resolves with sliced outputs (or an error). A propagated ``deadline``
    (``tailguard.Deadline``, minted at ingress) wins over ``deadline_ms``.
    ``trace_id`` is stamped at submit (the submitter's telemetry span, if
    any, else a new id) and adopted by the worker thread around batch
    assembly and the device step: a context variable does not cross the
    queue hop, the request carries the id across it."""

    __slots__ = ("inputs", "rows", "squeeze", "enqueue_us", "deadline_us",
                 "deadline", "future", "assembled", "trace_id")

    def __init__(self, inputs: Tuple[np.ndarray, ...], rows: int,
                 squeeze: bool, deadline_ms: Optional[float] = None,
                 deadline=None):
        self.inputs = inputs
        self.rows = rows
        self.squeeze = squeeze            # single example: drop the batch axis
        self.enqueue_us = now_us()
        self.deadline = deadline
        if deadline is not None:
            self.deadline_us: Optional[int] = int(deadline.deadline_us)
        else:
            self.deadline_us = (self.enqueue_us + int(deadline_ms * 1000)
                                if deadline_ms is not None else None)
        self.future: Future = Future()
        self.assembled = False      # queue wait is recorded once
        self.trace_id = (_telemetry.current_trace_id()
                         or _telemetry.new_trace_id())

    def expired(self, at_us: int) -> bool:
        return self.deadline_us is not None and at_us > self.deadline_us


class EndpointQueue:
    """FIFO of admitted requests for one endpoint, with row accounting."""

    def __init__(self, endpoint, max_queue_rows: int, batch_timeout_us: int):
        self.endpoint = endpoint
        self.max_queue_rows = max_queue_rows
        self.batch_timeout_us = batch_timeout_us
        self._pending: "deque[Request]" = deque()
        self.pending_rows = 0

    def __len__(self):
        return len(self._pending)

    def offer(self, req: Request) -> bool:
        """Admit ``req`` unless the bounded queue is full (then False, and
        the request is not enqueued)."""
        if self.pending_rows + req.rows > self.max_queue_rows:
            self.endpoint.stats.bump("rejected")
            return False
        self._pending.append(req)
        self.pending_rows += req.rows
        self.endpoint.stats.bump("submitted")
        self.endpoint.stats.set_queue_depth(self.pending_rows)
        return True

    def effective_timeout_us(self) -> int:
        """The batch window in force now: the configured timeout widened
        by the brownout ladder's boost."""
        return int(self.batch_timeout_us *
                   _tailguard.BROWNOUT.timeout_boost())

    def ready(self, at_us: int, flush: bool = False) -> bool:
        if not self._pending:
            return False
        if flush or self.pending_rows >= self.endpoint.max_batch_size:
            return True
        return at_us - self._pending[0].enqueue_us >= \
            self.effective_timeout_us()

    def next_wakeup_us(self) -> Optional[int]:
        """Absolute time at which the head request hits the batch timeout."""
        if not self._pending:
            return None
        return self._pending[0].enqueue_us + self.effective_timeout_us()

    def head_enqueue_us(self) -> int:
        return self._pending[0].enqueue_us

    def head_deadline_us(self) -> Optional[int]:
        """The head request's explicit deadline, when it carries one."""
        return self._pending[0].deadline_us

    def take_batch(self, at_us: int) -> List[Request]:
        """Pop a FIFO prefix that fits max_batch_size rows, failing and
        dropping requests that were cancelled or whose deadline passed. May
        return [] when every pending request had expired."""
        ep = self.endpoint
        batch: List[Request] = []
        rows = 0
        while self._pending:
            head = self._pending[0]
            if head.future.cancelled():
                self._pending.popleft()
                self.pending_rows -= head.rows
                ep.stats.bump("cancelled")
                continue
            if head.expired(at_us):
                self._pending.popleft()
                self.pending_rows -= head.rows
                ep.stats.bump("deadline_drops")
                _tailguard.deadline_expired("queue")
                fail(head.future, RequestTimeoutError(
                    f"deadline expired after "
                    f"{(at_us - head.enqueue_us) / 1e3:.1f} ms in queue"))
                continue
            if rows + head.rows > ep.max_batch_size:
                break
            self._pending.popleft()
            self.pending_rows -= head.rows
            # queue wait ends at the first assembly (a failover's requeue
            # does not count it again); prep and the step come after
            if not head.assembled:
                head.assembled = True
                ep.stats.record_queue_wait(max(at_us - head.enqueue_us, 0))
            batch.append(head)
            rows += head.rows
        ep.stats.set_queue_depth(self.pending_rows)
        return batch

    def requeue_front(self, requests: Sequence[Request]):
        """Push admitted requests back at the head in their order (a
        failed-over worker's batches). Ignores the row bound: they were
        admitted once and keep their enqueue time and deadline, so expiry
        at re-assembly still applies."""
        for r in reversed(list(requests)):
            self._pending.appendleft(r)
            self.pending_rows += r.rows
        self.endpoint.stats.set_queue_depth(self.pending_rows)

    def fail_all(self, exc: Exception, counter: str = "cancelled") -> int:
        """Fail every pending future, counting each under ``counter``;
        returns how many."""
        n = 0
        while self._pending:
            req = self._pending.popleft()
            self.pending_rows -= req.rows
            self.endpoint.stats.bump(counter)
            fail(req.future, exc)
            n += 1
        self.endpoint.stats.set_queue_depth(0)
        return n

