"""Dynamic batcher: per-endpoint bounded request queue + batch assembly (a
copy of the core of ``mxnet_tpu/serving/batcher.py``).

A queue is *ready* when it holds ``max_batch_size`` rows, when its oldest
request has waited ``batch_timeout_us``, or when the server drains.
Assembly fails and drops requests whose deadline passed before they take
device rows. Admission is row-based: ``offer`` refuses once
``max_queue_rows`` rows wait. All mutation happens under the server's
condition lock; the batcher never blocks and never touches the device.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .errors import RequestTimeoutError

__all__ = ["Request", "EndpointQueue", "concat_inputs", "resolve", "fail"]


def resolve(fut: Future, value):
    """set_result that tolerates an already-settled future."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


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
    resolves with sliced outputs (or an error)."""

    __slots__ = ("inputs", "rows", "squeeze", "enqueue_us", "deadline_us",
                 "future")

    def __init__(self, inputs: Tuple[np.ndarray, ...], rows: int,
                 squeeze: bool, deadline_ms: Optional[float] = None):
        self.inputs = inputs
        self.rows = rows
        self.squeeze = squeeze            # single example: drop the batch axis
        self.enqueue_us = now_us()
        self.deadline_us = (self.enqueue_us + int(deadline_ms * 1000)
                            if deadline_ms is not None else None)
        self.future: Future = Future()

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
        return True

    def ready(self, at_us: int, flush: bool = False) -> bool:
        if not self._pending:
            return False
        if flush or self.pending_rows >= self.endpoint.max_batch_size:
            return True
        return at_us - self._pending[0].enqueue_us >= self.batch_timeout_us

    def next_wakeup_us(self) -> Optional[int]:
        """Absolute time at which the head request hits the batch timeout."""
        if not self._pending:
            return None
        return self._pending[0].enqueue_us + self.batch_timeout_us

    def head_enqueue_us(self) -> int:
        return self._pending[0].enqueue_us

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
                fail(head.future, RequestTimeoutError(
                    f"deadline expired after "
                    f"{(at_us - head.enqueue_us) / 1e3:.1f} ms in queue"))
                continue
            if rows + head.rows > ep.max_batch_size:
                break
            self._pending.popleft()
            self.pending_rows -= head.rows
            batch.append(head)
            rows += head.rows
        return batch

    def fail_all(self, exc: Exception) -> int:
        """Fail every pending future; returns how many."""
        n = 0
        while self._pending:
            req = self._pending.popleft()
            self.pending_rows -= req.rows
            self.endpoint.stats.bump("cancelled")
            fail(req.future, exc)
            n += 1
        return n


def concat_inputs(reqs: Sequence[Request], num_inputs: int
                  ) -> Tuple[np.ndarray, ...]:
    """Concatenate per-request host inputs into one batch per model input."""
    return tuple(
        np.concatenate([r.inputs[i] for r in reqs], axis=0)
        if len(reqs) > 1 else reqs[0].inputs[i]
        for i in range(num_inputs))
