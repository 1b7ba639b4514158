"""Double-buffered host pipeline: batch k+1's prep overlaps device step k
(the port of ``mxnet_tpu/serving/pipeline.py``).

The serial loop pays assembly, padding and the host-to-device copy on the
critical path of every batch. In the pipelined server a prep thread
assembles the next batch while the worker executes the current one: it
writes request rows straight into the endpoint's staging slot for
(bucket, parity) and starts the slot's copy to the card on the prep
stream, and the worker's stream waits on the copy's event before the
forward (``ModelEndpoint.prepare``/``execute``).

**When prep assembles.** Not as soon as the handoff has room: a batch
sealed then misses every row that arrives during the rest of step k. The
prep stage holds a batch that is not yet a full bucket until the worker
is predicted to be free (the running step's start plus the step-cost
EWMA of its bucket, plus the EWMAs of the batches already waiting) less
the predicted prep time (``ModelEndpoint.prep_cost``), then assembles.
A full bucket cannot grow and assembles at once; so does everything
while the server drains.

**Depth.** ``MXNET_SERVING_PIPELINE_DEPTH`` (or ``InferenceServer(
pipeline_depth=)``) lets prep run d batches ahead; parities cycle over d+1
slots, so the slot prep writes is never one a queued or running batch
still references, and each slot's host buffers are rewritten only after
the event recorded behind its last batch's forward completed.

:class:`OverlapTracker` integrates device-busy time (the worker's host
clock between step begin and end) and credits each prep window only with
the busy time that overlapped it: ``ratio()`` is overlapped prep over all
prep (1.0: the host prep is hidden).

Only the worker runs the model; the prep stage only writes host buffers
and issues copies.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from .. import telemetry as _telemetry
from ..resilience import faults as _faults
from . import bucketing
from .batcher import Request, now_us
from .stats import set_prep_overlap_ratio

__all__ = ["PreparedBatch", "OverlapTracker", "prepare_batch"]


class PreparedBatch:
    """One dispatch unit: the staged slot and the requests whose rows it
    carries. Built by the prep stage, executed by the worker."""

    __slots__ = ("tenant", "requests", "rows", "staged", "parity",
                 "deadline_us", "prep_us")

    def __init__(self, tenant, requests: Sequence[Request], rows: int,
                 staged, parity: int, deadline_us: Optional[int],
                 prep_us: float):
        self.tenant = tenant
        self.requests = list(requests)
        self.rows = rows
        self.staged = staged
        self.parity = parity
        self.deadline_us = deadline_us
        self.prep_us = prep_us


class OverlapTracker:
    """Cumulative prep/step overlap: the worker brackets each device step
    with ``step_begin()``/``step_end()``, the prep stage reports each prep
    window with ``prep_window(t0, t1)``; overlap is the busy time elapsed
    between the window's ends (an integral, not a sample)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._busy_accum_us = 0.0
        self._busy_since: Optional[int] = None
        self.prep_us = 0.0
        self.overlap_us = 0.0
        self.steps = 0

    def _busy_at(self, t_us: int) -> float:
        # caller holds self._lock
        busy = self._busy_accum_us
        if self._busy_since is not None and t_us > self._busy_since:
            busy += t_us - self._busy_since
        return busy

    def step_begin(self):
        with self._lock:
            self._busy_since = now_us()

    def step_end(self):
        with self._lock:
            if self._busy_since is not None:
                self._busy_accum_us += now_us() - self._busy_since
                self._busy_since = None
            self.steps += 1

    def prep_window(self, t0_us: int, t1_us: int) -> float:
        """Record one prep window; returns the overlapped microseconds."""
        with self._lock:
            overlap = max(0.0, self._busy_at(t1_us) - self._busy_at(t0_us))
            self.prep_us += max(0, t1_us - t0_us)
            self.overlap_us += overlap
        return overlap

    def ratio(self) -> float:
        with self._lock:
            return (self.overlap_us / self.prep_us) if self.prep_us else 0.0


def prepare_batch(tenant, requests: List[Request], parity: int,
                  tracker: OverlapTracker, retry) -> PreparedBatch:
    """The host half of one dispatch: assemble the requests' rows into the
    (bucket, ``parity``) slot and start its copy to the device, on the
    current stream, under ``retry`` (site ``serving_prep``). Runs on the
    prep thread (pipelined) or on the worker (serial), without the server
    lock; raises on a failure the retries did not cure."""
    ep = tenant.endpoint
    rows = sum(r.rows for r in requests)
    deadlines = [r.deadline_us for r in requests if r.deadline_us is not None]
    deadline_us = min(deadlines) if deadlines else None

    def run_prep():
        _faults.check("serving_prep")
        bucket = bucketing.bucket_for(rows, ep.buckets)
        bufs = ep.staging_buffers(bucket, parity)
        off = 0
        for r in requests:
            for buf, rows_in in zip(bufs, r.inputs):
                buf[off:off + r.rows] = rows_in
            off += r.rows
        for buf in bufs:
            buf[rows:] = 0      # stale rows must not linger in the padding
        return ep.prepare(bufs, rows, parity=parity)

    t0 = now_us()
    # adopt the oldest request's trace id: the prep span joins the trace
    # the batch and device_step spans continue on the worker
    with _telemetry.span("serving.prep", trace_id=requests[0].trace_id,
                         endpoint=ep.name, rows=rows, parity=parity):
        staged = retry.run(run_prep, site="serving_prep",
                           deadline_us=deadline_us)
    t1 = now_us()
    tracker.prep_window(t0, t1)
    ep.prep_cost.observe(staged.bucket, t1 - t0)
    ep.stats.record_prep(t1 - t0)
    set_prep_overlap_ratio(tracker.ratio())
    return PreparedBatch(tenant, requests, rows, staged, parity, deadline_us,
                         t1 - t0)
