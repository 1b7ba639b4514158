"""PreemptionGuard: a kill notice turned into a clean, resumable exit (the
port of ``mxnet_tpu/resilience/preemption.py``).

1. **Catch the notice**: SIGTERM (the handler installed on ``__enter__``
   and the previous one restored on ``__exit__``), :meth:`notify`, or the
   ``preempt`` fault kind polled at the ``preemption`` site once a step.
2. **Finish the step in flight**: :meth:`should_stop` is polled at the
   step boundary, so the state flushed is a whole step's.
3. **Flush within the deadline**: the NumericsGuard's pending windows are
   resolved, outstanding async writes joined (bounded), then the final
   checkpoint saved on this thread; the whole flush is measured against
   ``MXNET_PREEMPT_DEADLINE_S``.
4. **Leave a resumable marker**: ``PREEMPTED.json`` records the step, the
   reason and whether the flush beat the deadline; the next incarnation
   reads it with :meth:`resume_info`, restores and clears it.

Usage::

    cm = CheckpointManager("ckpts/", async_save=True)
    guard = PreemptionGuard(cm, capture=dict(train_step=step))
    with guard:
        for i, (x, y) in enumerate(batches, start=start_step + 1):
            step(x, y)
            if guard.should_stop(i):
                break
    info = PreemptionGuard.resume_info(cm)
    restored = cm.restore_latest(train_step=step)

Each handled notice counts in ``mxtpu_preemptions_total`` (by outcome:
flushed, the checkpoint landed inside the deadline, or deadline_exceeded),
its force-flush time lands in ``mxtpu_preempt_flush_duration_us``, and it
fires the ``preemption`` flight trigger.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Dict, Optional

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..telemetry import flight as _flight
from . import faults as _faults
from .checkpoint import CheckpointManager, capture_state

__all__ = ["PreemptionGuard"]

_PREEMPTIONS = _telemetry.counter(
    "mxtpu_preemptions_total",
    "Preemption notices handled by PreemptionGuard, by outcome: flushed "
    "(checkpoint landed inside the deadline) / deadline_exceeded (landed "
    "late or not at all — the marker says which step to distrust).",
    labelnames=("outcome",))
_FLUSH_DUR = _telemetry.histogram(
    "mxtpu_preempt_flush_duration_us",
    "Wall time of the preemption force-flush (join async writes + final "
    "checkpoint save), microseconds.")


class PreemptionGuard:
    """Preemption-aware training harness around a CheckpointManager.

    Parameters
    ----------
    manager : CheckpointManager
        Where the force-flushed checkpoint and the PREEMPTED.json marker go.
    capture : dict, optional
        Default ``capture_state`` kwargs for the flush (``train_step=``,
        ``dataloader=``, ...); :meth:`should_stop` kwargs override it.
    sharded : bool
        Flush with the sharded per-rank layout (elastic restore onto a
        different topology — the normal choice for preemption, since the
        replacement capacity rarely has the same shape).
    deadline_s : float, optional
        Grace budget for the whole flush (default
        ``MXNET_PREEMPT_DEADLINE_S``). The guard cannot abort a slow fsync,
        but it bounds the async-writer join and records honestly whether the
        flush beat the budget.
    signals : sequence of int
        Signals converted into preemption notices while the guard is active
        (default ``(SIGTERM,)``). Installed on ``__enter__``, previous
        handlers chained and restored on ``__exit__``; installation is
        skipped (with the poll/notify paths intact) off the main thread.
    numerics_guard : NumericsGuard, optional
        Finalized (pending health window read + any anomaly recovered)
        before the force-flush, so a preemption can never checkpoint NaN or
        spiked state — the flushed checkpoint is known-good.
    """

    def __init__(self, manager: CheckpointManager, capture: Optional[Dict] = None,
                 sharded: bool = False, deadline_s: Optional[float] = None,
                 signals=(signal.SIGTERM,), numerics_guard=None):
        self.manager = manager
        self.capture = dict(capture or {})
        self.sharded = bool(sharded)
        self.numerics_guard = numerics_guard
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else _config.get("MXNET_PREEMPT_DEADLINE_S"))
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._reason: Optional[str] = None
        self._old_handlers: Dict = {}
        self._flushed_step: Optional[int] = None
        self.last_flush: Optional[Dict] = None

    # ------------------------------------------------------------------
    # notice intake
    # ------------------------------------------------------------------
    def notify(self, reason: str = "maintenance_notice"):
        """Programmatic preemption notice (maintenance-event pollers, tests).
        Idempotent; the first reason wins."""
        if not self._requested.is_set():
            self._reason = reason
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def _on_signal(self, signum, frame):
        self.notify(f"signal:{signal.Signals(signum).name}")
        prev = self._old_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        for sig in self.signals:
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:      # not the main thread: poll/notify only
                self._old_handlers.pop(sig, None)
                break
        return self

    def __exit__(self, *exc):
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._old_handlers.clear()
        return False

    # ------------------------------------------------------------------
    # the step-boundary poll
    # ------------------------------------------------------------------
    def should_stop(self, step: int, **capture_overrides) -> bool:
        """Poll at the end of step ``step`` (which has fully completed).
        Returns False in the happy path. On a pending notice: force-flush a
        checkpoint of the current state within the deadline, write the
        resumable marker, and return True — the caller breaks its loop and
        exits. Safe to call again after True (idempotent: one flush)."""
        self._poll_injected()
        if not self._requested.is_set():
            return False
        if self._flushed_step is None:
            self._flush(int(step), capture_overrides or self.capture)
        return True

    def _poll_injected(self):
        try:
            _faults.check("preemption")
        except _faults.PreemptionNotice as e:
            self.notify(f"injected:{e.kind}")
        # any other injected kind at this site is a real error and propagates

    # ------------------------------------------------------------------
    # the bounded force-flush
    # ------------------------------------------------------------------
    def _flush(self, step: int, capture_kwargs: Dict):
        t0 = time.monotonic()
        deadline = t0 + self.deadline_s
        cm = self.manager
        errors = []
        # 0) resolve the numerics guard's pending window first: an anomaly
        #    sitting unread in the retained health scalars must be recovered
        #    (skip/rewind) BEFORE the state is flushed — a preemption that
        #    checkpoints NaN state preserves the outage, not the run
        if self.numerics_guard is not None:
            try:
                self.numerics_guard.finalize()
            except Exception as e:
                errors.append(f"numerics finalize: {e}")
        # 1) the in-flight async write first (it holds an OLDER step; saves
        #    land in order) — bounded so a wedged writer cannot eat the
        #    whole grace window
        try:
            cm.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except MXNetError as e:
            errors.append(str(e))
        # 2) the final checkpoint, synchronously on this thread: the state
        #    snapshot is cheap; the write is the honest cost of not losing
        #    the run
        saved = False
        try:
            state = capture_state(sharded=self.sharded, **capture_kwargs)
            cm._save_sync(step, state)
            saved = True
        except BaseException as e:      # noqa: BLE001 — must still write marker
            errors.append(str(e))
        elapsed = time.monotonic() - t0
        within = saved and elapsed <= self.deadline_s
        outcome = "flushed" if within else "deadline_exceeded"
        info = {"step": int(step), "reason": self._reason,
                "saved": bool(saved), "within_deadline": bool(within),
                "deadline_s": self.deadline_s,
                "flush_elapsed_s": round(elapsed, 3),
                "sharded": self.sharded, "wall_time": time.time(),
                "errors": errors}
        try:
            cm.write_preemption_marker(info)
        except OSError as e:            # the disk is going away with us
            errors.append(str(e))
        self._flushed_step = int(step)
        self.last_flush = info
        _PREEMPTIONS.labels(outcome).inc()
        _FLUSH_DUR.observe(int(elapsed * 1e6))
        _flight.trigger("preemption", outcome=outcome,
                        **{k: v for k, v in info.items() if k != "errors"},
                        errors="; ".join(errors)[:500])

    # ------------------------------------------------------------------
    # the resuming side
    # ------------------------------------------------------------------
    @staticmethod
    def resume_info(manager: CheckpointManager, consume: bool = True
                    ) -> Optional[Dict]:
        """The previous incarnation's preemption marker (or None). With
        ``consume=True`` the marker is cleared — a later crash is then not
        mistaken for a clean preemption."""
        info = manager.preemption_marker()
        if info is not None and consume:
            manager.clear_preemption_marker()
        return info
