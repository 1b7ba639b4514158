"""PoolSupervisor: declare a dead or wedged serving worker and fail it over
(the port of ``mxnet_tpu/serving/supervisor.py``).

The server's own recovery handles failures that return: a raising step
retries, then fails its batch and feeds the tenant's breaker. Two shapes
escape it: the worker (or prep) thread **dies** (nothing dispatches again
while the server looks healthy), or the worker **wedges** in a step that
never returns (the Watchdog flags it and degrades the tenant's breaker,
but the batch and everything queued behind it are stuck).

The supervisor polls the threads' liveness every
``MXNET_SUPERVISOR_POLL_S`` and subscribes to the server's stall events
(confirming that the flagged batch is still the one in flight, so a step
that ran long but finished is never failed over); on either verdict it
calls ``InferenceServer.failover()``, which requeues the dead generation's
batches at the front of their queues, trips only the affected tenant's
breaker and starts a new generation. ``reports`` keeps each failover's
report, and each is also recorded as a ``supervisor_failover`` flight
event (the server's failover counts it in
``mxtpu_serving_failovers_total``).

Drill: the ``worker_kill`` fault raises a BaseException that passes the
retry and batch-failure handling and kills the thread::

    with PoolSupervisor(server):
        with faults.inject("worker_kill", site="serving_dispatch", times=1):
            ...                      # the supervisor restarts the worker
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from .server import InferenceServer, _RUNNING

__all__ = ["PoolSupervisor"]

log = logging.getLogger("mxnet_tpu_torch.serving.supervisor")


class PoolSupervisor:
    """Watches one InferenceServer's threads for death or a wedge, and
    fails the server over.

    Parameters
    ----------
    server : InferenceServer
        The server whose worker/prep threads are supervised.
    poll_s : float, optional
        Poll interval (default ``MXNET_SUPERVISOR_POLL_S``).
    """

    def __init__(self, server: InferenceServer, poll_s: Optional[float] = None):
        self._server = server
        self.poll_s = float(poll_s if poll_s is not None
                            else _config.get("MXNET_SUPERVISOR_POLL_S"))
        if self.poll_s <= 0:
            raise MXNetError("poll_s must be > 0")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._stalled = None        # the in-flight batch the watchdog flagged
        self.reports: list = []     # failover reports, newest last

    def start(self) -> "PoolSupervisor":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._server.add_stall_listener(self._on_stall)
            self._thread = threading.Thread(
                target=self._run, name="mxt-pool-supervisor", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop.set()
            t, self._thread = self._thread, None
        self._server.remove_stall_listener(self._on_stall)
        if t is not None:
            t.join(timeout=self.poll_s * 4 + 1.0)

    def __enter__(self) -> "PoolSupervisor":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _on_stall(self, name: str, dt: float):
        """Watchdog listener (its thread; must not block): remember which
        in-flight batch stalled; the poll confirms it before failing over."""
        srv = self._server
        ep_name = name.partition("[")[2].rstrip("]")
        with srv._cond:
            pb = srv._inflight
        if pb is not None and pb.tenant.name == ep_name:
            with self._lock:
                self._stalled = pb

    def _run(self):
        while not self._stop.wait(self.poll_s):
            try:
                self._check()
            except Exception:   # supervision outlives any one bad poll
                log.exception("supervisor poll failed")

    def _check(self):
        srv = self._server
        with srv._cond:
            if srv._state != _RUNNING:
                with self._lock:
                    self._stalled = None
                return
            worker, prep = srv._thread, srv._prep_thread
            inflight, preparing = srv._inflight, srv._preparing
            pipeline = srv._pipeline
        if worker is None:
            return
        with self._lock:
            stalled = self._stalled
        report = None
        if not worker.is_alive():
            name = inflight.tenant.name if inflight is not None else \
                (preparing[0].name if preparing is not None else None)
            report = srv.failover("worker_dead", tenant_name=name)
        elif pipeline and prep is not None and not prep.is_alive():
            name = preparing[0].name if preparing is not None else None
            report = srv.failover("prep_dead", tenant_name=name)
        elif stalled is not None:
            if stalled is inflight:
                report = srv.failover("worker_wedged",
                                      tenant_name=stalled.tenant.name)
            else:
                with self._lock:    # the stalled step finished after all
                    if self._stalled is stalled:
                        self._stalled = None
        if report is not None:
            with self._lock:
                self._stalled = None
                self.reports.append(report)
            _telemetry.event("supervisor_failover", **report)

    @property
    def failovers(self) -> int:
        with self._lock:
            return len(self.reports)
