"""Deterministic, seedable fault injection (the port of
``mxnet_tpu/resilience/faults.py``).

Production code calls :func:`check` at a few named boundaries, and tests
scope injections with :func:`inject`::

    with faults.inject("device_oom", every_n=3):
        for _ in range(20):
            step(x, y)          # every 3rd attempt raises a retryable OOM

The boundaries (``SITES``) are the reference's:

    ``train_step``        ParallelTrainStep, before each attempt's compute
    ``compile``           the first run of a train step or of a decode bucket
    ``serving_dispatch``  InferenceServer's device batch step
    ``serving_prep``      the serving host pipeline
    ``checkpoint_write``  CheckpointManager, between file write and fsync
    ``preemption``        PreemptionGuard's poll point, once per step
    ``numerics``          NumericsGuard's input shim, once per guarded step
    ``sdc``               NumericsGuard's SDC re-execution, once per verify
    ``decode``            the decode scheduler's step boundary and
                          PagedKVPool.reserve
    ``exec_cache``        the executable cache's load (``cache_poison``
                          becomes a real truncated payload on disk)
    ``emb_dispatch``      DLRMTrainStep, before the step's exchange
    ``pool_submit``       ServingPool.submit
    ``frontdoor``         FrontDoor.submit, the hop to a host (``net_delay``,
                          ``net_drop``)

``check`` is one truthiness test when nothing is injected. ``every_n`` and
``at`` count matching calls exactly; ``p=`` draws from a private
``random.Random(seed)``, so the firing sequence for a seed equals the
reference's. A ``device_oom`` message carries both XLA's marker
(``RESOURCE_EXHAUSTED``) and PyTorch's (``CUDA out of memory``), so either
classifier sees a real OOM's picture. The ``numerics``/``sdc`` kinds are
consumed by the NumericsGuard, which turns them into the corruption they
simulate.

Every fired fault counts in ``mxtpu_faults_injected_total`` (by kind and
site).
"""
from __future__ import annotations

import random as _pyrandom
import threading
import time
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

from .. import telemetry as _telemetry
from ..base import MXNetError

__all__ = ["FaultInjected", "SimulatedCrash", "PreemptionNotice",
           "WorkerKilled", "inject", "check", "active_kinds", "SITES"]

#: boundaries where production code calls :func:`check`
SITES = ("train_step", "compile", "serving_dispatch", "serving_prep",
         "checkpoint_write", "preemption", "numerics", "sdc", "decode",
         "exec_cache", "emb_dispatch", "frontdoor", "pool_submit")

#: faults raised (or slept) so far, by (kind, site)
_INJECTED = _telemetry.counter(
    "mxtpu_faults_injected_total",
    "Faults raised by the injection harness, by kind and site.",
    labelnames=("kind", "site"))


class FaultInjected(MXNetError):
    """An error raised by the fault harness. ``retryable`` says how the
    retry classifier treats the simulated failure."""

    def __init__(self, kind: str, site: str, count: int, retryable: bool,
                 message: str):
        super().__init__(message)
        self.kind = kind
        self.site = site
        self.count = count
        self.retryable = retryable


class SimulatedCrash(FaultInjected):
    """A simulated process death (checkpoint writer killed mid-write)."""


class PreemptionNotice(FaultInjected):
    """A simulated maintenance or preemption notice, raised at the
    ``preemption`` poll site; the PreemptionGuard converts it into a
    requested preemption."""


class WorkerKilled(BaseException):
    """A simulated worker-thread death. A ``BaseException``, so it passes
    every ``except Exception`` recovery layer and kills the thread itself;
    the decode scheduler's failover is the recovery."""

    def __init__(self, kind: str, site: str, count: int, retryable: bool,
                 message: str):
        super().__init__(message)
        self.kind = kind
        self.site = site
        self.count = count
        self.retryable = retryable


# kind -> (default sites, retryable, message template); the message carries
# the marker a real failure of that kind carries
_KINDS = {
    "device_oom": (("train_step", "serving_dispatch"), True,
                   "RESOURCE_EXHAUSTED: CUDA out of memory. Out of memory "
                   "allocating device buffer "
                   "(injected {kind} #{count} at {site})"),
    "compile_error": (("compile",), True,
                      "UNAVAILABLE: transient compilation failure "
                      "(injected {kind} #{count} at {site})"),
    "unavailable": (("serving_dispatch",), True,
                    "UNAVAILABLE: device unreachable "
                    "(injected {kind} #{count} at {site})"),
    "shape_mismatch": (("train_step", "serving_dispatch"), False,
                       "INVALID_ARGUMENT: shape mismatch "
                       "(injected {kind} #{count} at {site})"),
    "crash": (("checkpoint_write",), False,
              "simulated crash: writer killed "
              "(injected {kind} #{count} at {site})"),
    "hang": (("train_step", "serving_dispatch"), True, ""),
    "preempt": (("preemption",), False,
                "maintenance notice: instance scheduled for preemption "
                "(injected {kind} #{count} at {site})"),
    "worker_kill": (("serving_dispatch", "serving_prep"), False,
                    "simulated worker death: thread killed "
                    "(injected {kind} #{count} at {site})"),
    "nan_grad": (("numerics",), False,
                 "numerics: non-finite gradient "
                 "(injected {kind} #{count} at {site})"),
    "loss_spike": (("numerics",), False,
                   "numerics: loss spike "
                   "(injected {kind} #{count} at {site})"),
    "bad_batch": (("numerics",), False,
                  "numerics: poisoned input batch "
                  "(injected {kind} #{count} at {site})"),
    "sdc": (("sdc",), False,
            "silent data corruption: re-executed step diverged "
            "(injected {kind} #{count} at {site})"),
    "decode_stall": (("decode",), False,
                     "simulated decode stall: generation worker "
                     "unresponsive mid-sequence "
                     "(injected {kind} #{count} at {site})"),
    "kv_exhausted": (("decode",), True,
                     "RESOURCE_EXHAUSTED: KV cache pool out of pages "
                     "(injected {kind} #{count} at {site})"),
    "cache_poison": (("exec_cache",), False,
                     "executable cache entry poisoned on disk "
                     "(injected {kind} #{count} at {site})"),
    "emb_exchange": (("emb_dispatch",), True,
                     "RESOURCE_EXHAUSTED: embedding exchange buffer "
                     "allocation failed mid-dispatch "
                     "(injected {kind} #{count} at {site})"),
    "net_delay": (("frontdoor", "pool_submit"), True, ""),
    "net_drop": (("frontdoor",), True,
                 "UNAVAILABLE: network partition dropped the request at "
                 "the front door (injected {kind} #{count} at {site})"),
    "replica_straggler": (("serving_dispatch", "pool_submit", "decode"),
                          True, ""),
}

#: kinds that raise a dedicated exception class instead of FaultInjected
_KIND_CLS = {"crash": SimulatedCrash, "preempt": PreemptionNotice,
             "worker_kill": WorkerKilled, "decode_stall": WorkerKilled}

#: kinds that stall (sleep ``seconds``) instead of raising
_SLEEP_KINDS = ("hang", "net_delay", "replica_straggler")

_LOCK = threading.Lock()
_ACTIVE: list = []          # the hot-path gate: empty list == harness off


class _Injection:
    """One scoped injection rule; counting is per rule over matching
    sites."""

    def __init__(self, kind: str, sites: Tuple[str, ...], retryable: bool,
                 every_n: Optional[int], at: Tuple[int, ...],
                 times: Optional[int], p: Optional[float], seed: int,
                 seconds: float, exc_factory):
        self.kind = kind
        self.sites = sites
        self.retryable = retryable
        self.every_n = every_n
        self.at = at
        self.times = times
        self.p = p
        self.seconds = seconds
        self._rng = _pyrandom.Random(seed)
        self._exc_factory = exc_factory
        self.calls = 0          # matching check() calls seen
        self.fires = 0          # faults actually raised or slept

    def _should_fire(self) -> bool:
        if self.times is not None and self.fires >= self.times:
            return False
        if self.at:
            return self.calls in self.at
        if self.every_n is not None:
            return self.calls % self.every_n == 0
        if self.p is not None:
            return self._rng.random() < self.p
        return True             # bare inject(kind): fire on every call

    def visit(self, site: str):
        """Count a matching check call; the exception to raise when the
        rule fires (a stall kind sleeps instead)."""
        if site not in self.sites:
            return None
        with _LOCK:
            self.calls += 1
            if not self._should_fire():
                return None
            self.fires += 1
            count = self.fires
        _INJECTED.labels(self.kind, site).inc()
        if self.kind in _SLEEP_KINDS:
            time.sleep(self.seconds)
            return None
        if self._exc_factory is not None:
            return self._exc_factory(self.kind, site, count)
        tmpl = _KINDS[self.kind][2]
        msg = tmpl.format(kind=self.kind, count=count, site=site)
        cls = _KIND_CLS.get(self.kind, FaultInjected)
        return cls(self.kind, site, count, self.retryable, msg)


@contextmanager
def inject(kind: str, site=None, every_n: Optional[int] = None,
           at: Sequence[int] = (), times: Optional[int] = None,
           p: Optional[float] = None, seed: int = 0, seconds: float = 0.05,
           retryable: Optional[bool] = None, exc=None):
    """Scope a fault injection rule: ``kind`` (its default sites,
    retryability and message), ``site`` (a site or sites instead),
    ``every_n`` (every n-th matching call), ``at`` (these 1-based matching
    calls), ``times`` (a cap on fires), ``p`` (probability, drawn from
    ``random.Random(seed)``), ``seconds`` (a stall kind's sleep),
    ``retryable`` (override) and ``exc`` (``exc(kind, site, count)`` makes
    the error). Yields the rule (``.calls``, ``.fires``)."""
    if kind not in _KINDS:
        raise MXNetError(f"unknown fault kind {kind!r}; known: "
                         f"{sorted(_KINDS)}")
    default_sites, default_retry, _ = _KINDS[kind]
    if site is None:
        sites = default_sites
    elif isinstance(site, str):
        sites = (site,)
    else:
        sites = tuple(site)
    for s in sites:
        if s not in SITES:
            raise MXNetError(f"unknown fault site {s!r}; known: {SITES}")
    inj = _Injection(kind, sites,
                     default_retry if retryable is None else bool(retryable),
                     every_n, tuple(at), times, p, seed, seconds, exc)
    with _LOCK:
        _ACTIVE.append(inj)
    try:
        yield inj
    finally:
        with _LOCK:
            _ACTIVE.remove(inj)


def check(site: str):
    """Raise the active injected fault for ``site``, if any (one
    truthiness test when no injection is scoped)."""
    if not _ACTIVE:
        return
    for inj in list(_ACTIVE):
        exc = inj.visit(site)
        if exc is not None:
            raise exc


def active_kinds():
    """Kinds currently scoped."""
    with _LOCK:
        return sorted({inj.kind for inj in _ACTIVE})
