"""RetryPolicy: exponential backoff with seeded jitter, and the
transient/fatal classification of errors (the port of
``mxnet_tpu/resilience/retry.py``).

Classification is structured first (``FaultInjected.retryable``,
``torch.OutOfMemoryError``, the NumericsGuard's errors), then by message
markers: XLA's (``RESOURCE_EXHAUSTED``, ``UNAVAILABLE``, ...) as the
reference reads them, and PyTorch's (``CUDA out of memory``). A CUDA error
that poisons the context (an illegal memory access, a device-side assert,
a launch failure) is fatal: every later call on that context fails too,
so only a new process can go on, from the latest checkpoint.

The jitter is drawn from ``random.Random(seed)`` as in the reference, so
:meth:`RetryPolicy.delay_ms` gives the reference's numbers for a seed.

``run(budget_tier=)`` spends one token of the serving tail guard's
per-tier retry budget (``serving/tailguard.py``) on every retry, so a
retry storm ends in bounded shed. Every retry counts in
``mxtpu_retries_total`` (by site and error) and records a ``retry`` flight
event; every out-of-memory error, retried or not, fires the ``oom`` flight
trigger, whose bundle carries the memstats holder breakdown taken while
the pins that exhausted the card are still live.
"""
from __future__ import annotations

import random as _pyrandom
import time
from typing import Callable, Optional

import torch

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from .faults import FaultInjected

__all__ = ["RetryPolicy", "classify_error", "is_oom_error",
           "RETRYABLE_MARKERS"]

_RETRIES = _telemetry.counter(
    "mxtpu_retries_total",
    "Retry attempts by call site and exception type; a steadily climbing "
    "rate means the stack is surviving on retries.",
    labelnames=("site", "error"))

#: substrings that mark a transient, retry-worthy failure
RETRYABLE_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                     "UNAVAILABLE", "ABORTED", "CANCELLED",
                     "Failed to allocate", "transient")

#: substrings that mark a deterministic failure retrying cannot fix;
#: checked first. The CUDA ones leave the context unusable ("sticky").
_FATAL_MARKERS = ("INVALID_ARGUMENT", "shape mismatch", "Incompatible shapes",
                  "dtype mismatch", "NOT_FOUND", "UNIMPLEMENTED",
                  "illegal memory access", "device-side assert",
                  "unspecified launch failure", "misaligned address",
                  "illegal instruction")

#: the retryable markers that mean a device allocation failed
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Failed to allocate")


def _numerics_error():
    from .numerics import NumericsError
    return NumericsError


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` looks like a device allocation failure."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc)
    if any(m in msg for m in _FATAL_MARKERS):
        return False
    return any(m in msg for m in _OOM_MARKERS)


def classify_error(exc: BaseException) -> bool:
    """True when ``exc`` is worth retrying (transient), False when fatal."""
    if isinstance(exc, FaultInjected):
        return exc.retryable
    if isinstance(exc, _numerics_error()):
        # re-running a NaN step reproduces the NaN: recovery is the
        # NumericsGuard's, never the retry loop's
        return False
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc)
    if any(m in msg for m in _FATAL_MARKERS):
        return False
    return any(m in msg for m in RETRYABLE_MARKERS)


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


def _retry_budget_allowed(tier: str) -> bool:
    """The tail guard's verdict for one retry at ``tier`` (imported here:
    the serving package imports this module)."""
    from ..serving import tailguard
    return tailguard.retry_allowed(tier)


class RetryPolicy:
    """``run(fn)`` calls ``fn`` up to ``max_attempts`` times, sleeping
    ``base_ms * multiplier**attempt`` (capped at ``max_ms``, jittered by
    +-``jitter``) between attempts. ``seed`` fixes the jitter sequence;
    ``classify`` overrides the transient/fatal split; ``sleep`` is
    injectable for tests. ``None`` takes the ``MXNET_RETRY_*`` flag."""

    def __init__(self, max_attempts: Optional[int] = None,
                 base_ms: Optional[float] = None,
                 max_ms: Optional[float] = None,
                 multiplier: Optional[float] = None,
                 jitter: Optional[float] = None,
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        g = _config.get
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else g("MXNET_RETRY_MAX_ATTEMPTS"))
        if self.max_attempts < 1:
            raise MXNetError("max_attempts must be >= 1")
        self.base_ms = float(base_ms if base_ms is not None
                             else g("MXNET_RETRY_BASE_MS"))
        self.max_ms = float(max_ms if max_ms is not None
                            else g("MXNET_RETRY_MAX_MS"))
        self.multiplier = float(multiplier if multiplier is not None
                                else g("MXNET_RETRY_MULTIPLIER"))
        self.jitter = float(jitter if jitter is not None
                            else g("MXNET_RETRY_JITTER"))
        self._classify = classify or classify_error
        self._rng = _pyrandom.Random(seed)
        self._sleep = sleep

    @classmethod
    def from_config(cls, seed: int = 0, **overrides) -> "RetryPolicy":
        return cls(seed=seed, **overrides)

    def delay_ms(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based), jittered."""
        raw = min(self.max_ms, self.base_ms * (self.multiplier ** attempt))
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(raw, 0.0)

    def run(self, fn: Callable, site: str = "generic",
            deadline_us: Optional[int] = None,
            on_retry: Optional[Callable] = None,
            budget_tier: Optional[str] = None):
        """Call ``fn()`` under this policy. ``deadline_us`` (absolute,
        ``time.perf_counter_ns() // 1000``) clamps each backoff to what is
        left and, when nothing is, raises the serving ``DeadlineExceeded``
        chained over the last error. ``budget_tier`` names a tail-guard
        retry budget ("execute", "decode", ...): each retry must win a
        token from it, and a dry bucket re-raises the last error. None
        leaves retries unbudgeted. ``on_retry(exc, attempt, delay_s)`` runs
        before each sleep; raising from it aborts the retry (the train step
        refuses once its in-place update has begun)."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                if is_oom_error(e):
                    # OOM post-mortem: the bundle snapshots the holder table
                    # while the pins that caused the exhaustion are live.
                    # Fires for retried and fatal OOMs (rate-limited inside
                    # the trigger, which never raises)
                    _telemetry.flight.trigger(
                        "oom", site=site, error=type(e).__name__,
                        attempt=attempt, message=str(e)[:200])
                if not self._classify(e) or attempt + 1 >= self.max_attempts:
                    raise
                delay_s = self.delay_ms(attempt) / 1e3
                if deadline_us is not None:
                    remaining_s = (deadline_us - _now_us()) / 1e6
                    if remaining_s <= 0:
                        from ..serving.errors import DeadlineExceeded
                        raise DeadlineExceeded(
                            f"retry at {site!r} abandoned: deadline spent "
                            f"after attempt {attempt + 1} "
                            f"({type(e).__name__}: {str(e)[:120]})") from e
                    delay_s = min(delay_s, remaining_s)
                if budget_tier is not None and \
                        not _retry_budget_allowed(budget_tier):
                    raise
                if on_retry is not None:
                    on_retry(e, attempt, delay_s)
                _RETRIES.labels(site, type(e).__name__).inc()
                _telemetry.event("retry", site=site,
                                 error=type(e).__name__, attempt=attempt,
                                 delay_ms=round(delay_s * 1e3, 3))
                self._sleep(delay_s)
                attempt += 1

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base_ms={self.base_ms}, max_ms={self.max_ms}, "
                f"multiplier={self.multiplier}, jitter={self.jitter})")
