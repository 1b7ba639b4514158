"""Serving-layer errors a client can branch on (the port of
``mxnet_tpu/serving/errors.py``): overload is retryable with backoff, a
missed deadline is not, a closed server is going away, a refused hot swap
left the old weights serving, an exhausted KV pool frees up as sequences
finish. All derive from MXNetError.

Every "the latency budget ran out" failure (queue expiry, a retry backoff
that cannot fit, a decode token past its budget) derives from
:class:`DeadlineExceeded`, so one ``except DeadlineExceeded`` catches the
family while ``RequestTimeoutError`` keeps its meaning (expired while
queued)."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "ServerOverloadError", "DeadlineExceeded",
           "RequestTimeoutError", "ServerClosedError", "HotSwapError",
           "KVPoolExhausted"]


class ServingError(MXNetError):
    """Base class for serving-layer failures."""


class ServerOverloadError(ServingError):
    """The bounded request queue is full; the request was rejected at
    admission (never enqueued). Retryable: back off and resubmit."""


class DeadlineExceeded(ServingError):
    """The request's end-to-end deadline ran out at some tier (ingress,
    queue, assembly, a retry backoff that could not fit, decode). Not
    retryable: the client's budget is spent."""


class RequestTimeoutError(DeadlineExceeded):
    """The request's deadline expired while it waited in the queue; it was
    dropped before reaching the device."""


class ServerClosedError(ServingError):
    """The server is stopped or draining and no longer admits new work."""


class HotSwapError(ServingError):
    """A weight hot swap was refused (corrupt or mismatched checkpoint) or
    its probe failed. The endpoint rolled back and keeps serving the
    previous weights."""


class KVPoolExhausted(ServingError):
    """The paged KV cache has no free pages for a new sequence's reservation.
    Retryable by waiting: running sequences release pages as they finish, so
    the decode scheduler keeps the sequence queued instead of failing it.
    The message carries the ``RESOURCE_EXHAUSTED`` marker a real device OOM
    carries, so message-based retry classifiers agree."""
