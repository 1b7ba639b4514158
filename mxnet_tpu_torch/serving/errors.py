"""Serving-layer errors a client can branch on (a copy of the part of
``mxnet_tpu/serving/errors.py`` the port's serial server and its decode
scheduler raise): overload is retryable with backoff, a missed deadline is
not, a closed server is going away, an exhausted KV pool frees up as
sequences finish. All derive from MXNetError."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "ServerOverloadError", "DeadlineExceeded",
           "RequestTimeoutError", "ServerClosedError", "KVPoolExhausted"]


class ServingError(MXNetError):
    """Base class for serving-layer failures."""


class ServerOverloadError(ServingError):
    """The bounded request queue is full; the request was rejected at
    admission (never enqueued). Retryable: back off and resubmit."""


class DeadlineExceeded(ServingError):
    """The request's deadline budget ran out. Not retryable."""


class RequestTimeoutError(DeadlineExceeded):
    """The request's deadline expired while it waited in the queue; it was
    dropped before reaching the device."""


class ServerClosedError(ServingError):
    """The server is stopped or draining and no longer admits new work."""


class KVPoolExhausted(ServingError):
    """The paged KV cache has no free pages for a new sequence's reservation.
    Retryable by waiting: running sequences release pages as they finish, so
    the decode scheduler keeps the sequence queued instead of failing it.
    The message carries the ``RESOURCE_EXHAUSTED`` marker a real device OOM
    carries, so message-based retry classifiers agree."""
