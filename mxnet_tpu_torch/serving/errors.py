"""Serving-layer errors a client can branch on (a copy of the part of
``mxnet_tpu/serving/errors.py`` the port's serial server raises): overload
is retryable with backoff, a missed deadline is not, a closed server is
going away. All derive from MXNetError."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "ServerOverloadError", "DeadlineExceeded",
           "RequestTimeoutError", "ServerClosedError"]


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
