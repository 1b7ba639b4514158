"""Environment flags of the port (the part of ``mxnet_tpu/config.py`` that
the generative serving path reads).

``get("MXNET_...")`` reads the process environment, coerced to the flag's
type, else the flag's default. Names, defaults and types are the
reference's (its ``set`` overrides are not ported).
"""
from __future__ import annotations

import os

from .base import MXNetError

__all__ = ["get"]

_FLAGS = {   # name: (default, type)
    # decode scheduler: how often the monitor thread checks that the decode
    # worker thread is alive (failover on its death)
    "MXNET_SUPERVISOR_POLL_S": (0.05, float),
    # DecodeScheduler.stop(drain=True): longest wait for the drain; past it
    # the remaining sequences fail with ServerClosedError
    "MXNET_SERVING_DRAIN_TIMEOUT_S": (30.0, float),
    # paged KV cache: token positions per page
    "MXNET_KV_PAGE_SIZE": (16, int),
    # paged KV cache: pages per pool (page 0 is the scratch page)
    "MXNET_KV_POOL_PAGES": (256, int),
    # paged KV cache: free() compacts the pool when the spread (highest live
    # page id / pages in use) exceeds this; 0 never
    "MXNET_KV_DEFRAG_RATIO": (0.0, float),
    # decode scheduler: most sequences a decode step advances (the top of
    # the pow2 decode-bucket ladder)
    "MXNET_DECODE_MAX_BATCH": (8, int),
    # decode scheduler: submit()'s default max_new_tokens
    "MXNET_DECODE_MAX_TOKENS": (64, int),
    # TokenStream: tokens buffered per stream before backpressure pauses
    # the sequence
    "MXNET_DECODE_STREAM_BUFFER": (64, int),
    # decode scheduler: default inter-token SLO (ms) of a tenant, priced
    # into EDF admission; 0 means FIFO admission
    "MXNET_DECODE_SLO_MS": (100.0, float),
}


def get(name: str):
    """A flag's value: the process environment's, coerced to the flag's
    type, else its default."""
    default, type_ = _FLAGS[name]
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return type_(raw)
    except ValueError as e:
        raise MXNetError(f"{name}={raw!r}: expected {type_.__name__}") from e
