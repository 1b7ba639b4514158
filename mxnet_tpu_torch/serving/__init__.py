"""mxnet_tpu_torch.serving — dynamic-batching inference on the card (the
port of ``mxnet_tpu.serving``'s serial path).

    from mxnet_tpu_torch import serving

    ep = serving.ModelEndpoint("bert", net, [(512,), (512,)], dtype="int32",
                               max_batch_size=32)      # ctx defaults to gpu(0)
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=256)
    server.register(ep)                                 # runs every bucket once
    server.start()
    seq, pooled = server.predict("bert", (tokens, token_types))
    server.stop(drain=True)

A served output equals the direct forward of the same rows up to the
rounding of the bucket's batch size (padding rows never mix into real
rows). ``ep.stats.snapshot()`` reports counters and latency quantiles.
"""
from __future__ import annotations

from . import bucketing
from .endpoint import ModelEndpoint
from .errors import (DeadlineExceeded, RequestTimeoutError, ServerClosedError,
                     ServerOverloadError, ServingError)
from .server import InferenceServer

__all__ = ["ModelEndpoint", "InferenceServer", "bucketing", "ServingError",
           "ServerOverloadError", "DeadlineExceeded", "RequestTimeoutError",
           "ServerClosedError"]
