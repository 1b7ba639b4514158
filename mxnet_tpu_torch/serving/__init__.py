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

Generative serving (``serving.generate``) rides beside it:

    eng = serving.generate.DecodeEndpoint("lm", lm, max_seq_len=512)
    server.register_generator(eng, tenants={"gold": 50.0})  # ms per token
    server.start()
    tokens = server.generate("lm", prompt, max_new_tokens=32).result()
"""
from __future__ import annotations

from . import bucketing, generate
from .endpoint import ModelEndpoint
from .errors import (DeadlineExceeded, KVPoolExhausted, RequestTimeoutError,
                     ServerClosedError, ServerOverloadError, ServingError)
from .server import InferenceServer

__all__ = ["ModelEndpoint", "InferenceServer", "bucketing", "generate",
           "ServingError", "ServerOverloadError", "DeadlineExceeded",
           "RequestTimeoutError", "ServerClosedError", "KVPoolExhausted"]
