"""mxnet_tpu_torch.serving.generate: autoregressive decode serving (the port
of ``mxnet_tpu.serving.generate``).

A sequence costs one *prefill* step plus one *decode* step per generated
token, and the scheduling unit is the token, not the request. Four pieces
(one module each):

- :class:`PagedKVPool` (kv_cache.py): preallocated on-device K/V pools with
  per-sequence page tables; page 0 is a scratch page for masked writes and
  gathers.
- :class:`DecodeEndpoint` (engine.py): one generative model (the
  ``TransformerLM`` incremental-decode protocol) run in two bucket
  families: prefill by sequence length, decode step by batch size.
- :class:`DecodeScheduler` (scheduler.py): token-granularity continuous
  batching with EDF admission against per-tenant inter-token SLOs,
  lossless stream backpressure, graceful drain and worker failover.
- :class:`TokenStream` (streams.py): the client half, a bounded blocking
  iterator (or per-token callback).

Numerics contract (tested on the CPU): batched continuous decode is bitwise
equal to one-sequence-at-a-time greedy decode, with sequences joining and
retiring mid-batch and KV pages freed and reallocated between them. Masked
attention lanes carry an exactly-zero softmax weight, and every decode step
runs its matrix products on one fixed row count (see engine.py), so a row's
output depends only on its own tokens and pages.

    from mxnet_tpu_torch.serving.generate import (DecodeEndpoint,
                                                  DecodeScheduler)

    eng = DecodeEndpoint("lm", TransformerLM(...), max_seq_len=128)  # gpu(0)
    with DecodeScheduler(eng) as sched:
        stream = sched.submit([1, 2, 3], max_new_tokens=16)
        for tok in stream:
            ...

Or through the server facade: ``server.register_generator(eng)`` then
``server.generate("lm", prompt)``.
"""
from __future__ import annotations

from ..errors import KVPoolExhausted
from .engine import DecodeEndpoint
from .kv_cache import PagedKVPool, gather_ctx, write_prefill, write_step
from .scheduler import DecodeScheduler
from .stats import DecodeStats
from .streams import TokenStream

__all__ = ["DecodeEndpoint", "DecodeScheduler", "TokenStream", "PagedKVPool",
           "DecodeStats", "KVPoolExhausted", "gather_ctx", "write_prefill",
           "write_step"]
