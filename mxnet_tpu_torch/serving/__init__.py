"""mxnet_tpu_torch.serving — multi-tenant dynamic-batching
inference on the card (the port of ``mxnet_tpu.serving``).

    from mxnet_tpu_torch import serving

    ep = serving.ModelEndpoint("bert", net, [(512,), (512,)], dtype="int32",
                               max_batch_size=32)      # ctx defaults to gpu(0)
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=256)
    server.register(ep, slo_ms=200.0)                  # runs every bucket once
    server.start()
    seq, pooled = server.predict("bert", (tokens, token_types))
    server.hot_swap("bert", "/ckpts/bert")             # between two batches
    server.stop(drain=True)

- **Router** (``router.py``): the tenants share one dispatch path; the
  next batch is picked earliest-deadline-first, priced by each bucket's
  measured step time, shortest job first among late tenants.
- **Host pipeline** (``pipeline.py``, ``InferenceServer(pipeline=True)``):
  a prep thread assembles batch k+1 into pinned staging slots and copies
  it to the card on its own stream while the worker runs step k. The
  default is the serial loop, the bitwise reference of the pipelined one.
- **Per-tenant breakers, retries and the watchdog**; ``PoolSupervisor``
  fails a dead or wedged worker over; ``hot_swap`` validates a checkpoint's
  weights with a recorded probe and cuts over at a batch boundary.
- **Tail guard** (``tailguard.py``): propagated deadlines, retry budgets,
  hedged requests in a ``ServingPool`` and the brownout ladder, driven by
  the SLO monitor (``mxnet_tpu_torch.telemetry.slo``) with the
  ``Autoscaler``.

A served output equals the direct forward of the same rows up to the
rounding of the bucket's batch size (padding rows never mix into real
rows); the pipelined path runs the same forward on the same slot rows as
the serial one and is bitwise equal to it. ``stats()`` reports every
endpoint's counters and latency quantiles.

Generative serving (``serving.generate``) rides beside it:

    eng = serving.generate.DecodeEndpoint("lm", lm, max_seq_len=512)
    server.register_generator(eng, tenants={"gold": 50.0})  # ms per token
    server.start()
    tokens = server.generate("lm", prompt, max_new_tokens=32).result()

The serving fabric (``serving.fabric``) spans replicas over cards and
hosts: ``plan_slices`` carves this process's cards into slices, a
``ShardedEndpoint`` (``ShardedDecodeEndpoint``) serves one replica over a
slice's cards, and a ``FrontDoor`` routes tenants over host serving planes
and fails a dead host's work over to the survivors.

Every tier reports into the port's telemetry registry
(``mxnet_tpu_torch.telemetry``); a started server, a pool and an
autoscaler attach themselves to its debug pages. Not ported yet:
``tools/chaos_check.py`` (next in ROADMAP Queue 1).
"""
from __future__ import annotations

from . import bucketing, generate, tailguard
from .autoscaler import Autoscaler, ServingPool
from .endpoint import ModelEndpoint, get_endpoint, list_endpoints, unregister
from .errors import (DeadlineExceeded, HotSwapError, KVPoolExhausted,
                     RequestTimeoutError, ServerClosedError,
                     ServerOverloadError, ServingError)
from .generate import (DecodeEndpoint, DecodeScheduler, PagedKVPool,
                       TokenStream)
from .router import Router, StepCostEWMA, Tenant
from .server import InferenceServer
from .supervisor import PoolSupervisor
from . import fabric
from .fabric import (FrontDoor, ShardedDecodeEndpoint, ShardedEndpoint,
                     SliceSpec, plan_slices)
from .tailguard import (BROWNOUT, BrownoutController, Deadline, HEDGER,
                        HedgePolicy, RETRY_BUDGETS, RetryBudgets, TIER_RANKS,
                        TokenBucket)

__all__ = ["ModelEndpoint", "InferenceServer", "PoolSupervisor", "stats",
           "get_endpoint", "list_endpoints", "unregister", "ServingError",
           "ServerOverloadError", "RequestTimeoutError", "ServerClosedError",
           "HotSwapError", "KVPoolExhausted", "DeadlineExceeded", "Router",
           "StepCostEWMA", "Tenant", "bucketing", "generate",
           "DecodeEndpoint", "DecodeScheduler", "PagedKVPool", "TokenStream",
           "ServingPool", "Autoscaler", "fabric", "FrontDoor",
           "ShardedEndpoint", "ShardedDecodeEndpoint", "SliceSpec",
           "plan_slices", "tailguard", "Deadline", "TokenBucket",
           "RetryBudgets", "RETRY_BUDGETS", "HedgePolicy", "HEDGER",
           "BrownoutController", "BROWNOUT", "TIER_RANKS"]


def stats():
    """Every registered endpoint's ``EndpointStats.snapshot()``: counters,
    queue depth and peak, batch occupancy, latency, step, queue_wait and
    prep quantiles (microseconds), sheds by reason, the prep overlap
    ratio."""
    from .endpoint import _ENDPOINTS, _REG_LOCK
    with _REG_LOCK:
        eps = list(_ENDPOINTS.values())
    return {ep.name: ep.stats.snapshot() for ep in eps}
