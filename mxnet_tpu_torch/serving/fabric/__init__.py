"""mxnet_tpu_torch.serving.fabric — sharded replicas and a multi-host front
door (the port of ``mxnet_tpu/serving/fabric``).

The layer between "a replica" and "a card":

- **slices** (:mod:`.slices`): a slice planner that partitions this
  process's contexts into gang-scheduled slices
  (``parallel.mesh.carve_slices``) — each slice backs one logical replica
  with ``capacity == len(devices)``, so a 4-card sharded replica and a
  single-card one coexist in one ``ServingPool`` with capacity-weighted
  placement.
- **sharded** (:mod:`.sharded`): :class:`ShardedEndpoint` /
  :class:`ShardedDecodeEndpoint` — drop-in endpoint twins that split a
  bucket's rows over the slice's contexts, each chunk through that
  context's copy of the block, outputs concatenated on the first context.
  Only the batch (row) axis is split and parameters move only as bytes, so
  a chunk's outputs are bitwise the direct forward of that chunk.
- **frontdoor** (:mod:`.frontdoor`): a multi-host serving front door — per
  host serving planes with a subprocess agent each (heartbeats; the
  stand-in for process-group membership), consistent-hash tenant->host
  routing with bounded rebalancing (a dead host's tenants move, nobody
  else's), and cross-host failover that resubmits a dead host's in-flight
  work on the survivors behind the client future — zero client-visible
  errors.
"""
from __future__ import annotations

from .slices import SliceSpec, plan_slices
from .sharded import ShardedDecodeEndpoint, ShardedEndpoint
from .frontdoor import FrontDoor

__all__ = ["SliceSpec", "plan_slices", "ShardedEndpoint",
           "ShardedDecodeEndpoint", "FrontDoor"]
