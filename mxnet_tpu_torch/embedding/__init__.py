"""mxnet_tpu_torch.embedding: vocab-sharded tables, the placement planner,
the device feed and the DLRM training step (the counterpart of
``mxnet_tpu/embedding``).

Tables partitioned along the vocab axis over the ranks of a mesh axis, with
the lookup and the row-sparse update both on the ranks' devices through
the port's collectives (table.py); a per-table placement planner driven by
footprint and observed hotness (planner.py); a streaming stager that keeps
the card from waiting on the host (feed.py); and the DLRM step that ties
them together (workload.py).
"""
from .table import ShardedEmbedding, dedup_ids
from .planner import TableSpec, TablePlan, HotnessTracker, plan_tables
from .feed import DeviceFeed
from .workload import (DLRMTrainStep, init_mlp_params, dlrm_forward,
                       bce_loss, synthetic_dlrm_batches)

__all__ = [
    "ShardedEmbedding", "dedup_ids",
    "TableSpec", "TablePlan", "HotnessTracker", "plan_tables",
    "DeviceFeed",
    "DLRMTrainStep", "init_mlp_params", "dlrm_forward", "bce_loss",
    "synthetic_dlrm_batches",
]
