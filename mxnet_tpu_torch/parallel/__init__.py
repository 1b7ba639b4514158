"""Training over device meshes: ``make_mesh``, ``ParallelTrainStep``, the
collectives over the ranks of a multi-process job and ring attention over
a sequence-parallel axis."""
from .collectives import (all_gather, all_reduce, all_to_all, axis_index,
                          axis_size, barrier, broadcast_from_root,
                          initialize_distributed, num_workers, ppermute,
                          rank, reduce_scatter, scatter_to_axis)
from .mesh import (DeviceMesh, carve_slices, current_mesh, make_mesh,
                   replicated, shard_spec)
from .ring_attention import ring_attention, ring_self_attention
from .train_step import ParallelTrainStep

__all__ = ["DeviceMesh", "ParallelTrainStep", "make_mesh", "current_mesh",
           "replicated", "shard_spec", "carve_slices", "all_reduce",
           "all_gather", "reduce_scatter", "ppermute", "all_to_all",
           "axis_index", "axis_size", "barrier", "broadcast_from_root",
           "initialize_distributed", "rank", "num_workers",
           "scatter_to_axis", "ring_attention", "ring_self_attention"]
