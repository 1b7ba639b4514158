"""The "collective" store (the counterpart of
``mxnet_tpu/kvstore/collective.py``; the pattern of MXNet's
``kvstore/horovod.py``): a second store registered through
``KVStoreBase.register``, with no key-value table at all. ``broadcast``
sends the root's value to every worker and output; ``pushpull`` sums the
values of this process and all-reduces the sum over the job. It keeps no
optimizer (updates run on the workers), so ``push`` and ``pull`` raise."""
from __future__ import annotations

from ..base import MXNetError
from ..ndarray.ndarray import _wrap
from .base import KVStoreBase

__all__ = ["Collective"]


def _listify(v):
    return v if isinstance(v, (list, tuple)) else [v]


@KVStoreBase.register
class Collective(KVStoreBase):
    """``kv.create("collective")``: the allreduce-only store."""

    def __init__(self):
        from ..parallel import collectives
        collectives.initialize_distributed()

    @property
    def type(self):
        return "collective"

    @property
    def rank(self):
        from ..parallel import collectives
        return collectives.rank()

    @property
    def num_workers(self):
        from ..parallel import collectives
        return collectives.num_workers()

    @staticmethod
    def is_capable(capability):
        # no optimizer on the store: updates happen on the workers
        return {KVStoreBase.OPTIMIZER: False}.get(capability, False)

    def broadcast(self, key, value, out, priority=0):
        """Rank 0's first value into every output of every worker."""
        from ..parallel import collectives
        src = _listify(value)[0]
        data = collectives.world_broadcast(src._data.detach().clone())
        agg = _wrap(data, src.context)
        for o in _listify(out):
            agg.copyto(o)

    def pushpull(self, key, value, out=None, priority=0):
        """The sum of this process's values, all-reduced over the job,
        into ``out`` (or back into ``value``)."""
        from ..parallel import collectives
        vals = _listify(value)
        total = vals[0]._data.detach().clone()
        for v in vals[1:]:
            total = total + v._data.to(total.device)
        total = collectives.world_all_reduce(total)
        agg = _wrap(total, vals[0].context)
        for o in _listify(out if out is not None else value):
            agg.copyto(o)

    def push(self, key, value, priority=0):
        raise MXNetError("the collective kvstore is pushpull-only "
                         "(allreduce, as horovod)")

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise MXNetError("the collective kvstore is pushpull-only "
                         "(allreduce, as horovod)")
