"""KVStore of the port, the single-process part (the counterpart of
``mxnet_tpu/kvstore/__init__.py``; MXNet's ``kvstore.h`` Init / Push / Pull
/ PushPull / Broadcast and ``kvstore.cc``'s type dispatch).

The "local", "device" and "nccl" types keep every value in this process:
``push`` sums a list of values (all on one device here: the card host has
one GPU) into the store or, with an optimizer set, hands the sum to its
updater, which updates the stored weight in place; ``pull`` copies the
stored value out. Row-sparse values stay row-sparse through the sum, and
``row_sparse_pull`` gathers only the requested rows. With gradient
compression each pushed value passes through its lossy 2-bit or 1-bit
roundtrip (per key and device index, with its residual) before the sum,
and a single value too, so training on one device sees what a distributed
worker would.

The distributed types (``dist_*``, ``p3``, ``horovod``) need
``torch.distributed`` and more than one device: ROADMAP item Q1.9 (P9).
"""
from __future__ import annotations

import numbers
from typing import Dict, List, Optional

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _wrap
from ..optimizer.optimizer import get_updater, state_to
from .base import KVStoreBase
from .gradient_compression import GradientCompression

__all__ = ["create", "KVStore", "KVStoreBase", "GradientCompression"]

_LOCAL_TYPES = ("local", "device", "nccl")
_DIST_TYPES = ("dist", "dist_sync", "dist_async", "dist_device_sync",
               "dist_sync_device", "p3", "horovod")


def _listify(v):
    return v if isinstance(v, (list, tuple)) else [v]


def _key_int(k):
    """The updater's index for a key: an integer where ``int(k)`` gives
    one (a number, or a string of digits), else the key itself."""
    if isinstance(k, str):
        digits = k.strip()
        return int(digits) if digits.lstrip("+-").isdigit() else k
    return int(k) if isinstance(k, numbers.Real) else k


def refuse_distributed(name):
    if isinstance(name, str) and name.lower() in _DIST_TYPES:
        raise MXNetError(
            f"KVStore {name!r}: distributed and multi-device stores need "
            "torch.distributed over several cards (ROADMAP Q1.9, P9); one "
            "process takes 'local', 'device' or 'nccl'")


class KVStore(KVStoreBase):
    """The single-process store over "local", "device" and "nccl"."""

    def __init__(self, kv_type="local"):
        refuse_distributed(kv_type)
        self._type = kv_type
        self._store: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression: Optional[GradientCompression] = None

    # -- identity -----------------------------------------------------------
    @property
    def type(self):
        return self._type

    @staticmethod
    def is_capable(capability):
        return capability in ("optimizer",)

    # -- configuration --------------------------------------------------------
    def set_gradient_compression(self, compression_params):
        params = dict(compression_params)
        self._compression = GradientCompression(
            type=params.get("type", "2bit"),
            threshold=float(params.get("threshold", 0.5)))

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    # -- the operations -------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value under its key."""
        keys, values = _listify(key), _listify(value)
        if len(keys) != len(values):
            keys = [key] * len(values)
        for k, v in zip(keys, values):
            self._store[k] = _wrap(v._data.detach().clone(), v.context)

    def _reduce(self, values: List[NDArray], key=None) -> NDArray:
        """The sum of one key's values (on the first value's device);
        row-sparse values stay row-sparse; with compression each value
        passes its lossy roundtrip first."""
        from ..sparse import BaseSparseNDArray, RowSparseNDArray, add_n
        if any(isinstance(v, BaseSparseNDArray) for v in values):
            if all(isinstance(v, RowSparseNDArray) for v in values):
                if len(values) > 1:
                    return add_n(values)
                v = values[0]
                return RowSparseNDArray._of(v._data.clone(),
                                            v._indices.clone(), v.shape,
                                            v.context)
            values = [v.todense() if isinstance(v, BaseSparseNDArray) else v
                      for v in values]
        comp = self._compression if key is not None else None
        dev = values[0]._data.device
        if comp is not None:
            parts = [comp.roundtrip((key, i), v._data)
                     for i, v in enumerate(values)]
        else:
            parts = [v._data.detach() for v in values]
        total = parts[0] if comp is not None else parts[0].clone()
        for p in parts[1:]:
            total = total + p.to(dev)
        return _wrap(total, values[0].context)

    def push(self, key, value, priority=0):
        """Sum each key's values into the store, or through the updater
        onto the stored weight when an optimizer is set."""
        keys, values = _listify(key), _listify(value)
        if len(keys) == 1 and len(values) > 1:
            values = [values]
        for k, vlist in zip(keys, values):
            agg = self._reduce(_listify(vlist), key=k)
            if self._updater is not None:
                if k not in self._store:
                    raise MXNetError(f"key {k} not initialized")
                self._updater(_key_int(k), agg, self._store[k])
            else:
                self._store[k] = agg

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into its outputs."""
        keys, outs = _listify(key), _listify(out)
        if len(keys) == 1 and len(outs) > 1:
            outs = [outs]
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            for o in _listify(olist):
                self._store[k].copyto(o)

    def pushpull(self, key, value, out=None, priority=0):
        """Reduce ``value`` and write the result into ``out`` (or back
        into ``value``); with an optimizer set and the key stored, the
        reduced value updates the stored weight, which is written out."""
        keys, values = _listify(key), _listify(value)
        if len(keys) == 1 and len(values) > 1 and \
                not isinstance(value[0], (list, tuple)):
            values = [values]
        outs = _listify(out if out is not None else value)
        if len(keys) == 1 and len(outs) > 1 and \
                not isinstance(outs[0], (list, tuple)):
            outs = [outs]
        for k, vlist, olist in zip(keys, values, outs):
            agg = self._reduce(_listify(vlist), key=k)
            if self._updater is not None and k in self._store:
                self._updater(_key_int(k), agg, self._store[k])
                agg = self._store[k]
            for o in _listify(olist):
                agg.copyto(o)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` (duplicate, unsorted and empty
        ids taken: each distinct row once, sorted). A ``RowSparseNDArray``
        ``out`` receives those rows, a dense one a zero-padded copy."""
        from ..sparse import BaseSparseNDArray, RowSparseNDArray
        keys, outs, rids = _listify(key), _listify(out), _listify(row_ids)
        if len(keys) == 1 and len(outs) > 1:
            keys = keys * len(outs)
        if len(rids) == 1 and len(outs) > 1:
            rids = rids * len(outs)
        for k, o, r in zip(keys, outs, rids):
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized")
            src = self._store[k]
            if isinstance(src, BaseSparseNDArray):
                # a sparse push without an updater stored row-sparse rows:
                # gather logical rows from the dense form
                src = self._store[k] = src.todense()
            data = src._data
            idx = (r._data if isinstance(r, NDArray) else torch.as_tensor(r))
            idx = idx.to(data.device).reshape(-1).long()
            if idx.numel():
                idx = torch.unique(idx, sorted=True)
            valid = (idx >= 0) & (idx < data.shape[0])
            rows = data[idx.clamp(0, max(data.shape[0] - 1, 0))] * \
                valid.reshape((-1,) + (1,) * (data.dim() - 1)).to(data.dtype)
            if isinstance(o, RowSparseNDArray):
                o._assign(idx, rows.to(o._data.dtype))
            else:
                full = torch.zeros_like(data)
                full[idx[valid]] = rows[valid]
                o._set_data(full.to(o._data.dtype))

    # -- lifecycle ------------------------------------------------------------
    def barrier(self, priority=0):
        """One process: nothing to wait for."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("optimizer not set")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Restore the states, each on its stored weight's device."""
        if self._updater is None:
            raise MXNetError("optimizer not set")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        for k, st in self._updater.states.items():
            v = self._store.get(k)
            if v is not None:
                self._updater.states[k] = state_to(st, v._data.device)

    def __repr__(self):
        return f"<KVStore type={self._type} rank={self.rank}/" \
               f"{self.num_workers}>"


def create(name="local") -> KVStoreBase:
    """A store by type name (``kvstore.cc``): "local", "device" and
    "nccl" are this process's store; a registered plugin's name makes the
    plugin; the distributed types raise (ROADMAP Q1.9)."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    base = name.lower()
    refuse_distributed(base)
    if base in KVStoreBase._kv_registry:
        return KVStoreBase._kv_registry[base]()
    if base not in _LOCAL_TYPES:
        raise MXNetError(f"unknown KVStore type {name!r}")
    return KVStore(base)
