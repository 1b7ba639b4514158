"""KVStore of the port (the counterpart of ``mxnet_tpu/kvstore/__init__.py``;
MXNet's ``kvstore.h`` Init / Push / Pull / PushPull / Broadcast and
``kvstore.cc``'s type dispatch).

The "local", "device", "nccl", "tpu" and "horovod" types keep every value in
this process: ``push`` sums a list of values (one per context) into the
store or, with an optimizer set, hands the sum to its updater, which
updates the stored weight in place; ``pull`` copies the stored value out.
Row-sparse values stay row-sparse through the sum, and ``row_sparse_pull``
gathers only the requested rows. With gradient compression each pushed
value passes through its lossy 2-bit or 1-bit roundtrip (per key and
context index, with its residual) before the sum.

The distributed types (``dist``, ``dist_sync``, ``dist_device_sync``,
``dist_sync_device``, ``p3``, ``dist_async``) join the job a launcher
started (``parallel.collectives.initialize_distributed``); outside one
they are one-worker stores. Across workers the local sum is all-reduced
(``_allreduce_sum``), in ``MXNET_P3_SLICE_SIZE`` slices for ``p3``;
row-sparse sums of unequal nnz are padded to the largest with the drop
sentinel row ``shape[0]`` and gathered; with compression only the packed
uint8 codes (and the 1-bit scale) are gathered, and each worker's are
dequantized and summed in rank order. ``dist_async`` with an optimizer
sends each push to the host parameter service on rank 0
(``async_ps.py``), which applies it on arrival; pulls read the service.
Each worker of a job writes a heartbeat file (``MXNET_KVSTORE_HEARTBEAT_DIR``)
that ``num_dead_node`` reads.
"""
from __future__ import annotations

import numbers
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config
from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _wrap
from ..optimizer.optimizer import get_updater, state_to
from .base import KVStoreBase
from .gradient_compression import GradientCompression
from . import collective as _collective  # registers the "collective" store

__all__ = ["create", "KVStore", "KVStoreBase", "GradientCompression"]

_TYPES = ("local", "device", "nccl", "tpu", "dist", "dist_sync",
          "dist_async", "dist_device_sync", "dist_sync_device", "p3",
          "horovod")


def _listify(v):
    return v if isinstance(v, (list, tuple)) else [v]


def _key_int(k):
    """The updater's index for a key: an integer where ``int(k)`` gives
    one (a number, or a string of digits), else the key itself."""
    if isinstance(k, str):
        digits = k.strip()
        return int(digits) if digits.lstrip("+-").isdigit() else k
    return int(k) if isinstance(k, numbers.Real) else k


class KVStore(KVStoreBase):
    """The store over every type of ``_TYPES``."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression: Optional[GradientCompression] = None
        #: the values entering a cross-worker reduce, as f32 bytes, and the
        #: bytes this worker put on the wire for them
        self.payload_bytes = 0
        self.wire_bytes = 0
        self._multi = False
        self._async = False
        self._has_updater = threading.Event()
        self._ps_server = self._ps_client = None
        if kv_type.startswith("dist") or kv_type == "p3":
            from ..parallel import collectives
            collectives.initialize_distributed()
            self._multi = collectives.num_workers() > 1
            self._async = "async" in kv_type
            if self._async and self._multi:
                from .async_ps import AsyncParameterServer, AsyncPSClient
                if collectives.rank() == 0:
                    self._ps_server = AsyncParameterServer(
                        self._server_apply, collectives.num_workers(),
                        max_staleness=config.get(
                            "MXNET_KVSTORE_ASYNC_MAX_STALENESS"))
                self._ps_client = AsyncPSClient(collectives.rank())
            self._start_heartbeat()

    # -- identity -----------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        from ..parallel import collectives
        return collectives.rank() if self._multi else 0

    @property
    def num_workers(self):
        from ..parallel import collectives
        return collectives.num_workers() if self._multi else 1

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
        self.set_updater(get_updater(optimizer))

    def set_updater(self, updater):
        self._updater = updater
        self._has_updater.set()

    # -- the operations -------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value under its key (with the async
        service, the first worker's value wins)."""
        keys, values = _listify(key), _listify(value)
        if len(keys) != len(values):
            keys = [key] * len(values)
        for k, v in zip(keys, values):
            self._store[k] = _wrap(v._data.detach().clone(), v.context)
            if self._ps_client is not None:
                self._ps_client.init(k, v._data.detach().cpu().numpy())
        if self._ps_server is not None:
            # one staleness clock tick is one push of every key
            self._ps_server.set_num_keys(len(self._store))

    def _allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the workers of a dense tensor (a new tensor)."""
        from ..parallel import collectives
        self.wire_bytes += t.numel() * t.element_size()
        return collectives.world_all_reduce(t.detach().clone())

    def _reduce(self, values: List[NDArray], key=None,
                cross_host=True) -> NDArray:
        """The sum of one key's values (on the first value's device), then,
        across workers, the sum over the job. Row-sparse values stay
        row-sparse; with compression each local value passes its lossy
        roundtrip first (a single value only where no wire follows), and
        only packed codes cross between workers."""
        from ..sparse import BaseSparseNDArray, RowSparseNDArray, add_n
        cross = self._multi and cross_host
        if any(isinstance(v, BaseSparseNDArray) for v in values):
            if all(isinstance(v, RowSparseNDArray) for v in values):
                if len(values) > 1:
                    agg = add_n(values)
                else:
                    v = values[0]
                    agg = RowSparseNDArray._of(v._data.clone(),
                                               v._indices.clone(), v.shape,
                                               v.context)
                return self._gather_row_sparse(agg) if cross else agg
            values = [v.todense() if isinstance(v, BaseSparseNDArray) else v
                      for v in values]
        comp = self._compression if key is not None else None
        dev = values[0]._data.device
        if comp is not None and (len(values) > 1 or not cross):
            parts = [comp.roundtrip((key, i), v._data)
                     for i, v in enumerate(values)]
            total = parts[0]
        else:
            parts = [v._data.detach() for v in values]
            total = parts[0].clone()
        for p in parts[1:]:
            total = total + p.to(dev)
        if cross:
            self.payload_bytes += total.numel() * 4
            if comp is not None:
                total = self._compressed_sum(key, comp, total)
            elif self._type == "p3":
                n = max(1, int(config.get("MXNET_P3_SLICE_SIZE")))
                flat = total.reshape(-1)
                total = torch.cat([self._allreduce_sum(flat[i:i + n])
                                   for i in range(0, flat.numel(), n)]
                                  ).reshape(total.shape)
            else:
                total = self._allreduce_sum(total)
        return _wrap(total, values[0].context)

    def _compressed_sum(self, key, comp, total):
        """Every worker's packed codes (and 1-bit scale) gathered, each
        dequantized and summed in rank order."""
        from ..parallel import collectives
        packed, scale = comp.quantize((key, "wire"), total)
        self.wire_bytes += packed.numel() * packed.element_size()
        packed_all = collectives.world_all_gather(packed)
        scale_all = collectives.world_all_gather(
            scale.reshape(()).to(torch.float32))
        out = None
        for w in range(packed_all.shape[0]):
            part = comp.dequantize(packed_all[w], scale_all[w],
                                   tuple(total.shape), total.dtype)
            out = part if out is None else out + part
        return out

    def _gather_row_sparse(self, agg):
        """Every worker's rows, padded to the largest nnz with the drop
        sentinel row ``shape[0]``, gathered and summed by row."""
        from ..parallel import collectives
        from ..sparse import RowSparseNDArray, add_n
        idx, vals = agg._indices, agg._data
        nnz = collectives.world_all_gather(
            torch.tensor([idx.numel()], dtype=torch.int64,
                         device=idx.device))
        most = int(nnz.max())
        if most == 0:
            return agg
        pad = most - idx.numel()
        if pad:
            idx = torch.cat([idx, idx.new_full((pad,), agg.shape[0])])
            vals = torch.cat([vals, vals.new_zeros((pad,) +
                                                   tuple(vals.shape[1:]))])
        self.payload_bytes += vals.numel() * 4
        self.wire_bytes += vals.numel() * vals.element_size() + \
            idx.numel() * idx.element_size()
        idx_all = collectives.world_all_gather(idx)
        vals_all = collectives.world_all_gather(vals)
        return add_n([RowSparseNDArray._of(v, i, agg.shape, agg.context)
                      for i, v in zip(idx_all, vals_all)])

    def _server_apply(self, key, grad_np, weight_np):
        """The async service's apply (rank 0's service threads): this
        process's updater on CPU tensors over the host arrays, the result
        written back into ``weight_np``. A push that arrives before this
        rank set its updater waits for it (up to ``MXNET_DIST_TIMEOUT``)."""
        if not self._has_updater.wait(config.get("MXNET_DIST_TIMEOUT")):
            raise MXNetError("dist_async needs a kvstore updater "
                             "(set_optimizer / update_on_kvstore)")
        from ..base import cpu
        g = _wrap(torch.from_numpy(np.array(grad_np)), cpu())
        w = _wrap(torch.from_numpy(np.array(weight_np)), cpu())
        self._updater(_key_int(key), g, w)
        weight_np[...] = w._data.numpy()

    def push(self, key, value, priority=0):
        """Sum each key's values (over the job for a multi-worker store)
        into the store, or through the updater onto the stored weight when
        an optimizer is set; ``dist_async`` with an updater sends the local
        sum to the parameter service instead."""
        from ..sparse import BaseSparseNDArray
        keys, values = _listify(key), _listify(value)
        if len(keys) == 1 and len(values) > 1:
            values = [values]
        for k, vlist in zip(keys, values):
            local_only = self._async and self._updater is not None
            agg = self._reduce(_listify(vlist), key=k,
                               cross_host=not local_only)
            if self._ps_client is not None and self._updater is not None:
                if isinstance(agg, BaseSparseNDArray):
                    agg = agg.todense()
                self._ps_client.push(k, agg._data.detach().cpu().numpy())
                continue
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
            src = self._store[k]
            if self._ps_client is not None and self._updater is not None:
                src = _wrap(torch.from_numpy(self._ps_client.pull(k)).to(
                    src._data.device), src.context)
            for o in _listify(olist):
                src.copyto(o)

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
        """Every worker waits for the others."""
        if self._multi:
            from ..parallel import collectives
            collectives.barrier()

    def _start_heartbeat(self):
        """Write this worker's heartbeat file every
        ``MXNET_KVSTORE_HEARTBEAT_INTERVAL`` seconds from a daemon thread
        (the ps-lite heartbeat), when ``MXNET_KVSTORE_HEARTBEAT_DIR`` is
        set."""
        hb_dir = config.get("MXNET_KVSTORE_HEARTBEAT_DIR")
        if not hb_dir:
            return
        os.makedirs(hb_dir, exist_ok=True)
        interval = config.get("MXNET_KVSTORE_HEARTBEAT_INTERVAL")
        path = os.path.join(hb_dir, f"heartbeat_{self.rank}")
        stop = self._hb_stop = threading.Event()

        def write_beat():
            # atomic: a reader never sees a truncated file
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(repr(time.time()))
            os.replace(tmp, path)

        def beat():
            while not stop.wait(interval):
                write_beat()

        write_beat()
        self._hb_thread = threading.Thread(
            target=beat, daemon=True, name=f"kvstore-heartbeat-{self.rank}")
        self._hb_thread.start()

    def close(self):
        """Stop the heartbeat (a closed store looks dead to its peers) and
        the async service's connection."""
        stop = getattr(self, "_hb_stop", None)
        if stop is not None:
            stop.set()
            self._hb_thread.join(timeout=2)
        if self._ps_client is not None:
            self._ps_client.close()
            self._ps_client = None
        if self._ps_server is not None:
            self._ps_server.stop()
            self._ps_server = None

    def num_dead_node(self, node_id=0, timeout_sec=60):
        """The workers whose heartbeat is older than ``timeout_sec`` (or
        absent); 0 without a heartbeat directory."""
        hb_dir = config.get("MXNET_KVSTORE_HEARTBEAT_DIR")
        if not hb_dir or not os.path.isdir(hb_dir):
            return 0
        now, dead = time.time(), 0
        for r in range(self.num_workers):
            path = os.path.join(hb_dir, f"heartbeat_{r}")
            # written by os.replace: a file is whole or absent
            text = open(path).read().strip() if os.path.isfile(path) else ""
            last = float(text) if text.replace(".", "", 1).isdigit() else 0.0
            if now - last > timeout_sec:
                dead += 1
        return dead

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
    """A store by type name (``kvstore.cc``): a registered plugin's name
    makes the plugin ("collective" among them); every type of ``_TYPES``
    makes a :class:`KVStore`."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    base = name.lower()
    if base in KVStoreBase._kv_registry:
        return KVStoreBase._kv_registry[base]()
    if base not in _TYPES:
        raise MXNetError(f"unknown KVStore type {name!r}")
    return KVStore(base)
