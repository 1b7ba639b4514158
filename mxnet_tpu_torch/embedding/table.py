"""Vocab-sharded embedding tables over the ranks of a mesh axis (the
counterpart of ``mxnet_tpu/embedding/table.py``).

The table is partitioned along the **vocab axis** over the ranks of a mesh
axis (``parallel.make_mesh``): each rank stores its own shard on its device
and both directions of the sparse path stay on the ranks' devices, through
the port's collectives (``parallel/collectives.py``); nothing goes through
a kvstore.

  lookup   dedup the indices (:func:`dedup_ids`: sorted unique ids padded
           with an out-of-range sentinel) -> each rank gathers the rows it
           owns -> the rows come together by a collective.
  update   RowSparse semantics without the host: the step differentiates
           with respect to the *gathered rows* (never a dense (V, D)
           gradient), routes the per-row gradients to the ranks that own
           them, and each applies them to its shard with an in-place
           ``index_add_`` (the reference returns a new table; the port
           updates the shard in place, which saves a copy of it a step).

Two lookups, picked by how the index batch is split:

  :meth:`ShardedEmbedding.gather`           indices REPLICATED over the
                           axis: each rank contributes the rows it owns
                           (masked local gather) and an all_reduce sum
                           assembles them. Exactly one rank contributes a
                           given row and the others add exact zeros, so the
                           rows equal a one-rank gather bit for bit.
  :meth:`ShardedEmbedding.dispatch_gather`  indices SHARDED over the axis
                           (each rank holds its own slice): all_to_all
                           dispatch of the ids to every owner, local
                           gather, all_to_all return of the rows.

Row placement within the partition: ``block`` (rank s owns the contiguous
rows [s * rows_per_shard, ...)) or ``cyclic`` (row r lives on rank
``r % n_shards``: the planner's "row-wise" placement, which spreads a
frequency-sorted vocabulary's hot head over every rank).

Each rank stores its shard with one scratch row after it, where the
updates of rows it does not own (and of the sentinel) land and are never
read: the masked update needs no host synchronisation. The reference's
telemetry families (``mxtpu_emb_lookup_us``,
``mxtpu_emb_exchange_bytes_total``) are plain counters on the table
(:attr:`ShardedEmbedding.lookups`, ``lookup_us_total`` and
``exchange_bytes``) until the port has its telemetry (ROADMAP Q1.12).
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as onp
import torch

from ..base import DTypes, MXNetError
from ..parallel import collectives

__all__ = ["ShardedEmbedding", "dedup_ids"]


def dedup_ids(idx, vocab: int):
    """Dedup an index batch: ``(uniq, inv)``, int32 tensors on ``idx``'s
    device (a numpy array's on the CPU). ``uniq`` holds the sorted unique
    ids padded to the input's size with ``vocab`` (an out-of-range sentinel
    every gather and update drops); ``inv`` has ``idx``'s shape and
    ``uniq[inv] == idx``. Computed with a sort and a prefix sum, so the
    padded size needs no host synchronisation."""
    idx = torch.as_tensor(idx)
    flat = idx.reshape(-1).long()
    n = flat.shape[0]
    srt, order = torch.sort(flat)
    first = torch.ones(n, dtype=torch.bool, device=flat.device)
    first[1:] = srt[1:] != srt[:-1]
    pos = torch.cumsum(first, 0) - 1
    uniq = torch.full((n,), int(vocab), dtype=torch.long, device=flat.device)
    uniq.scatter_(0, pos, srt)      # duplicates write one value
    inv = torch.empty(n, dtype=torch.long, device=flat.device)
    inv[order] = pos
    return uniq.int(), inv.reshape(idx.shape).int()


class ShardedEmbedding:
    """One embedding table, partitioned (or replicated) over a mesh axis.

    Parameters
    ----------
    vocab_size, embed_dim : int
        Logical table shape. The stored layout pads the vocab to a multiple
        of the shard count.
    mesh : parallel.DeviceMesh
        The mesh the table lives on; each rank's shard is on its
        ``mesh.device``.
    axis : str
        Mesh axis the vocab dimension is partitioned over.
    placement : str
        ``partition`` (vocab-sharded) or ``replicate`` (small tables: a full
        copy on every rank, no exchange). The planner picks this.
    layout : str
        ``block`` or ``cyclic`` row placement (partition only).
    weight : array or tensor, optional
        Initial dense (vocab, dim) weights (:meth:`set_weight`); default
        zeros.
    """

    def __init__(self, vocab_size: int, embed_dim: int, mesh, axis: str = "tp",
                 dtype: str = "float32", placement: str = "partition",
                 layout: str = "block", name: str = "emb", weight=None):
        if placement not in ("partition", "replicate"):
            raise MXNetError(f"unknown placement {placement!r}")
        if layout not in ("block", "cyclic"):
            raise MXNetError(f"unknown layout {layout!r}")
        if axis not in mesh.axis_names:
            raise MXNetError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        self.name = name
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.mesh = mesh
        self.axis = axis
        self.dtype = dtype
        self.placement = placement
        self.layout = layout
        self.n_shards = int(mesh.axis_size(axis)) \
            if placement == "partition" else 1
        self.rows_per_shard = -(-self.vocab_size // self.n_shards)
        self.padded_vocab = self.rows_per_shard * self.n_shards
        #: this rank's shard's position along the axis (0 when replicated)
        self.shard_index = mesh.axis_index(axis) if self.n_shards > 1 else 0
        self._itemsize = onp.dtype(dtype).itemsize
        self._torch_dtype = DTypes.torch(dtype)
        #: lookups made by :meth:`lookup` and their wall microseconds
        #: (the reference's ``mxtpu_emb_lookup_us``)
        self.lookups = 0
        self.lookup_us_total = 0
        #: bytes the exchange moved by direction, as
        #: :meth:`exchange_cost_bytes` counts them (the reference's
        #: ``mxtpu_emb_exchange_bytes_total``)
        self.exchange_bytes = {"dispatch": 0, "return": 0}
        self._store = torch.zeros((self.rows_per_shard + 1, self.embed_dim),
                                  dtype=self._torch_dtype, device=mesh.device)
        if weight is not None:
            self.set_weight(weight)

    # ------------------------------------------------------------------
    # storage layout
    # ------------------------------------------------------------------
    def _stored_index(self, ids):
        """Logical row id -> row of the stored (padded_vocab, D) layout
        (numpy arrays or tensors)."""
        if self.layout == "block":
            return ids
        n = self.n_shards
        return (ids % n) * self.rows_per_shard + ids // n

    @property
    def weight(self) -> torch.Tensor:
        """This rank's stored shard, (rows_per_shard, embed_dim) on its
        device (the whole table when replicated or on one rank)."""
        return self._store[:self.rows_per_shard]

    def set_weight(self, dense):
        """Install dense logical (vocab, dim) weights: a host array, or a
        tensor (on this rank's device, a full-width table is read there
        and never crosses to the host). Each rank copies in its own rows
        (a view of ``dense``: block rows ``[i * rows_per_shard, ...)``,
        cyclic rows ``i, i + n, ...``)."""
        if not isinstance(dense, torch.Tensor):
            dense = torch.from_numpy(onp.ascontiguousarray(
                onp.asarray(dense, dtype=self.dtype)))
        if tuple(dense.shape) != (self.vocab_size, self.embed_dim):
            raise MXNetError(
                f"weight shape {tuple(dense.shape)} != "
                f"{(self.vocab_size, self.embed_dim)}")
        i, n, rps = self.shard_index, self.n_shards, self.rows_per_shard
        mine = dense[i::n] if self.layout == "cyclic" else \
            dense[i * rps:(i + 1) * rps]
        with torch.no_grad():
            self._store.zero_()
            self._store[:mine.shape[0]] = mine.to(
                device=self._store.device, dtype=self._torch_dtype)

    def set_stored(self, stored):
        """Install a stored-layout (padded_vocab, dim) array or tensor (the
        checkpoint restore path): this rank's rows of it."""
        if tuple(stored.shape) != (self.padded_vocab, self.embed_dim):
            raise MXNetError(f"stored shape {tuple(stored.shape)} != "
                             f"{(self.padded_vocab, self.embed_dim)}")
        stored = torch.as_tensor(stored)
        rps = self.rows_per_shard
        mine = stored[self.shard_index * rps:(self.shard_index + 1) * rps]
        with torch.no_grad():
            self._store[:rps] = mine.to(device=self._store.device,
                                        dtype=self._torch_dtype)
            self._store[rps:] = 0

    def stored_weight(self) -> torch.Tensor:
        """The whole stored-layout (padded_vocab, dim) table, gathered from
        the ranks (every rank must call it)."""
        if self.n_shards == 1:
            return self.weight
        return collectives.all_gather(self.weight.detach(), self.axis,
                                      mesh=self.mesh)

    def dense_weight(self) -> onp.ndarray:
        """The logical (vocab, dim) table as a host array (gathered: every
        rank must call it)."""
        stored = self.stored_weight().detach().cpu().numpy()
        return stored[self._stored_index(onp.arange(self.vocab_size))]

    # ------------------------------------------------------------------
    # the lookups and updates
    # ------------------------------------------------------------------
    def _owner_local(self, ids):
        """ids (int64 on the device) -> (row of this rank's store, whether
        this rank owns the id); rows it does not own point at the scratch
        row ``rows_per_shard``."""
        rps, i = self.rows_per_shard, self.shard_index
        if self.layout == "block" or self.n_shards == 1:
            local = ids - i * rps
        else:
            local = torch.where(ids % self.n_shards == i,
                                ids // self.n_shards, rps)
        ok = (local >= 0) & (local < rps)
        return torch.where(ok, local, rps), ok

    def _local_rows(self, ids):
        """The rows of ``ids`` this rank owns, exact zeros for the rest."""
        local, ok = self._owner_local(ids.to(self._store.device).long())
        rows = self._store[local]
        return torch.where(ok[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))

    def gather(self, ids) -> torch.Tensor:
        """(n, D) rows of ``ids`` REPLICATED over the axis (every rank
        passes the same ids): masked local gather, then an all_reduce sum
        over the axis. Ids out of range (the sentinel) give zero rows."""
        rows = self._local_rows(torch.as_tensor(ids))
        if self.n_shards == 1:
            return rows
        return collectives.all_reduce(rows, self.axis, "sum", mesh=self.mesh)

    def dispatch_gather(self, ids) -> torch.Tensor:
        """(n_local, D) rows of this rank's ids, with ids SHARDED over the
        axis (every rank passes as many): all_to_all dispatch of the ids to
        every owner, local gather, all_to_all return of the rows (one owner
        contributes each row; the sum over owners adds exact zeros)."""
        ids = torch.as_tensor(ids).to(self._store.device).long()
        if self.n_shards == 1:
            return self._local_rows(ids)
        n, m = self.n_shards, ids.shape[0]
        recv = collectives.all_to_all(ids.expand(n, m), self.axis, 0, 0,
                                      mesh=self.mesh)
        rows = self._local_rows(recv.reshape(-1)).reshape(n, m, -1)
        back = collectives.all_to_all(rows, self.axis, 0, 0, mesh=self.mesh)
        return back.sum(0)

    def scatter_add(self, ids, updates):
        """Add the (n, D) ``updates`` of already deduplicated ``ids``,
        REPLICATED over the axis, to this rank's shard in place: each rank
        keeps the rows it owns; other rows and the sentinel drop."""
        local, _ = self._owner_local(
            torch.as_tensor(ids).to(self._store.device).long())
        with torch.no_grad():
            self._store.index_add_(0, local, updates.detach().to(
                self._torch_dtype))

    def dispatch_scatter_add(self, ids, updates):
        """The reverse exchange for ids SHARDED over the axis: every rank's
        (ids, row updates) go to every rank (all_to_all), each adds the
        rows it owns to its shard in place."""
        ids = torch.as_tensor(ids).to(self._store.device).long()
        if self.n_shards == 1:
            self.scatter_add(ids, updates)
            return
        n, m = self.n_shards, ids.shape[0]
        recv_ids = collectives.all_to_all(ids.expand(n, m), self.axis, 0, 0,
                                          mesh=self.mesh)
        recv_upd = collectives.all_to_all(
            updates.detach().expand((n,) + tuple(updates.shape)), self.axis,
            0, 0, mesh=self.mesh)
        self.scatter_add(recv_ids.reshape(-1),
                         recv_upd.reshape(-1, updates.shape[-1]))

    # ------------------------------------------------------------------
    # the exchange's counters
    # ------------------------------------------------------------------
    def exchange_cost_bytes(self, n_ids: int, dispatch: bool) -> Tuple[int, int]:
        """(dispatch_bytes, return_bytes) the exchange moves for ``n_ids``
        ids. Dispatch sends the id vector to every shard; the return leg
        moves one (n_ids, D) row block per shard."""
        if self.n_shards <= 1:
            return 0, 0
        row = self.embed_dim * self._itemsize
        if dispatch:
            return (self.n_shards * n_ids * 4,
                    self.n_shards * n_ids * row)
        # all_reduce assembly: every shard contributes an (n, D) partial
        return 0, (self.n_shards - 1) * n_ids * row

    def record_exchange(self, n_ids: int, dispatch: bool):
        d, r = self.exchange_cost_bytes(int(n_ids), dispatch)
        self.exchange_bytes["dispatch"] += d
        self.exchange_bytes["return"] += r

    def lookup(self, indices) -> torch.Tensor:
        """Rows of (replicated) ``indices`` (an array or tensor of ints):
        dedup -> gather -> re-expand, shaped ``indices.shape +
        (embed_dim,)`` on this rank's device."""
        t0 = time.perf_counter_ns()
        idx = torch.as_tensor(onp.asarray(indices) if not isinstance(
            indices, torch.Tensor) else indices).to(self._store.device)
        uniq, inv = dedup_ids(idx, self.padded_vocab)
        out = self.gather(uniq)[inv.long()]
        self.record_exchange(uniq.shape[0], dispatch=False)
        self.lookups += 1
        self.lookup_us_total += (time.perf_counter_ns() - t0) // 1000
        return out

    def __repr__(self):
        return (f"ShardedEmbedding({self.name}: {self.vocab_size}x"
                f"{self.embed_dim}, {self.placement}/{self.layout} over "
                f"{self.n_shards}x'{self.axis}')")
