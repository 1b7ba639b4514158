"""Sharded checkpoint layout: shard capture and assembly (the port of
``mxnet_tpu/resilience/sharding.py``).

The on-disk layout is the reference's: a :class:`ShardedLeaf` is one
global array as its unique shards, each with its writer and its global
index (a ``[start, stop)`` pair per dimension); the CheckpointManager
groups shards by writer into ``shard-NNNNN.npz`` files and records the
placement in ``meta.json``'s ``layout``; :func:`assemble` pastes the
shards of one leaf back into the global array.

In the reference a writer is a device of one process; in the port the
ranks are processes, so a writer is the rank that holds the shard: each
rank captures its own shard's data, and knows where every other rank's
shard of the leaf lies (the split is fixed by the spec), so rank 0 can
write the whole layout. A leaf held whole on every rank is written once,
by the rank with coordinate 0 on every axis. The JAX package reads these
files, and the port reads the reference's, since both assemble through the
same layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as onp

from ..base import MXNetError

__all__ = ["ShardedLeaf", "capture_sharded", "assemble"]


class ShardedLeaf:
    """One global array captured as its shards.

    ``shards`` is ``[(writer, index, data), ...]``: ``writer`` the rank
    that holds the shard, ``index`` its [start, stop) pairs, ``data`` a
    host numpy copy on the writer itself and None for another rank's
    shard (its place in the layout only)."""

    __slots__ = ("shape", "dtype", "shards")

    def __init__(self, shape, dtype, shards):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = onp.dtype(dtype)
        self.shards = shards

    @classmethod
    def whole(cls, arr: onp.ndarray, writer: int = 0,
              rank: Optional[int] = None) -> "ShardedLeaf":
        """A leaf held whole, written by ``writer`` (its data kept only
        when this process is the writer, ``rank``; default: it is)."""
        arr = onp.asarray(arr)
        mine = rank is None or rank == writer
        index = [[0, int(d)] for d in arr.shape]
        return cls(arr.shape, arr.dtype,
                   [(int(writer), index, arr if mine else None)])

    @classmethod
    def split(cls, local: onp.ndarray, dim: int, writers: Sequence[int],
              index: int) -> "ShardedLeaf":
        """A leaf split evenly along ``dim`` over ``len(writers)`` ranks
        (shard ``i`` held by ``writers[i]``); this process holds shard
        ``index``, whose data is ``local``."""
        local = onp.asarray(local)
        n = len(writers)
        shape = list(local.shape)
        per = shape[dim]
        shape[dim] = per * n
        shards = []
        for i, w in enumerate(writers):
            idx = [[0, int(d)] for d in shape]
            idx[dim] = [i * per, (i + 1) * per]
            shards.append((int(w), idx, local if i == index else None))
        return cls(shape, local.dtype, shards)


def capture_sharded(tree, to_leaf):
    """Map every leaf of a nested dict tree through ``to_leaf`` (which
    returns a ShardedLeaf, or the leaf itself to keep it dense)."""
    if isinstance(tree, dict):
        return {k: capture_sharded(v, to_leaf) for k, v in tree.items()}
    return to_leaf(tree)


def assemble(entry: Dict, shard_files: Dict[int, object], key: str
             ) -> onp.ndarray:
    """Rebuild one global array from a layout entry ``{shape, dtype,
    shards}`` and the opened shard files; raises when the shards do not
    tile the array."""
    shape = tuple(entry["shape"])
    arr = onp.empty(shape, dtype=onp.dtype(entry["dtype"]))
    covered = 0
    for rec in entry["shards"]:
        zf = shard_files.get(int(rec["file"]))
        if zf is None:
            raise MXNetError(f"layout references missing shard file "
                             f"{rec['file']} for {key!r}")
        idx = tuple(slice(a, b) for a, b in rec["index"])
        piece = zf[key]
        arr[idx] = piece
        covered += int(piece.size)
    if covered != arr.size:
        raise MXNetError(
            f"sharded leaf {key!r}: shards cover {covered} of {arr.size} "
            "elements (corrupt or non-tiling layout)")
    return arr

