"""Paged KV cache: preallocated on-device block pools for autoregressive
decode (the port of ``mxnet_tpu/serving/generate/kv_cache.py``).

The pool preallocates a fixed grid of fixed-size pages once; per-sequence
page tables map logical positions to physical pages, so a sequence's cache
neither reserves ``max_seq_len`` up front nor moves as it grows.

Layout: ``(num_layers, num_pages, page_size, kv_dim)`` per pool (one for K,
one for V), zero-initialised on the endpoint's device in the parameters'
dtype and updated in place (indexed assignment) where the reference
replaces donated arrays. **Page 0 is a scratch page** and never allocated:
writes for padded or invalid positions land there, and padded page-table
entries gather from it. Whatever accumulates there is masked to an
exactly-zero softmax weight before it can touch a real row (the ``_NEG_INF``
underflow of ``single_query_attention``), which the batched-vs-serial
bitwise decode contract rests on; pool contents are always finite (zeros or
a model's K/V), so a zero weight times a stale value stays zero.

:func:`write_prefill`, :func:`write_step` and :func:`gather_ctx` are
functions on tensors that the decode engine runs; :class:`PagedKVPool` holds
the pools and the host-side allocator.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import config as _config
from ...base import Context, DTypes, MXNetError, current_context
from ..errors import KVPoolExhausted

__all__ = ["PagedKVPool", "KVPoolExhausted", "write_prefill", "write_step",
           "gather_ctx"]


def write_prefill(pool, vals, table_row, length, page_size: int):
    """Scatter one sequence's prefill projections into ``pool``, in place.

    ``pool`` (num_layers, num_pages, page_size, kv_dim); ``vals``
    (num_layers, S, kv_dim), K (or V) for positions 0..S-1; ``table_row``
    (P,) integer physical page ids (0-padded); ``length``: positions at and
    past it are padding, written to scratch page 0 (where duplicate slots
    land in any order; nothing reads page 0 unmasked). Returns ``pool``."""
    S = vals.shape[1]
    pos = torch.arange(S, device=pool.device)
    page = table_row.to(pool.device, torch.long)[pos // page_size]
    page = torch.where(pos < length, page, 0)
    pool[:, page, pos % page_size, :] = vals
    return pool


def write_step(pool, vals, tables, positions, valid, page_size: int):
    """Scatter one decode step's new K (or V) row per sequence, in place.

    ``vals`` (num_layers, B, kv_dim); ``tables`` (B, P) integers;
    ``positions`` (B,), the lane each row's new token occupies; ``valid``
    (B,) bool: padding rows write to scratch page 0. Returns ``pool``."""
    positions = positions.to(pool.device, torch.long)
    rows = torch.arange(tables.shape[0], device=pool.device)
    page = tables.to(pool.device, torch.long)[rows, positions // page_size]
    page = torch.where(valid.to(pool.device), page, 0)
    pool[:, page, positions % page_size, :] = vals
    return pool


def gather_ctx(pool, tables):
    """Each sequence's cached context: (num_layers, num_pages, page_size,
    kv_dim) x (B, P) -> (num_layers, B, P * page_size, kv_dim), lane j =
    position j. Padding table entries gather scratch page 0, masked by the
    attention's length mask before use."""
    g = pool[:, tables.to(pool.device, torch.long)]     # (L, B, P, page, kv)
    L, B = g.shape[0], g.shape[1]
    return g.reshape(L, B, g.shape[2] * g.shape[3], g.shape[4])


class PagedKVPool:
    """Preallocated paged KV storage plus its free-list allocator.

    ``ctx`` is the device the pools live on (default :func:`current_context`,
    which is ``gpu(0)``). Thread-safety: the allocator's mutators take the
    internal lock; writes into the pools and :meth:`defrag` follow the
    serving single-dispatcher rule (only the decode worker thread runs
    them), so a step never races a compaction.
    """

    def __init__(self, name: str, num_layers: int, kv_dim: int,
                 max_seq_len: int, page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, dtype="float32",
                 ctx: Optional[Context] = None):
        if page_size is None:
            page_size = int(_config.get("MXNET_KV_PAGE_SIZE"))
        if num_pages is None:
            num_pages = int(_config.get("MXNET_KV_POOL_PAGES"))
        if page_size < 1 or num_pages < 2:
            raise MXNetError(
                f"KV pool needs page_size >= 1 and num_pages >= 2 (one "
                f"scratch + one usable), got page_size={page_size}, "
                f"num_pages={num_pages}")
        self.name = name
        self.num_layers = int(num_layers)
        self.kv_dim = int(kv_dim)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_seq_len = int(max_seq_len)
        self.pages_per_seq = int(math.ceil(self.max_seq_len / self.page_size))
        if self.pages_per_seq > self.num_pages - 1:
            raise MXNetError(
                f"KV pool {name!r}: one sequence needs {self.pages_per_seq} "
                f"pages for max_seq_len={max_seq_len} but the pool only has "
                f"{self.num_pages - 1} usable pages")
        self.ctx = ctx if ctx is not None else current_context()
        shape = (self.num_layers, self.num_pages, self.page_size, self.kv_dim)
        if not isinstance(dtype, torch.dtype):
            dtype = DTypes.torch(dtype)
        device = self.ctx.torch_device()
        self.k_pool = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=device)
        self._lock = threading.Lock()
        # LIFO free list, page 0 (scratch) excluded for the pool's lifetime
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}

    # -- allocation ---------------------------------------------------------
    def reserve(self, sid: int, total_tokens: int):
        """Grow ``sid``'s page table to cover ``total_tokens`` positions.

        The decode scheduler reserves a sequence's whole budget (prompt +
        max_new_tokens) at admission, so exhaustion can only happen here,
        never mid-decode, and a refused sequence stays queued with nothing
        to unwind. Raises :class:`KVPoolExhausted` when the free list is
        short."""
        if total_tokens > self.max_seq_len:
            raise MXNetError(
                f"sequence {sid} wants {total_tokens} tokens, pool "
                f"{self.name!r} is laid out for max_seq_len="
                f"{self.max_seq_len}")
        need = int(math.ceil(total_tokens / self.page_size))
        with self._lock:
            table = self._tables.setdefault(sid, [])
            delta = need - len(table)
            if delta <= 0:
                return
            if delta > len(self._free):
                raise KVPoolExhausted(
                    f"RESOURCE_EXHAUSTED: KV pool {self.name!r} has "
                    f"{len(self._free)} free pages, sequence {sid} needs "
                    f"{delta} more (of {need} for {total_tokens} tokens)")
            for _ in range(delta):
                table.append(self._free.pop())

    def free(self, sid: int) -> int:
        """Return ``sid``'s pages to the free list, where later reservations
        reuse them; compacts the pool when ``MXNET_KV_DEFRAG_RATIO`` > 0 and
        the spread exceeds it. Returns the number of pages freed."""
        with self._lock:
            table = self._tables.pop(sid, None)
            if not table:
                return 0
            self._free.extend(reversed(table))
        ratio = float(_config.get("MXNET_KV_DEFRAG_RATIO"))
        if ratio > 0 and self.spread() > ratio:
            self.defrag()
        return len(table)

    def table(self, sid: int) -> np.ndarray:
        """``sid``'s page table padded with scratch-page zeros to the fixed
        (pages_per_seq,) shape."""
        out = np.zeros((self.pages_per_seq,), np.int32)
        with self._lock:
            pages = self._tables.get(sid, ())
            out[:len(pages)] = pages
        return out

    # -- accounting ---------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return (self.num_pages - 1) - len(self._free)

    def occupancy(self) -> float:
        """Fraction of usable pages owned by live sequences (0..1)."""
        return self.pages_in_use / max(1, self.num_pages - 1)

    def spread(self) -> float:
        """Fragmentation proxy: highest allocated page id / pages in use.
        1.0 means perfectly compact."""
        with self._lock:
            used = [p for t in self._tables.values() for p in t]
            if not used:
                return 1.0
            return max(used) / len(used)

    def snapshot(self) -> Dict:
        with self._lock:
            used = (self.num_pages - 1) - len(self._free)
            return {
                "pool": self.name,
                "pages": self.num_pages - 1,
                "page_size": self.page_size,
                "in_use": used,
                "occupancy": used / max(1, self.num_pages - 1),
                "sequences": len(self._tables),
                "pages_per_seq": self.pages_per_seq,
                "bytes": int(self.k_pool.nbytes) + int(self.v_pool.nbytes),
            }

    def defrag(self) -> int:
        """Compact live pages down to the lowest physical ids (worker thread
        only). The move is a gather then a scatter of whole pages, no
        arithmetic, so decode output stays bitwise identical across it.
        Returns the number of pages moved."""
        with self._lock:
            order = sorted(
                (p, sid, i)
                for sid, t in self._tables.items() for i, p in enumerate(t))
            moves = [(old, new + 1, sid, i)
                     for new, (old, sid, i) in enumerate(order)
                     if old != new + 1]
            if moves:
                dev = self.k_pool.device
                old_ids = torch.tensor([m[0] for m in moves], device=dev)
                new_ids = torch.tensor([m[1] for m in moves], device=dev)
                self.k_pool[:, new_ids] = self.k_pool[:, old_ids]
                self.v_pool[:, new_ids] = self.v_pool[:, old_ids]
                for old, new, sid, i in moves:
                    self._tables[sid][i] = new
            self._free = list(range(self.num_pages - 1, len(order), -1))
        return len(moves)
