"""DecodeEndpoint: one generative model plus its paged KV pool, run in the
two bucket families decode needs (the port of
``mxnet_tpu/serving/generate/engine.py``).

- **prefill**, bucketed by sequence length (``seq_buckets``): one causal
  ``prefill_collect`` of a single prompt padded to its bucket (each layer's
  attention one causal flash-attention call, K1 on the card), every layer's
  K/V scattered into the sequence's pages, greedy argmax at ``length - 1``.
- **decode step**, bucketed by batch size (pow2): gather each row's cached
  context through its page table, ``decode_step`` (``single_query_attention``
  inside), scatter the new K/V row, greedy argmax.

PyTorch runs eagerly, so "compiling" a bucket means its first run, as in
``ModelEndpoint``; ``warmup`` runs every bucket once. Device work runs under
``torch.inference_mode()`` on one thread at a time (the decode scheduler's
worker: the serving single-dispatcher rule).

Bitwise contract: batched continuous decode equals one-sequence-at-a-time
greedy decode. A row's tokens must therefore not depend on the batch it is
in. Masked attention lanes carry an exactly-zero weight, so stale page
contents, padding and page placement are invisible; what remains is the
matrix products, whose library kernels are chosen by the row count M (on the
CPU a lone row of ``F.linear`` rounds differently from the same row in a
batch; cuBLAS picks its GEMM by M too). So every decode step runs its
products (each Dense and the LM head) on one fixed row count, the top
decode bucket ``R = max_batch_size``: the step's ids and positions are
padded to R rows, and only the gather and the attention, whose bytes grow
with the rows, run at the batch bucket B. At a fixed M a row's result does
not depend on its position or on the other rows. The products read the
same weights at any M <= R, so the padding costs little where the step is
bound by reading them.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import config as _config
from ...base import Context, MXNetError, current_context
from ...resilience import faults as _faults
from .. import bucketing
from ..router import StepCostEWMA
from .kv_cache import PagedKVPool, gather_ctx, write_prefill, write_step
from .stats import DecodeStats

__all__ = ["DecodeEndpoint"]

_PROTOCOL = ("num_layers", "units", "prefill_collect", "decode_step")


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class DecodeEndpoint:
    """A named generative model with bucketed prefill and decode steps.

    ``block`` must expose the incremental-decode protocol of
    ``gluon.model_zoo.bert.TransformerLM``: ``num_layers``/``units``
    attributes, ``prefill_collect(tokens)`` and ``decode_step(ids,
    positions, *kv_ctx)`` taking ids/positions for more rows than the
    context has. It is moved to the endpoint's device and put in eval mode;
    the KV pools take its parameters' dtype. ``ctx`` defaults to
    :func:`current_context`, which is ``gpu(0)``.
    """

    def __init__(self, name: str, block, *, max_seq_len: int = 128,
                 max_batch_size: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 decode_buckets: Optional[Sequence[int]] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 ctx: Optional[Context] = None):
        self.name = name
        self.ctx = ctx if ctx is not None else current_context()
        self.device = self.ctx.torch_device()
        self.max_seq_len = int(max_seq_len)
        if max_batch_size is None:
            max_batch_size = int(_config.get("MXNET_DECODE_MAX_BATCH"))
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        if decode_buckets is None:
            decode_buckets = bucketing.pow2_buckets(self.max_batch_size)
        self.decode_buckets = bucketing.validate_buckets(
            decode_buckets, self.max_batch_size)
        self.prefill_buckets = bucketing.seq_buckets(
            self.max_seq_len, ladder=prefill_buckets)
        self.block = block
        self._probe()
        block.to(self.device).eval()
        self.stats = DecodeStats(name)
        # per decode batch bucket and per prefill seq bucket (us)
        self.step_cost = StepCostEWMA(name=f"{name}.decode")
        self.prefill_cost = StepCostEWMA(name=f"{name}.prefill")
        self._warm_prefill = set()
        self._warm_decode = set()
        self.pool = self._make_pool(name, int(block.num_layers),
                                    int(block.units), self.max_seq_len,
                                    page_size=page_size, num_pages=num_pages,
                                    dtype=next(block.parameters()).dtype,
                                    ctx=self.ctx)

    def _make_pool(self, *args, **kw) -> PagedKVPool:
        """The endpoint's KV pool (the sharded twin keeps replicas)."""
        return PagedKVPool(*args, **kw)

    def _probe(self):
        """Validate the block's decode protocol and position table."""
        for attr in _PROTOCOL:
            if not hasattr(self.block, attr):
                raise MXNetError(
                    f"decode endpoint {self.name!r}: block lacks the "
                    f"incremental-decode protocol member {attr!r} "
                    "(see gluon.model_zoo.bert.TransformerLM)")
        max_len = getattr(self.block, "max_length", None)
        if max_len is not None and self.max_seq_len > int(max_len):
            raise MXNetError(
                f"max_seq_len={self.max_seq_len} exceeds the model's "
                f"position-embedding table ({max_len})")

    def _first_run(self, warm: set, bucket: int) -> bool:
        """Record a bucket's first run (its "compile"): the ``compile``
        fault site, then the count."""
        if bucket in warm:
            return False
        _faults.check("compile")
        warm.add(bucket)
        self.stats.record_compile()
        return True

    # ------------------------------------------------------------------
    # the two steps (decode-worker thread only)
    # ------------------------------------------------------------------
    def _prefill(self, host: np.ndarray, S: int, length: int) -> int:
        """One prefill at bucket ``S``. ``host`` holds the S padded tokens
        followed by the sequence's page table (one transfer)."""
        with torch.inference_mode():
            dev = torch.from_numpy(host).to(self.device)
            outs = self.block.prefill_collect(dev[:S].view(1, S))
            self._write_prefill(torch.stack(outs[1::2])[:, 0],
                                torch.stack(outs[2::2])[:, 0], dev[S:],
                                length)
            next_id = outs[0][0, length - 1].argmax()
        return int(next_id)                    # sync point

    def _write_prefill(self, k, v, table, length: int):
        """Scatter a prefill's K and V (num_layers, S, kv_dim) into the
        sequence's pages (the sharded twin writes every replica)."""
        ps = self.pool.page_size
        write_prefill(self.pool.k_pool, k, table, length, ps)
        write_prefill(self.pool.v_pool, v, table, length, ps)

    def _step_outputs(self, dev, B: int, pools=None, run=None):
        """The model's decode step over ``dev``, the device copy of
        :meth:`_decode_host`'s rows: gather the first ``B`` rows' context
        from ``pools`` (K and V; default this endpoint's pool), run ``run``
        (default the block's ``decode_step``) on all R rows. Returns its
        outputs (logits and each layer's new k, v; R rows each). The
        sharded twin passes a group's replica and its copy of the block."""
        k_pool, v_pool = pools or (self.pool.k_pool, self.pool.v_pool)
        tables = dev[:B, 3:]
        gk = gather_ctx(k_pool, tables)                 # (layers, B, L, kv)
        gv = gather_ctx(v_pool, tables)
        ctx = [t for i in range(self.block.num_layers) for t in (gk[i], gv[i])]
        return (run or self.block.decode_step)(dev[:, 0], dev[:, 1], *ctx)

    def _decode(self, host: np.ndarray, B: int) -> np.ndarray:
        """One decode step at batch bucket ``B``. ``host`` is (R, 3 + P):
        per row its input id, position, valid flag and page table; rows
        past B only pad the products to R rows."""
        ps = self.pool.page_size
        with torch.inference_mode():
            dev = torch.from_numpy(host).to(self.device)
            outs = self._step_outputs(dev, B)
            pos, valid, tables = dev[:B, 1], dev[:B, 2].bool(), dev[:B, 3:]
            write_step(self.pool.k_pool, torch.stack(outs[1::2])[:, :B],
                       tables, pos, valid, ps)
            write_step(self.pool.v_pool, torch.stack(outs[2::2])[:, :B],
                       tables, pos, valid, ps)
            next_ids = outs[0][:B].argmax(dim=-1)
        return next_ids.cpu().numpy()          # sync point

    def _prefill_host(self, prompt: Sequence[int], S: int,
                      table: np.ndarray) -> np.ndarray:
        host = np.zeros((S + self.pool.pages_per_seq,), np.int64)
        host[:len(prompt)] = prompt
        host[S:] = table
        return host

    def _decode_host(self, rows) -> np.ndarray:
        host = np.zeros((self.max_batch_size, 3 + self.pool.pages_per_seq),
                        np.int64)
        for i, (tok, pos, table) in enumerate(rows):
            host[i, :3] = tok, pos, 1
            host[i, 3:] = table
        return host

    def warmup(self) -> int:
        """Run every prefill and decode bucket not run yet once, seeding both
        step-cost EWMAs. Warm-up only ever writes scratch page 0 (zero page
        tables, no valid row), so it cannot perturb a later sequence.
        Returns the number of buckets run."""
        n = 0
        zeros = np.zeros((self.pool.pages_per_seq,), np.int32)
        for b in self.prefill_buckets:
            if self._first_run(self._warm_prefill, b):
                t0 = _now_us()
                self._prefill(self._prefill_host([0], b, zeros), b, 1)
                self.prefill_cost.observe(b, _now_us() - t0)
                n += 1
        for b in self.decode_buckets:
            if self._first_run(self._warm_decode, b):
                host = self._decode_host(())
                t0 = _now_us()
                self._decode(host, b)
                self.step_cost.observe(b, _now_us() - t0)
                n += 1
        return n

    def prefill(self, prompt: Sequence[int], table: np.ndarray) -> int:
        """Run one prompt through its sequence-length bucket: the
        sequence's pages fill with K/V and the first generated token comes
        back."""
        n = len(prompt)
        S = bucketing.bucket_for(n, self.prefill_buckets)
        self._first_run(self._warm_prefill, S)
        host = self._prefill_host(prompt, S, table)
        t0 = _now_us()
        out = self._prefill(host, S, n)
        dt = _now_us() - t0
        self.prefill_cost.observe(S, dt)
        self.stats.record_prefill(dt)
        return out

    def decode_step(self, rows: Sequence[Tuple[int, int, np.ndarray]]
                    ) -> Tuple[int, ...]:
        """One batched decode step. ``rows`` is ``(input_id, position,
        page_table)`` per running sequence; returns the next token id per
        row. Padding rows (bucket fill) carry zero tables and no valid flag:
        their writes land on scratch page 0."""
        n = len(rows)
        B = bucketing.bucket_for(n, self.decode_buckets)
        self._first_run(self._warm_decode, B)
        host = self._decode_host(rows)
        t0 = _now_us()
        out = self._decode(host, B)
        dt = _now_us() - t0
        self.step_cost.observe(B, dt)
        self.stats.record_step(dt, n, B)
        return tuple(int(x) for x in out[:n])

    def snapshot(self) -> Dict:
        return {
            "endpoint": self.name,
            "prefill_buckets": list(self.prefill_buckets),
            "decode_buckets": list(self.decode_buckets),
            "executables": len(self._warm_prefill) + len(self._warm_decode),
            "stats": self.stats.snapshot(),
            "kv_pool": self.pool.snapshot(),
        }

    def __repr__(self):
        return (f"DecodeEndpoint({self.name!r}, "
                f"prefill_buckets={self.prefill_buckets}, "
                f"decode_buckets={self.decode_buckets}, "
                f"device={self.device})")
