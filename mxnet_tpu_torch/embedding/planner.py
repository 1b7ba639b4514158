"""Per-table placement planning: partition, replicate or row-wise (the
counterpart of ``mxnet_tpu/embedding/planner.py``).

The decision is driven by the table's footprint (replicating a tiny table
is cheaper than any exchange), its vocab size (a table that does not cover
the mesh axis cannot be partitioned usefully), and the **observed
hotness** of its rows (a frequency-sorted vocabulary concentrates traffic
in the low ids; block partitioning then makes rank 0 the hot spot, which
cyclic "row-wise" placement spreads flat).

Every decision carries its reason on the returned :class:`TablePlan`; the
reference's ``emb_plan`` event and ``mxtpu_emb_table_placements_total``
counter wait for the port's telemetry (ROADMAP Q1.12), as does the
``mxtpu_emb_hot_row_hit_rate`` gauge (:meth:`HotnessTracker.hot_hit_rate`
is its value).

    specs = [TableSpec("ads", vocab=1 << 20, dim=32),
             TableSpec("country", vocab=256, dim=32)]
    plans = plan_tables(specs, mesh, hotness={"ads": tracker})
    tables = [ShardedEmbedding(s.vocab, s.dim, mesh, name=s.name,
                               placement=p.placement, layout=p.layout)
              for s, p in zip(specs, plans)]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as onp

from .. import config as _config

__all__ = ["TableSpec", "TablePlan", "HotnessTracker", "plan_tables"]


@dataclass(frozen=True)
class TableSpec:
    """What the planner needs to know about one table."""
    name: str
    vocab: int
    dim: int
    dtype: str = "float32"

    @property
    def nbytes(self) -> int:
        return self.vocab * self.dim * onp.dtype(self.dtype).itemsize


@dataclass(frozen=True)
class TablePlan:
    """One placement decision (feeds ShardedEmbedding's constructor)."""
    name: str
    placement: str          # "replicate" | "partition"
    layout: str             # "block" | "cyclic" ("rowwise" == cyclic)
    reason: str

    @property
    def rowwise(self) -> bool:
        return self.placement == "partition" and self.layout == "cyclic"


class HotnessTracker:
    """Host-side per-table row-frequency counters.

    ``observe()`` takes each batch's raw (pre-dedup) indices; the tracker
    counts hits on the first ``cap`` rows (the head of a frequency-sorted
    vocab, where skew lives) plus a total. :meth:`hot_hit_rate` is the
    share of all observed lookups that landed in the current top-K counted
    rows."""

    def __init__(self, name: str, vocab: int, cap: Optional[int] = None,
                 topk: Optional[int] = None):
        self.name = name
        self.vocab = int(vocab)
        self.cap = min(self.vocab,
                       int(cap if cap is not None
                           else _config.get("MXNET_EMB_HOTNESS_CAP")))
        self.topk = min(self.cap,
                        int(topk if topk is not None
                            else _config.get("MXNET_EMB_HOT_TOPK")))
        self.counts = onp.zeros(self.cap, dtype=onp.int64)
        self.total = 0

    def observe(self, indices):
        idx = onp.asarray(indices).reshape(-1)
        self.total += idx.size
        head = idx[idx < self.cap]
        if head.size:
            onp.add.at(self.counts, head.astype(onp.int64), 1)

    def hot_hit_rate(self) -> float:
        """Share of observed lookups in the current top-K counted rows."""
        if not self.total:
            return 0.0
        k = min(self.topk, self.counts.size)
        top = onp.partition(self.counts, -k)[-k:] if k else 0
        return float(onp.sum(top)) / float(self.total)

    def __repr__(self):
        return (f"HotnessTracker({self.name}: total={self.total}, "
                f"hot_hit_rate={self.hot_hit_rate():.3f})")


def plan_tables(specs: Sequence[TableSpec], mesh, axis: str = "tp",
                hotness: Optional[Dict[str, HotnessTracker]] = None):
    """Place each table: replicate small ones, partition the rest, and go
    row-wise (cyclic) when observed hotness concentrates in the head.

    Rules, in order:
      1. one shard on ``axis``, or footprint <= MXNET_EMB_REPLICATE_MAX_BYTES,
         or vocab < shard count  ->  replicate (no exchange at all);
      2. a hotness tracker reports top-K hit rate >=
         MXNET_EMB_ROWWISE_HOT_FRACTION  ->  partition with cyclic layout
         (spread the hot head across shards);
      3. otherwise  ->  partition with block layout (contiguous ranges,
         cheapest index arithmetic and checkpoint locality).
    """
    n = int(mesh.axis_size(axis))
    rep_max = int(_config.get("MXNET_EMB_REPLICATE_MAX_BYTES"))
    hot_frac = float(_config.get("MXNET_EMB_ROWWISE_HOT_FRACTION"))
    hotness = hotness or {}
    plans = []
    for s in specs:
        if n <= 1 or s.nbytes <= rep_max or s.vocab < n:
            plan = TablePlan(s.name, "replicate", "block",
                             f"footprint {s.nbytes}B <= {rep_max}B or "
                             f"axis '{axis}' has {n} shard(s)")
        else:
            tracker = hotness.get(s.name)
            rate = tracker.hot_hit_rate() if tracker is not None else 0.0
            if rate >= hot_frac:
                plan = TablePlan(
                    s.name, "partition", "cyclic",
                    f"hot top-{tracker.topk} rows take {rate:.2f} of "
                    f"traffic (>= {hot_frac}): row-wise spreads the head")
            else:
                plan = TablePlan(
                    s.name, "partition", "block",
                    f"footprint {s.nbytes}B over {n} '{axis}' shards, "
                    f"hot share {rate:.2f} < {hot_frac}")
        plans.append(plan)
    return plans
