"""Fleet collector — one pane over every replica's and process's registry
(the port of ``mxnet_tpu/telemetry/fleet.py``).

A serving deployment is a *fleet* (ServingPool replicas, autoscaling,
front-door host processes, supervised worker generations) while every
other observability surface is per-process. This module is the
aggregation layer:

  - :func:`merge_snapshots` folds N registry snapshots (the in-process
    registry, sibling processes' ``telemetry.dump()`` files, a
    ``/metricsz?json=1`` scrape) into ONE snapshot-shaped dict where every
    series gains a ``replica`` label — renderable by the same
    ``prometheus_from_snapshot`` / ``tools/metrics_dump.py`` code paths
    that render a single process.
  - :func:`merge_histogram_series` is the correctness kernel: for identical
    bucket ladders, cross-replica merging is an element-wise bucket-count
    sum, so the merged quantiles are exactly the quantiles of the
    concatenated observations.
  - :class:`FleetCollector` adds the live half: the local registry, dump
    files (``MXNET_FLEET_DUMP_GLOB``), attached ServingPools/Autoscalers
    (via ``debug_server``'s weak registries), and a fleet-level health
    rollup — worst-of replica health + autoscaler state + supervisor worker
    epochs — exported as ``mxtpu_fleet_*`` gauges and the ``/fleetz`` page.

Everything here is host arithmetic on snapshots and ``health()`` dicts;
nothing reads the card. Offline rendering: ``tools/fleet_report.py``.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from .metrics import REGISTRY, _quantile_from_buckets

__all__ = ["merge_histogram_series", "merge_snapshots", "FleetCollector",
           "health_rollup", "collect"]

_FLEET_PROCESSES = REGISTRY.gauge(
    "mxtpu_fleet_processes",
    "Processes/replicas folded into the last fleet collection (the local "
    "registry counts as one).")
_FLEET_REPLICAS = REGISTRY.gauge(
    "mxtpu_fleet_replicas",
    "Serving replicas across every attached ServingPool, by state "
    "(rotation / draining).",
    labelnames=("state",))
_FLEET_HEALTH = REGISTRY.gauge(
    "mxtpu_fleet_health",
    "Fleet health rollup: 0 = ok, 1 = degraded, 2 = down (worst-of "
    "replica health + autoscaler + supervisor state).")

_HEALTH_RANK = {"ok": 0, "degraded": 1, "down": 2}


def merge_histogram_series(bounds: Sequence[float],
                           entries: Sequence[Dict]) -> Dict:
    """Merge histogram series sharing one bucket ladder into one series.

    Element-wise bucket-count sums: because each observation lands in
    exactly one bucket, summing counts per bucket is *exactly* the histogram
    of the concatenated observations — merged quantiles equal the quantiles
    a single replica would have reported had it seen every observation.
    """
    n_buckets = len(bounds) + 1          # + the +Inf overflow bucket
    counts = [0] * n_buckets
    n = 0
    total = 0.0
    mn: Optional[float] = None
    mx = 0.0
    for s in entries:
        bc = s.get("bucket_counts") or []
        if len(bc) != n_buckets:
            raise ValueError(
                f"bucket ladder mismatch: series has {len(bc)} buckets, "
                f"ladder implies {n_buckets}")
        for i, c in enumerate(bc):
            counts[i] += c
        sn = int(s.get("count", 0))
        n += sn
        total += float(s.get("sum", 0.0))
        if sn:
            smin = float(s.get("min", 0.0))
            mn = smin if mn is None else min(mn, smin)
            mx = max(mx, float(s.get("max", 0.0)))
    return {
        "count": n,
        "sum": total,
        "mean": (total / n) if n else 0.0,
        "min": mn if mn is not None else 0.0,
        "max": mx,
        "p50": _quantile_from_buckets(bounds, counts, n, 50, mx),
        "p95": _quantile_from_buckets(bounds, counts, n, 95, mx),
        "p99": _quantile_from_buckets(bounds, counts, n, 99, mx),
        "bucket_counts": counts,
    }


def merge_snapshots(snaps: Dict[str, Dict], replica_label: str = "replica",
                    merged_series: bool = True) -> Dict:
    """Fold ``{replica_name: snapshot}`` into one snapshot-shaped dict.

    Every series gains a ``replica=<name>`` label, so same-name series from
    different replicas never collide and per-replica values stay visible.
    With ``merged_series`` (the default), each histogram family additionally
    grows one ``replica=ALL`` series per distinct label set — the
    bucket-merged fleet view whose quantiles are the true cross-replica
    quantiles — and each counter family an ``ALL`` sum. Families whose
    bucket ladders differ across replicas keep their per-replica series but
    skip the ``ALL`` row (merging mismatched ladders would fabricate data).
    """
    out: Dict = {"ts": time.time(), "metrics": {},
                 "replicas": sorted(snaps.keys())}
    fams: Dict[str, Dict] = out["metrics"]
    for rep in sorted(snaps.keys()):
        snap = snaps[rep] or {}
        for name, fam in (snap.get("metrics") or {}).items():
            dst = fams.get(name)
            if dst is None:
                dst = fams[name] = {
                    "type": fam.get("type", "untyped"),
                    "help": fam.get("help", ""),
                    "label_names": [replica_label] +
                                   list(fam.get("label_names", [])),
                    "series": [],
                }
                if "bucket_bounds" in fam:
                    dst["bucket_bounds"] = list(fam["bucket_bounds"])
            for s in fam.get("series", []):
                entry = dict(s)
                entry["labels"] = {replica_label: rep,
                                   **(s.get("labels") or {})}
                # mismatched ladders can't be cross-checked per series
                # here; remember the source ladder for the ALL pass
                entry["_bounds"] = fam.get("bucket_bounds")
                dst["series"].append(entry)
    if merged_series:
        for name, fam in fams.items():
            _add_all_series(fam, replica_label)
    for fam in fams.values():
        for s in fam["series"]:
            s.pop("_bounds", None)
    return out


def _add_all_series(fam: Dict, replica_label: str):
    """Append the ``replica=ALL`` rollup series per distinct label set."""
    groups: Dict[tuple, List[Dict]] = {}
    for s in fam["series"]:
        key = tuple(sorted((k, v) for k, v in s["labels"].items()
                           if k != replica_label))
        groups.setdefault(key, []).append(s)
    for key, group in sorted(groups.items()):
        if len(group) < 2:
            continue
        labels = {replica_label: "ALL", **dict(key)}
        if fam["type"] == "histogram":
            bounds = fam.get("bucket_bounds")
            if bounds is None or any(s.get("_bounds") != bounds
                                     for s in group):
                continue
            try:
                merged = merge_histogram_series(bounds, group)
            except ValueError:
                continue
            merged["labels"] = labels
            fam["series"].append(merged)
        elif fam["type"] == "counter":
            fam["series"].append({
                "labels": labels,
                "value": sum(float(s.get("value", 0)) for s in group)})
        # gauges: summing or averaging fabricates a value no process
        # reported — per-replica rows only


def _load_dump(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def health_rollup() -> Dict:
    """Worst-of fleet health from everything attached to the debug layer:
    per-server ``health()``, per-pool replica membership, autoscaler
    cooldown/hysteresis, supervisor worker epochs."""
    from . import debug_server as _dbg

    status = "ok"
    servers = []
    for srv in _dbg.attached_servers():
        try:
            h = srv.health()
        except Exception as e:
            h = {"state": f"error: {e}"}
        st = str(h.get("state", "?"))
        s = "ok" if st in ("serving", "running", "ok") else \
            ("down" if st in ("stopped", "closed") else "degraded")
        servers.append({"state": st, "status": s, "health": h})
        if _HEALTH_RANK.get(s, 1) > _HEALTH_RANK[status]:
            status = s
    pools = []
    rotation = draining = 0
    for pool in _dbg.attached_pools():
        try:
            psnap = pool.snapshot()
        except Exception as e:
            psnap = {"error": str(e)}
        pools.append(psnap)
        # a pool lists the replicas in its rotation, each with its server's
        # state: a running one serves, any other is on its way out (the
        # reference compares with "rotation", a state no server has, and
        # so counts every replica as draining)
        for r in psnap.get("replicas", []):
            if r.get("state") == "running":
                rotation += 1
            else:
                draining += 1
    autoscalers = []
    for asc in _dbg.attached_autoscalers():
        try:
            autoscalers.append(asc.snapshot())
        except Exception as e:
            autoscalers.append({"error": str(e)})
    epochs = {}
    for srv in _dbg.attached_servers():
        try:
            h = srv.health()
            if "worker_epoch" in h:
                epochs[str(id(srv))] = {
                    "worker_epoch": h.get("worker_epoch"),
                    "failovers": h.get("failovers")}
        except Exception:
            pass
    _FLEET_REPLICAS.labels("rotation").set(rotation)
    _FLEET_REPLICAS.labels("draining").set(draining)
    _FLEET_HEALTH.set(_HEALTH_RANK[status])
    return {"status": status, "servers": servers, "pools": pools,
            "replicas": {"rotation": rotation, "draining": draining},
            "autoscalers": autoscalers, "supervisor_epochs": epochs}


class FleetCollector:
    """Merge the local registry with sibling processes' snapshot dumps.

    Sources:
      - the live in-process registry (``include_local``, label
        ``local-<pid>``);
      - explicit ``add_snapshot(label, snap)`` / ``add_file(path)``;
      - every file matching ``MXNET_FLEET_DUMP_GLOB`` (or an explicit
        ``glob`` argument) at :meth:`collect` time — the reporter dump
        files subprocesses already write.
    """

    def __init__(self, include_local: bool = True,
                 local_label: Optional[str] = None,
                 glob: Optional[str] = None):
        self.include_local = include_local
        self.local_label = local_label or f"local-{os.getpid()}"
        self._glob = glob
        self._snaps: Dict[str, Dict] = {}

    def add_snapshot(self, label: str, snap: Dict) -> "FleetCollector":
        self._snaps[str(label)] = snap
        return self

    def add_file(self, path: str,
                 label: Optional[str] = None) -> "FleetCollector":
        snap = _load_dump(path)
        if snap is not None:
            self.add_snapshot(label or os.path.basename(path), snap)
        return self

    def _dump_glob(self) -> str:
        if self._glob is not None:
            return self._glob
        try:
            from .. import config
        except ImportError:
            return ""
        return str(config.get("MXNET_FLEET_DUMP_GLOB") or "")

    def collect(self) -> Dict:
        """One fleet view: merged metrics + per-source freshness + the
        health rollup. Refreshes the ``mxtpu_fleet_*`` gauges."""
        snaps = dict(self._snaps)
        pattern = self._dump_glob()
        if pattern:
            for path in sorted(_glob.glob(pattern)):
                snap = _load_dump(path)
                if snap is not None:
                    snaps.setdefault(os.path.basename(path), snap)
        health = health_rollup()   # before the local snapshot: the fleet
        # gauges it refreshes should be visible in this collection
        if self.include_local:
            snaps[self.local_label] = REGISTRY.snapshot()
        _FLEET_PROCESSES.set(len(snaps))
        sources = {
            label: {"ts": snap.get("ts"),
                    "age_s": (round(time.time() - snap["ts"], 3)
                              if snap.get("ts") else None),
                    "families": len(snap.get("metrics") or {})}
            for label, snap in snaps.items()}
        return {"ts": time.time(),
                "processes": len(snaps),
                "sources": sources,
                "merged": merge_snapshots(snaps),
                "health": health}


def collect(**kw) -> Dict:
    """One-shot :class:`FleetCollector` collection (the ``/fleetz`` page)."""
    return FleetCollector(**kw).collect()
