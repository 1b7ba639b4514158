"""Device-memory attribution: who owns the bytes the allocator reports (the
port of ``mxnet_tpu/telemetry/memstats.py``).

The raw per-device gauge (``mxtpu_device_memory_bytes``) says *how much*
device memory is in use; this module says *whose* it is. Subsystems register
a :class:`Holder` for every pool of device memory they pin — endpoint
parameters and staging slots, the ParallelTrainStep's train state, the
KV-cache pool — either
with a static byte count or with a ``sizer`` callback evaluated at
reconcile time (holders keep only a weakref to their owner, so a dead
endpoint drops off the table instead of pinning itself).

``reconcile()`` folds the holder table against the device's memory stats:
per-device attributed bytes, the unattributed residual (activations,
workspaces, anything nobody registered), and live/peak gauges. The ranked
``breakdown()`` is what an OOM post-mortem needs — an out-of-memory error
classified by RetryPolicy fires an ``oom`` flight trigger whose bundle
carries this table.

The device side is PyTorch's caching allocator: ``torch.cuda.memory_stats(i)``
for every visible card, under the label ``gpu:<i>`` (JAX's
``platform:id``), read on the host without waiting for the card. The
reference's PJRT stats map onto its keys so:

- ``bytes_in_use`` <- ``allocated_bytes.all.current`` (live tensors);
- ``peak_bytes_in_use`` <- ``allocated_bytes.all.peak``;
- ``bytes_limit`` <- the card's ``total_memory``;
- ``bytes_reserved`` <- ``reserved_bytes.all.current`` (the allocator's
  cached segments; PJRT has no counterpart);
- ``largest_alloc_size``: PyTorch keeps no such figure, so it is absent.

The CPU reports nothing, as the reference's CPU backend does
(``memory_stats()`` is ``None`` there); reconciliation then reports holders
only (tests inject synthetic device stats).
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from .metrics import REGISTRY

__all__ = ["Holder", "register", "nbytes_of", "holders", "reconcile",
           "breakdown", "reset", "device_label"]

_HOLDER_BYTES = REGISTRY.gauge(
    "mxtpu_mem_holder_bytes",
    "Live device bytes attributed to one registered holder "
    "(endpoint params, bucket executables, train state, numerics "
    "snapshots, prepared batches).",
    labelnames=("subsystem", "holder"))
_HOLDER_PEAK = REGISTRY.gauge(
    "mxtpu_mem_holder_peak_bytes",
    "High-water mark of one holder's attributed bytes.",
    labelnames=("subsystem", "holder"))
_ATTRIBUTED = REGISTRY.gauge(
    "mxtpu_mem_attributed_bytes",
    "Sum of holder bytes per device label at the last reconcile.",
    labelnames=("device",))
_UNATTRIBUTED = REGISTRY.gauge(
    "mxtpu_mem_unattributed_bytes",
    "device.memory_stats() bytes_in_use minus attributed bytes (allocator "
    "slack, XLA scratch, unregistered pins); persistent growth here is a "
    "leak nobody owns.",
    labelnames=("device",))

_LOCK = threading.Lock()
_HOLDERS: Dict[tuple, "Holder"] = {}


def _cfg(name, default):
    # narrow: only the circular-import window during interpreter startup
    # (config not importable yet) falls back to the built-in default
    try:
        from .. import config
    except ImportError:
        return default
    return config.get(name)


def device_label(device) -> str:
    """The label a holder on the torch ``device`` carries, the one
    :func:`reconcile` reads the card's stats under: ``gpu:<i>`` on a card,
    ``cpu:0`` on the host (which reports no stats)."""
    if device.type == "cuda":
        return f"gpu:{device.index or 0}"
    return "cpu:0"


def _enabled() -> bool:
    return bool(_cfg("MXNET_MEM_TRACK", True))


def nbytes_of(tree) -> int:
    """Total bytes of every array leaf in ``tree`` (anything with an
    ``nbytes``: tensors, numpy arrays; NDArrays unwrap to their tensor). A
    tensor that shares its memory with one already counted (the same
    device address) counts once. Never raises."""
    total = 0
    seen = set()
    stack = [tree]
    while stack:
        x = stack.pop()
        if x is None:
            continue
        if isinstance(x, dict):
            stack.extend(x.values())
            continue
        if isinstance(x, (list, tuple)):
            stack.extend(x)
            continue
        data = getattr(x, "_data", None)
        if data is not None and hasattr(data, "nbytes") \
                and not hasattr(x, "nbytes"):
            x = data
        try:
            nb = x.nbytes
            ptr = x.data_ptr() if hasattr(x, "data_ptr") else 0
        except Exception:
            continue
        if ptr:
            key = (str(x.device), ptr, nb)
            if key in seen:
                continue
            seen.add(key)
        if isinstance(nb, (int, float)):
            total += int(nb)
    return total


class Holder:
    """One registered pool of pinned device memory."""

    __slots__ = ("subsystem", "name", "device", "_nbytes", "peak", "ts",
                 "_owner", "_sizer", "_released")

    def __init__(self, subsystem: str, name: str, nbytes: int = 0,
                 device: str = "", owner: Any = None,
                 sizer: Optional[Callable[[Any], int]] = None):
        self.subsystem = str(subsystem)
        self.name = str(name)
        self.device = str(device)
        self._nbytes = int(nbytes)
        self.peak = int(nbytes)
        self.ts = time.time()
        self._owner = weakref.ref(owner) if owner is not None else None
        self._sizer = sizer
        self._released = False

    def current(self) -> Optional[int]:
        """Live byte count; None when the owner died (prune me)."""
        if self._released:
            return None
        if self._sizer is not None:
            owner = None
            if self._owner is not None:
                owner = self._owner()
                if owner is None:
                    return None
            try:
                self._nbytes = int(self._sizer(owner) if self._owner
                                   is not None else self._sizer(None))
            except Exception:
                pass          # keep the last good figure
        elif self._owner is not None and self._owner() is None:
            return None
        self.peak = max(self.peak, self._nbytes)
        return self._nbytes

    def update(self, nbytes: int):
        """Set a static holder's byte count (and bump its peak/gauges)."""
        self._nbytes = int(nbytes)
        self.peak = max(self.peak, self._nbytes)
        self.ts = time.time()
        try:
            _HOLDER_BYTES.labels(self.subsystem, self.name).set(self._nbytes)
            _HOLDER_PEAK.labels(self.subsystem, self.name).set(self.peak)
        except Exception:
            pass

    def release(self):
        """Drop the holder (freed its memory); the gauge child zeros."""
        self._released = True
        with _LOCK:
            _HOLDERS.pop((self.subsystem, self.name), None)
        try:
            _HOLDER_BYTES.labels(self.subsystem, self.name).set(0)
        except Exception:
            pass


class _NullHolder(Holder):
    """Returned when MXNET_MEM_TRACK=0: accepts the API, records nothing."""

    def __init__(self):
        super().__init__("disabled", "disabled")

    def current(self):
        return None

    def update(self, nbytes: int):
        pass

    def release(self):
        pass


def register(subsystem: str, name: str, nbytes: int = 0, device: str = "",
             owner: Any = None,
             sizer: Optional[Callable[[Any], int]] = None) -> Holder:
    """Register (or replace) the holder ``(subsystem, name)``.

    ``sizer(owner)`` makes the holder live: evaluated at every reconcile so
    the table tracks state that changes shape (donated train state, growing
    executable caches) without per-step bookkeeping. ``owner`` is held
    weakly; once it is collected the holder prunes itself.
    """
    if not _enabled():
        return _NullHolder()
    h = Holder(subsystem, name, nbytes=nbytes, device=device, owner=owner,
               sizer=sizer)
    with _LOCK:
        _HOLDERS[(h.subsystem, h.name)] = h
    if sizer is None:
        h.update(nbytes)
    return h


def holders() -> List[Dict]:
    """The live holder table, largest first; dead holders are pruned."""
    with _LOCK:
        items = list(_HOLDERS.values())
    rows = []
    for h in items:
        nb = h.current()
        if nb is None:
            with _LOCK:
                _HOLDERS.pop((h.subsystem, h.name), None)
            try:
                _HOLDER_BYTES.labels(h.subsystem, h.name).set(0)
            except Exception:
                pass
            continue
        try:
            _HOLDER_BYTES.labels(h.subsystem, h.name).set(nb)
            _HOLDER_PEAK.labels(h.subsystem, h.name).set(h.peak)
        except Exception:
            pass
        rows.append({"subsystem": h.subsystem, "holder": h.name,
                     "device": h.device, "bytes": nb, "peak_bytes": h.peak})
    rows.sort(key=lambda r: r["bytes"], reverse=True)
    return rows


# the reference's stat name -> the caching allocator's key
_TORCH_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
               ("peak_bytes_in_use", "allocated_bytes.all.peak"),
               ("bytes_reserved", "reserved_bytes.all.current"))


def _device_stats() -> Dict[str, Dict[str, int]]:
    """{'gpu:0': {'bytes_in_use': ..., 'peak_bytes_in_use': ...,
    'bytes_limit': ..., 'bytes_reserved': ...}, ...} from PyTorch's caching
    allocator, for every visible card; empty on the CPU and before CUDA was
    first used in this process (nothing was allocated on a card yet, and
    reading must not create a CUDA context)."""
    out: Dict[str, Dict[str, int]] = {}
    import torch
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        raw = torch.cuda.memory_stats(i)
        stats = {k: int(raw.get(t, 0)) for k, t in _TORCH_KEYS}
        stats["bytes_limit"] = int(
            torch.cuda.get_device_properties(i).total_memory)
        out[f"gpu:{i}"] = stats
    return out


def reconcile(device_stats: Optional[Dict[str, Dict[str, int]]] = None
              ) -> Dict[str, Dict[str, int]]:
    """Fold the holder table against per-device memory stats.

    Returns ``{device: {bytes_in_use, peak_bytes_in_use, attributed,
    unattributed}}``. Holders whose ``device`` label matches a reported
    device attribute there; holders with no/unknown device labels attribute
    to every reported device is wrong — they land under the pseudo-device
    ``"unassigned"`` instead, so the residual stays honest. ``device_stats``
    is injectable for tests (CPU reports nothing).
    """
    rows = holders()
    stats = _device_stats() if device_stats is None else dict(device_stats)
    attributed: Dict[str, int] = {}
    for r in rows:
        dev = r["device"] if r["device"] in stats else "unassigned"
        attributed[dev] = attributed.get(dev, 0) + r["bytes"]
    out: Dict[str, Dict[str, int]] = {}
    for dev, st in stats.items():
        in_use = int(st.get("bytes_in_use", 0))
        attr = attributed.get(dev, 0)
        out[dev] = {
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(st.get("peak_bytes_in_use", 0)),
            "attributed": attr,
            "unattributed": in_use - attr,
        }
        try:
            _ATTRIBUTED.labels(dev).set(attr)
            _UNATTRIBUTED.labels(dev).set(in_use - attr)
        except Exception:
            pass
    if "unassigned" in attributed and "unassigned" not in out:
        out["unassigned"] = {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                             "attributed": attributed["unassigned"],
                             "unattributed": -attributed["unassigned"]}
        try:
            _ATTRIBUTED.labels("unassigned").set(attributed["unassigned"])
        except Exception:
            pass
    return out


def breakdown(limit: Optional[int] = None,
              device_stats: Optional[Dict[str, Dict[str, int]]] = None
              ) -> Dict:
    """The OOM post-mortem payload: ranked holder table + per-device
    reconciliation + totals, one JSON-able dict."""
    if limit is None:
        limit = int(_cfg("MXNET_MEM_HOLDERS_KEEP", 32))
    rows = holders()
    shown = rows[:max(0, limit)]
    return {
        "ts": time.time(),
        "holders": shown,
        "holders_total": len(rows),
        "holders_omitted_bytes": sum(r["bytes"] for r in rows[limit:]),
        "attributed_bytes": sum(r["bytes"] for r in rows),
        "devices": reconcile(device_stats),
    }


def reset():
    """Drop every holder (tests)."""
    with _LOCK:
        for h in list(_HOLDERS.values()):
            try:
                _HOLDER_BYTES.labels(h.subsystem, h.name).set(0)
            except Exception:
                pass
        _HOLDERS.clear()
