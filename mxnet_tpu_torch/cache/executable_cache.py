"""Persistent executable cache: the port's compiled kernel binaries,
content-addressed (the port of ``mxnet_tpu/cache/executable_cache.py``).

The reference stores serialized XLA executables. The port has two kinds of
compiled artifact that every new process would pay for again, and this
module stores both as plain bytes under ``MXNET_EXEC_CACHE_DIR``:

  * the nvcc libraries of the hand-written kernels (K1-K4), built by
    ``ops/_build.py`` (a ``.so`` image, loaded with ``dlopen``);
  * the NVRTC cubins of ``rtc.CudaModule`` (K5), loaded with
    ``cuModuleLoadData``.

Correctness before speed:

  * the key (:func:`build_key`) covers everything that could make a stored
    binary wrong in this process: the digest of the sources and flags, the
    compiler's version (nvcc, or NVRTC for a cubin), the torch and CUDA
    runtime versions, the device's name and compute capability, and the
    caller's trigger key (the library's name, or the rtc module and its
    exports). It never holds a device index: a binary built on one card
    loads on any card of the same kind. Any mismatch is simply a different
    key — a miss, never a wrong load;
  * entries are two files, payload (``ent-<digest>.bin``) and manifest
    (``ent-<digest>.json``), each written tmp + fsync + rename so a reader
    only ever sees a complete entry; concurrent writers race benignly (the
    last atomic rename wins, and both wrote identical bytes);
  * the manifest carries the payload's sha256; :func:`load` verifies it
    before anything uses the payload (``dlopen`` of a truncated ``.so`` can
    bring the process down), so a truncated or bit-flipped payload is
    detected, warned about, deleted and answered with a miss: the caller
    compiles the kernel again. That recompile is the only fallback;
  * the store is LRU byte-bounded (``MXNET_EXEC_CACHE_MAX_BYTES``): payload
    mtimes are the recency order, touched on every hit, and :func:`store`
    evicts oldest-first until the directory fits.

The ``exec_cache`` fault site lets chaos drills poison an entry on disk
(kind ``cache_poison``): the injected fault is consumed here and turned into
real on-disk corruption, so the genuine digest check proves the fallback.

Telemetry: the reference's ``mxtpu_exec_cache_*`` families (hits, misses by
reason, evictions, the store's bytes, and the seconds spent loading a hit,
``deserialize_seconds``: ``dlopen`` of a library or ``cuModuleLoadData`` of
a cubin here). :func:`stats` reads them since the last
:func:`reset_stats`, and adds two counts without a family: the stores, and
the compiles that actually ran in this process (``compiles``: nvcc and
NVRTC), which a warm process keeps at zero.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..telemetry.metrics import REGISTRY, Baseline

__all__ = ["enabled", "cache_dir", "max_bytes", "build_key", "key_digest",
           "load", "store", "stats", "entries", "clear", "reset_stats"]

log = logging.getLogger("mxnet_tpu_torch.cache")

MISS_REASONS = ("absent", "corrupt", "key_mismatch", "error")

_HITS = REGISTRY.counter(
    "mxtpu_exec_cache_hits_total",
    "Executable-cache hits: compiles answered by deserializing a stored "
    "executable instead of running XLA.")
_MISSES = REGISTRY.counter(
    "mxtpu_exec_cache_misses_total",
    "Executable-cache misses, by reason: absent (never stored) / corrupt "
    "(payload digest mismatch — entry deleted) / key_mismatch (manifest "
    "disagrees with the requested key) / error (load machinery failed).",
    labelnames=("reason",))
_EVICTIONS = REGISTRY.counter(
    "mxtpu_exec_cache_evictions_total",
    "Entries evicted to keep the store under MXNET_EXEC_CACHE_MAX_BYTES "
    "(least-recently-used payload mtime first).")
_BYTES = REGISTRY.gauge(
    "mxtpu_exec_cache_bytes",
    "Total payload bytes currently in the on-disk executable cache "
    "(refreshed on every store/evict/load of this process).")
_DESER_S = REGISTRY.counter(
    "mxtpu_exec_cache_deserialize_seconds_total",
    "Wall seconds spent deserializing cached executables — the price of a "
    "hit (compare mxtpu_compile_wall_seconds_total, the price of a miss).")

_LOCK = threading.Lock()
_STATS: Dict[str, Any] = {}
_SINCE: Optional[Baseline] = None


def reset_stats():
    """Start :func:`stats` from zero (tests, drills); the families keep
    counting."""
    global _SINCE
    with _LOCK:
        _STATS.clear()
        _STATS.update(stores=0, compiles={"nvcc": 0, "nvrtc": 0})
        _SINCE = Baseline({
            "hits": _HITS, "evictions": _EVICTIONS, "load_s": _DESER_S,
            **{f"miss_{r}": _MISSES.labels(r) for r in MISS_REASONS}})


reset_stats()


def note_compile(kind: str):
    """Count one compile that actually ran (``nvcc`` or ``nvrtc``)."""
    with _LOCK:
        _STATS["compiles"][kind] += 1


def _cfg(name):
    from .. import config
    return config.get(name)


def cache_dir() -> str:
    """The store directory ('' = cache disabled), read live."""
    return str(_cfg("MXNET_EXEC_CACHE_DIR") or "")


def max_bytes() -> int:
    """LRU byte budget (0 = unbounded)."""
    return int(_cfg("MXNET_EXEC_CACHE_MAX_BYTES"))


def enabled() -> bool:
    return bool(cache_dir())


# ---------------------------------------------------------------------------
# key construction
# ---------------------------------------------------------------------------

def _runtime_versions() -> Dict[str, str]:
    return {"torch": str(torch.__version__), "cuda": str(torch.version.cuda)}


def _device_identity() -> Dict[str, Any]:
    """The kind of card a binary is built for (never its index): its name
    and compute capability; ``{"platform": "cpu"}`` without CUDA."""
    if not torch.cuda.is_available():
        return {"platform": "cpu"}
    dev = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(dev)
    return {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(dev),
            "capability": f"{major}.{minor}"}


def build_key(fingerprint: str, toolchain: Optional[Dict[str, Any]] = None,
              extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble the full cache key of one compiled binary.

    ``fingerprint`` is the sha256 of the sources and flags (the content
    address), ``toolchain`` the compiler's version (``{"nvcc": ...}`` or
    ``{"nvrtc": ...}``), ``extra`` the caller's trigger key (the library's
    name; the rtc module and its exports)."""
    key: Dict[str, Any] = {"fingerprint": str(fingerprint)}
    key.update(_device_identity())
    key["versions"] = _runtime_versions()
    if toolchain:
        key["toolchain"] = {str(k): str(v)
                            for k, v in sorted(toolchain.items())}
    if extra:
        key["extra"] = {str(k): str(v) for k, v in sorted(extra.items())}
    return key


def key_digest(key: Dict[str, Any]) -> str:
    """sha256 over the canonical JSON of the key — the entry's file name
    (the reference's digest: one key dict, one digest in both packages)."""
    canon = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def _paths(d: str, digest: str) -> Tuple[str, str]:
    return (os.path.join(d, f"ent-{digest}.bin"),
            os.path.join(d, f"ent-{digest}.json"))


# ---------------------------------------------------------------------------
# store / load
# ---------------------------------------------------------------------------

def _atomic_write(path: str, data: bytes):
    """tmp + fsync + rename in the destination directory: a reader sees the
    old entry, no entry, or the complete new one — never a torn write."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _total_bytes(d: str) -> int:
    total = 0
    try:
        for n in os.listdir(d):
            if n.startswith("ent-") and n.endswith(".bin"):
                try:
                    total += os.stat(os.path.join(d, n)).st_size
                except OSError:
                    pass
    except OSError:
        pass
    return total


def _drop_entry(d: str, digest: str):
    for p in _paths(d, digest):
        try:
            os.unlink(p)
        except OSError:
            pass


def _evict(d: str, budget: int) -> int:
    """Delete least-recently-used entries until the store fits ``budget``
    payload bytes; returns how many entries went."""
    if budget <= 0:
        return 0
    ents: List[Tuple[float, int, str]] = []   # (mtime, size, digest)
    try:
        for n in os.listdir(d):
            if not (n.startswith("ent-") and n.endswith(".bin")):
                continue
            try:
                st = os.stat(os.path.join(d, n))
            except OSError:
                continue
            ents.append((st.st_mtime, st.st_size, n[4:-4]))
    except OSError:
        return 0
    total = sum(sz for _, sz, _ in ents)
    if total <= budget:
        return 0
    evicted = 0
    for _, sz, digest in sorted(ents):
        if total <= budget:
            break
        _drop_entry(d, digest)
        total -= sz
        evicted += 1
    if evicted:
        _EVICTIONS.inc(evicted)
        _BYTES.set(total)
    return evicted


def store(key: Dict[str, Any], payload: bytes,
          meta: Optional[Dict[str, Any]] = None) -> bool:
    """Store ``payload`` (a library image or a cubin) under ``key``, with
    ``meta`` (JSON; e.g. a cubin's lowered kernel names) in its manifest.
    Best-effort: returns False (and stays silent beyond a debug log) on
    any failure — a full disk must not fail the build that just
    succeeded."""
    d = cache_dir()
    if not d:
        return False
    try:
        blob = bytes(payload)
        digest = key_digest(key)
        os.makedirs(d, exist_ok=True)
        bin_path, man_path = _paths(d, digest)
        _atomic_write(bin_path, blob)
        manifest = {"key": key, "payload_sha256":
                    hashlib.sha256(blob).hexdigest(),
                    "payload_bytes": len(blob), "created": time.time()}
        if meta:
            manifest["meta"] = meta
        _atomic_write(man_path, (json.dumps(manifest, sort_keys=True)
                                 + "\n").encode("utf-8"))
        _evict(d, max_bytes())
        _BYTES.set(_total_bytes(d))
        with _LOCK:
            _STATS["stores"] += 1
        return True
    except (OSError, TypeError, ValueError) as e:
        log.debug("executable cache store failed: %s", e)
        return False


def _miss(reason: str) -> None:
    _MISSES.labels(reason).inc()
    return None


def load(key: Dict[str, Any], loader: Optional[Callable[[bytes], Any]] = None,
         with_meta: bool = False):
    """The payload stored under ``key``, or None (a miss).

    Verifies the manifest's digest against the payload bytes before anything
    uses them; a corrupt entry is deleted and answered with a miss plus a
    warning, a manifest of another key is refused. With ``loader`` the
    verified bytes go through ``loader(payload)`` (``dlopen``,
    ``cuModuleLoadData``), timed as the hit's load seconds, and its result
    is returned; a payload the loader cannot load is deleted and missed as
    ``error``. ``with_meta`` returns ``(result, manifest meta)``. The caller
    compiles on a miss; this never raises."""
    d = cache_dir()
    if not d:
        return None
    digest = key_digest(key)
    bin_path, man_path = _paths(d, digest)
    _consume_poison_fault(bin_path)
    try:
        with open(man_path, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return _miss("absent")
    if manifest.get("key") != key:
        # a digest collision or a hand-edited manifest: refuse it
        return _miss("key_mismatch")
    try:
        with open(bin_path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return _miss("absent")
    except OSError as e:
        log.warning("executable cache entry %s unreadable (%s)", digest[:12],
                    e)
        return _miss("error")
    if hashlib.sha256(blob).hexdigest() != manifest.get("payload_sha256"):
        log.warning("executable cache entry %s corrupt (payload digest "
                    "mismatch); deleting and recompiling", digest[:12])
        _drop_entry(d, digest)
        return _miss("corrupt")
    t0 = time.perf_counter()
    out = blob
    if loader is not None:
        try:
            out = loader(blob)
        except Exception as e:      # a verified payload this process refuses
            log.warning("executable cache entry %s failed to load (%s); "
                        "deleting and recompiling", digest[:12], e)
            _drop_entry(d, digest)
            return _miss("error")
    dt = time.perf_counter() - t0
    try:
        os.utime(bin_path)          # LRU touch
    except OSError:
        pass
    _DESER_S.inc(dt)
    _HITS.inc()
    _BYTES.set(_total_bytes(d))
    return (out, manifest.get("meta", {})) if with_meta else out


def _consume_poison_fault(bin_path: str):
    """Fault hook: a ``cache_poison`` injection at the ``exec_cache`` site
    is consumed here and converted into real on-disk corruption (payload
    truncated to half), so the genuine sha256 check — not a simulated one —
    is what the drill exercises."""
    from ..resilience import faults as _faults
    try:
        _faults.check("exec_cache")
    except _faults.FaultInjected as e:
        if e.kind != "cache_poison":
            raise
        try:
            size = os.path.getsize(bin_path)
            with open(bin_path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------

def entries() -> List[Dict[str, Any]]:
    """Manifests of every entry currently in the store (oldest first)."""
    d = cache_dir()
    out: List[Dict[str, Any]] = []
    if not d or not os.path.isdir(d):
        return out
    for n in sorted(os.listdir(d)):
        if not (n.startswith("ent-") and n.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, n), "rb") as f:
                man = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            continue
        man["digest"] = n[4:-5]
        try:
            man["mtime"] = os.stat(
                os.path.join(d, f"ent-{man['digest']}.bin")).st_mtime
        except OSError:
            man["mtime"] = 0.0
        out.append(man)
    out.sort(key=lambda m: m["mtime"])
    return out


def stats() -> Dict[str, Any]:
    """Process-local cache activity plus the store's current size: hits,
    misses (and by reason), stores, evictions, load seconds, the compiles
    that ran (nvcc, NVRTC) and the store's payload bytes."""
    with _LOCK:
        since = _SINCE
        snap = {"stores": _STATS["stores"],
                "compiles": dict(_STATS["compiles"])}
    by_reason = {r: int(since[f"miss_{r}"]) for r in MISS_REASONS}
    snap.update(hits=int(since["hits"]), misses=sum(by_reason.values()),
                misses_by_reason=by_reason,
                evictions=int(since["evictions"]), load_s=since["load_s"])
    d = cache_dir()
    snap["enabled"] = bool(d)
    snap["dir"] = d
    snap["bytes"] = _total_bytes(d) if d else 0
    total = snap["hits"] + snap["misses"]
    snap["hit_rate"] = round(snap["hits"] / total, 4) if total else None
    return snap


def clear():
    """Delete every entry in the store (tests / operator reset)."""
    d = cache_dir()
    if not d or not os.path.isdir(d):
        return
    for n in os.listdir(d):
        if n.startswith("ent-") and (n.endswith(".bin")
                                     or n.endswith(".json")):
            try:
                os.unlink(os.path.join(d, n))
            except OSError:
                pass
    _BYTES.set(0)
