"""CheckpointManager: atomic, rotating, optionally asynchronous training
checkpoints (the port of ``mxnet_tpu/resilience/checkpoint.py``).

The on-disk format is the reference's, so each package verifies and
restores the other's checkpoints:

- ``ckpt-%08d/`` holds ``state.npz`` (the dense arrays, no pickle),
  ``meta.json`` (``format``, ``step``, ``scalars``, ``wall_time`` and, for a
  sharded save, ``layout`` and ``shard_files``), one ``shard-NNNNN.npz`` a
  writer of a sharded save, and ``MANIFEST.json`` (every file's sha256 and
  size), written last;
- every checkpoint is written into a temp directory, each file fsynced, the
  manifest last, then renamed into place and the parent fsynced: a crash at
  any point leaves the previous checkpoints and a temp directory that
  restore never reads;
- :meth:`CheckpointManager.restore_latest` verifies the manifest before
  trusting a checkpoint and falls back to the next newest when it fails
  (torn write, bit rot); ``None`` when none is intact. Rotation keeps the
  newest ``keep``.

``async_save=True`` copies the state to host memory on the caller's thread
(the copy the card must make anyway) and writes it in a background thread;
``wait(timeout)`` joins and re-raises its error, as does the next save.

**Sharded saves across ranks** (``save(step, train_step=ts,
sharded=True)`` on every rank of a job): each rank writes its own
``shard-NNNNN.npz`` (NNNNN its rank) into one shared temp directory and
hashes it; one all-gather over the job brings rank 0 every shard's sha256
(or a rank's failure), and rank 0 writes ``state.npz``, ``meta.json`` and
the manifest and renames. Every file's sha256 is taken from the bytes in
memory as they are written, not read back.
A rank that fails before that point makes every rank raise and leaves only
the temp directory. Such a save runs on the caller's thread whatever
``async_save`` says (a collective from a writer thread would race the
training loop's). Restore assembles the global arrays on every rank, which
then takes its own shard: a job saved on two ranks resumes on one.

Telemetry: a save runs inside a ``checkpoint.save`` span and counts in
``mxtpu_checkpoint_saves_total`` (by outcome), ``_bytes_written_total``,
``_save_duration_us`` and ``_last_step``; ``restore_latest`` runs inside a
``checkpoint.restore`` span and counts in ``_restores_total`` (restored,
corrupt_skipped, none). A manager's ``saves``, ``restores`` and
``bytes_written`` are its share of those families.
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..telemetry.metrics import Baseline
from . import faults as _faults
from .sharding import ShardedLeaf, assemble as _assemble

__all__ = ["CheckpointManager", "capture_state", "apply_state",
           "verify_checkpoint_dir"]

_SAVES = _telemetry.counter(
    "mxtpu_checkpoint_saves_total", "Checkpoint save attempts by outcome.",
    labelnames=("outcome",))
_RESTORES = _telemetry.counter(
    "mxtpu_checkpoint_restores_total",
    "Checkpoint restore attempts by outcome "
    "(restored/corrupt_skipped/none).", labelnames=("outcome",))
_BYTES = _telemetry.counter(
    "mxtpu_checkpoint_bytes_written_total",
    "Bytes durably written by checkpoint saves.")
_SAVE_DUR = _telemetry.histogram(
    "mxtpu_checkpoint_save_duration_us",
    "Wall time of one checkpoint save (serialize + fsync + rename), us.")
_LAST_STEP = _telemetry.gauge(
    "mxtpu_checkpoint_last_step", "Step of the newest durable checkpoint.")

log = logging.getLogger("mxnet_tpu_torch.resilience.checkpoint")

_DATA, _META, _MANIFEST = "state.npz", "meta.json", "MANIFEST.json"
_PREEMPT_MARKER = "PREEMPTED.json"
_PREFIX, _TMP_PREFIX = "ckpt-", ".tmp-"
_FORMAT = 1


def _shard_name(writer: int) -> str:
    return f"shard-{int(writer):05d}.npz"


def host_array(t) -> onp.ndarray:
    """A host numpy copy of a tensor or array that later in-place updates
    of ``t`` do not reach (bf16 widened to f32, which is exact)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        h = t.cpu()
        if h.data_ptr() == t.data_ptr():
            h = h.clone()
        return h.numpy()
    return onp.array(t, copy=True)


# ---------------------------------------------------------------------------
# state trees: nested str-keyed dicts with array or scalar leaves
# ---------------------------------------------------------------------------
def _flatten(tree: Dict, prefix: str = "", arrays=None, scalars=None,
             sharded=None):
    if arrays is None:
        arrays, scalars, sharded = {}, {}, {}
    for k, v in tree.items():
        if not isinstance(k, str) or "/" in k:
            raise MXNetError(f"state keys must be '/'-free strings, got {k!r}")
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, key + "/", arrays, scalars, sharded)
        elif isinstance(v, ShardedLeaf):
            sharded[key] = v
        elif isinstance(v, onp.ndarray):
            arrays[key] = v
        elif isinstance(v, onp.generic):
            scalars[key] = v.item()
        elif isinstance(v, (int, float, str, bool)) or v is None:
            scalars[key] = v
        else:
            raise MXNetError(
                f"unsupported checkpoint leaf at {key!r}: {type(v).__name__} "
                "(use numpy arrays, JSON scalars, or nested dicts)")
    return arrays, scalars, sharded


def _unflatten(arrays: Dict, scalars: Dict) -> Dict:
    tree: Dict = {}
    for src in (scalars, arrays):
        for key, v in src.items():
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _npz_bytes(arrays: Dict[str, onp.ndarray]) -> bytes:
    buf = io.BytesIO()
    onp.savez(buf, **arrays)
    return buf.getvalue()


def _job():
    """(rank, ranks) of this process's job."""
    from ..parallel import collectives
    return collectives.rank(), collectives.num_workers()


def _gather_digests(mine: Optional[Dict]) -> Optional[Dict]:
    """Every rank's ``{file: {sha256, bytes}}`` merged (one all-gather of
    a fixed-size JSON buffer), or None when a rank passed None (it failed
    to write its shard)."""
    from ..parallel import collectives
    blob = json.dumps(mine).encode()
    n = torch.tensor([len(blob)], dtype=torch.int64,
                     device=collectives.device())
    width = int(collectives.world_all_reduce(n, "max").item())
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[:len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    every = collectives.world_all_gather(buf.to(collectives.device()))
    merged: Dict = {}
    for row in every.reshape(-1, width).cpu().numpy():
        part = json.loads(bytes(row).rstrip(b"\0").decode())
        if part is None:
            return None
        merged.update(part)
    return merged


def _all_ok(ok: bool) -> bool:
    """True when ``ok`` holds on every rank of the job (one all-reduce)."""
    from ..parallel import collectives
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32,
                        device=collectives.device())
    return int(collectives.world_all_reduce(flag, "min").item()) == 1


class CheckpointManager:
    """Atomic rotating checkpoints under ``directory`` (``ckpt-<step>/``).
    ``keep`` newest retained (``MXNET_CKPT_KEEP``; 0 keeps all),
    ``async_save`` writes in a background thread (``MXNET_CKPT_ASYNC``),
    ``fsync`` is the durability barrier (``MXNET_CKPT_FSYNC``). One
    trainer a directory; in a job every rank makes a manager over the same
    directory."""

    def __init__(self, directory: str, keep: Optional[int] = None,
                 async_save: Optional[bool] = None,
                 fsync: Optional[bool] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep if keep is not None
                        else _config.get("MXNET_CKPT_KEEP"))
        self.async_save = bool(async_save if async_save is not None
                               else _config.get("MXNET_CKPT_ASYNC"))
        self.fsync = bool(fsync if fsync is not None
                          else _config.get("MXNET_CKPT_FSYNC"))
        self._pending: list = []
        self._lock = threading.Lock()
        self._writing: set = set()      # steps with a write in flight
        self.last_save_bytes = 0
        self.last_save_seconds = 0.0
        # this manager's share of the checkpoint families
        self._own = Baseline({
            **{f"save_{o}": _SAVES.labels(o) for o in ("ok", "failed")},
            **{f"restore_{o}": _RESTORES.labels(o)
               for o in ("restored", "corrupt_skipped", "none")},
            "bytes": _BYTES})

    @property
    def saves(self) -> Dict[str, int]:
        return {o: int(self._own[f"save_{o}"]) for o in ("ok", "failed")}

    @property
    def restores(self) -> Dict[str, int]:
        return {o: int(self._own[f"restore_{o}"])
                for o in ("restored", "corrupt_skipped", "none")}

    @property
    def bytes_written(self) -> int:
        return int(self._own["bytes"])

    # -- paths -----------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{int(step):08d}")

    def steps(self):
        """Steps that have a renamed-into-place checkpoint, ascending."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_PREFIX):
                try:
                    out.append(int(name[len(_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Optional[Dict] = None, **objs) -> str:
        """Write checkpoint ``step``: an explicit ``state`` tree, or the
        objects :func:`capture_state` takes (``train_step=``, ``trainer=``,
        ``block=``, ``dataloader=``, ``loss_scaler=``, ``numerics=``,
        ``extra=``, ``include_rng=``, ``sharded=``). Returns the path the
        checkpoint lands at (for an async save, once ``wait()`` returns).
        An async save first waits for the previous one, so saves land in
        call order."""
        if state is None:
            state = capture_state(**objs)
        elif objs:
            raise MXNetError("pass either an explicit state or capture "
                             "kwargs, not both")
        final = self._path(step)
        collective = _job()[1] > 1 and _flatten(state)[2]
        if self.async_save and not collective:
            self.wait()
            rec: list = [None, None]
            t = threading.Thread(target=self._save_guarded,
                                 args=(step, state, rec),
                                 name="mxt-ckpt-writer", daemon=True)
            rec[0] = t
            with self._lock:
                self._writing.add(int(step))
                self._pending.append(rec)
            t.start()
            return final
        with self._lock:
            self._writing.add(int(step))
        self._save_sync(step, state)
        return final

    def _save_guarded(self, step: int, state: Dict, rec: list):
        try:
            self._save_sync(step, state)
        except BaseException as e:   # surfaced on the next wait()/save()
            rec[1] = e

    def wait(self, timeout: Optional[float] = None):
        """Join outstanding async saves and re-raise the first failure;
        ``timeout`` seconds (``MXNET_CKPT_WAIT_TIMEOUT_S``; <= 0 waits
        without bound) before a wedged writer raises MXNetError (its record
        is kept for a later wait)."""
        if timeout is None:
            timeout = float(_config.get("MXNET_CKPT_WAIT_TIMEOUT_S"))
        deadline = (time.monotonic() + timeout) if timeout > 0 else None
        with self._lock:
            pending, self._pending = self._pending, []
        stuck, err = [], None
        for rec in pending:
            t = rec[0]
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
            if t.is_alive():
                stuck.append(rec)
            else:
                err = err or rec[1]
        if stuck:
            with self._lock:
                self._pending.extend(stuck)
            raise MXNetError(
                f"checkpoint writer still running after {timeout:.1f}s "
                "(MXNET_CKPT_WAIT_TIMEOUT_S); the write may yet complete — "
                "wait() again to re-check, but do not trust this step until "
                "it does")
        if err is not None:
            raise err

    def _write_file(self, path: str, data: bytes, digests=None) -> int:
        """Write and fsync one file (its sha256 and size into
        ``digests``, from the bytes in memory). The ``checkpoint_write``
        fault site sits between the write and the fsync: when it fires,
        the file is cut to half (a torn write) and the fault re-raised."""
        if digests is not None:
            digests[os.path.basename(path)] = {
                "sha256": hashlib.sha256(data).hexdigest(),
                "bytes": len(data)}
        with open(path, "wb") as f:
            f.write(data)
            try:
                _faults.check("checkpoint_write")
            except BaseException:
                f.flush()
                f.truncate(max(1, len(data) // 2))
                raise
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        return len(data)

    def _fsync_dir(self, path: str):
        if not self.fsync:
            return
        try:
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _save_sync(self, step: int, state: Dict):
        t0 = time.perf_counter_ns()
        try:
            with _telemetry.span("checkpoint.save", step=int(step)):
                nbytes = self._write_checkpoint(step, state)
        except BaseException:
            with self._lock:
                self._writing.discard(int(step))
            _SAVES.labels("failed").inc()
            raise
        dur_ns = time.perf_counter_ns() - t0
        self.last_save_bytes = nbytes
        self.last_save_seconds = dur_ns / 1e9
        _SAVES.labels("ok").inc()
        _BYTES.inc(nbytes)
        _LAST_STEP.set(int(step))
        _SAVE_DUR.observe(dur_ns // 1000)
        with self._lock:
            self._writing.discard(int(step))
        if _job()[0] == 0:
            self._rotate(exclude=int(step))
            self._sweep_tmp()

    def _write_checkpoint(self, step: int, state: Dict) -> int:
        """Write one checkpoint; the bytes this process wrote."""
        rank, ranks = _job()
        arrays, scalars, sharded = _flatten(state)
        collective = ranks > 1 and bool(sharded)
        final = self._path(step)
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{_PREFIX}{int(step):08d}")
        if not collective:
            tmp += f"-{os.getpid()}"
        meta = {"format": _FORMAT, "step": int(step), "scalars": scalars,
                "wall_time": time.time()}
        per_writer: Dict[int, Dict[str, onp.ndarray]] = {}
        if sharded:
            layout = {}
            for key, leaf in sorted(sharded.items()):
                entry = {"shape": list(leaf.shape),
                         "dtype": str(leaf.dtype), "shards": []}
                for writer, index, data in leaf.shards:
                    entry["shards"].append({"file": int(writer),
                                            "index": index})
                    if data is not None:
                        per_writer.setdefault(int(writer), {})[key] = data
                    elif not collective:
                        raise MXNetError(f"shard of {key!r} for writer "
                                         f"{writer} has no data in a "
                                         "one-process save")
                layout[key] = entry
            meta["layout"] = layout
            meta["shard_files"] = sorted({int(r["file"]) for e in
                                          layout.values()
                                          for r in e["shards"]})
        nbytes = 0
        if rank == 0 or not collective:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        ok, err = True, None
        if collective:
            ok = _all_ok(True)            # the temp directory exists
        digests: Dict[str, Dict] = {}
        try:
            for writer, leaves in sorted(per_writer.items()):
                if collective and writer != rank:
                    continue
                nbytes += self._write_file(
                    os.path.join(tmp, _shard_name(writer)),
                    _npz_bytes(leaves), digests)
        except BaseException as e:
            ok, err = False, e
        if collective:
            every = _gather_digests(digests if ok else None)
            if every is None:
                if err is not None:
                    raise err
                raise MXNetError(f"checkpoint {step}: another rank failed "
                                 "to write its shard; the temp directory "
                                 "stays")
            digests = every
        if err is not None:
            raise err
        if rank == 0 or not collective:
            try:
                nbytes += self._write_file(os.path.join(tmp, _DATA),
                                           _npz_bytes(arrays), digests)
                nbytes += self._write_file(
                    os.path.join(tmp, _META),
                    json.dumps(meta, sort_keys=True).encode(), digests)
                manifest = {"format": _FORMAT, "step": int(step),
                            "files": dict(sorted(digests.items()))}
                nbytes += self._write_file(
                    os.path.join(tmp, _MANIFEST),
                    json.dumps(manifest, sort_keys=True).encode())
                self._fsync_dir(tmp)
                if os.path.exists(final):     # a re-save of the same step
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._fsync_dir(self.directory)
            except BaseException as e:
                ok, err = False, e
        if collective and not _all_ok(ok):
            if err is not None:
                raise err
            raise MXNetError(f"checkpoint {step}: rank 0 failed to land it")
        if err is not None:
            raise err
        return nbytes

    def _rotate(self, exclude: int):
        """Keep the newest ``keep``; never delete the checkpoint just
        written, one with a write in flight, or the newest on disk."""
        if self.keep <= 0:
            return
        with self._lock:
            writing = set(self._writing)
        steps = self.steps()
        newest = steps[-1] if steps else None
        for s in steps[:-self.keep]:
            if s == exclude or s == newest or s in writing:
                continue
            shutil.rmtree(self._path(s), ignore_errors=True)

    def _sweep_tmp(self):
        """Remove temp directories of crashed earlier writers."""
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def restore(self, step: int, **objs):
        """Verify and load checkpoint ``step`` into the objects
        (:func:`apply_state`'s arguments); raises on corruption."""
        state = verify_checkpoint_dir(self._path(step))
        apply_state(state, **objs)
        return state

    def restore_latest(self, **objs) -> Optional[Tuple[int, Dict]]:
        """Restore the newest intact checkpoint: ``(step, state)`` after
        applying it, or None when none is intact. A checkpoint that fails
        verification is logged and skipped, never raised."""
        with _telemetry.span("checkpoint.restore"):
            for step in reversed(self.steps()):
                path = self._path(step)
                try:
                    state = verify_checkpoint_dir(path)
                except Exception as e:
                    _RESTORES.labels("corrupt_skipped").inc()
                    log.warning("checkpoint %s failed verification (%s); "
                                "falling back to the previous checkpoint",
                                path, e)
                    continue
                apply_state(state, **objs)
                _RESTORES.labels("restored").inc()
                return step, state
            _RESTORES.labels("none").inc()
            return None

    # -- the preemption marker (PreemptionGuard) ---------------------------
    def write_preemption_marker(self, info: Dict):
        """Atomically write ``PREEMPTED.json`` beside the checkpoints."""
        final = os.path.join(self.directory, _PREEMPT_MARKER)
        tmp = final + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(info, sort_keys=True))
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, final)
        self._fsync_dir(self.directory)

    def preemption_marker(self) -> Optional[Dict]:
        """The marker's contents, or None."""
        path = os.path.join(self.directory, _PREEMPT_MARKER)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def clear_preemption_marker(self):
        try:
            os.remove(os.path.join(self.directory, _PREEMPT_MARKER))
        except OSError:
            pass


def verify_checkpoint_dir(path: str) -> Dict:
    """Load and checksum-verify one checkpoint directory; raises on any
    defect. Sharded leaves are assembled into whole host arrays, so the
    tree returned does not depend on the layout that saved it."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise MXNetError(f"unknown checkpoint format "
                         f"{manifest.get('format')!r}")
    for name, rec in manifest["files"].items():
        p = os.path.join(path, name)
        if not os.path.exists(p):
            raise MXNetError(f"missing checkpoint file {name}")
        if os.path.getsize(p) != rec["bytes"]:
            raise MXNetError(f"checkpoint file {name} truncated "
                             f"({os.path.getsize(p)} != {rec['bytes']} "
                             "bytes)")
        if _sha256(p) != rec["sha256"]:
            raise MXNetError(f"checkpoint file {name} checksum mismatch")
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    with onp.load(os.path.join(path, _DATA), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    layout = meta.get("layout")
    if layout:
        shard_files = {}
        try:
            for writer in meta.get("shard_files", ()):
                shard_files[int(writer)] = onp.load(
                    os.path.join(path, _shard_name(int(writer))),
                    allow_pickle=False)
            for key, entry in layout.items():
                arrays[key] = _assemble(entry, shard_files, key)
        finally:
            for zf in shard_files.values():
                zf.close()
    state = _unflatten(arrays, meta.get("scalars", {}))
    state.setdefault("meta", {})["step"] = int(manifest["step"])
    return state


def capture_state(*, train_step=None, trainer=None, block=None,
                  dataloader=None, loss_scaler=None, numerics=None,
                  include_rng: bool = True, sharded: bool = False,
                  extra: Optional[Dict] = None) -> Dict:
    """Snapshot training state into a checkpointable tree of host copies
    (safe to write from a background thread while training goes on):
    ``train_step`` (a ParallelTrainStep or DLRMTrainStep: parameters,
    optimizer state, ``t``; ``sharded=True`` takes each rank's shards),
    ``trainer`` (a gluon.Trainer), ``block`` (parameters by position),
    ``dataloader`` (its position), ``loss_scaler``, ``numerics`` (a
    NumericsGuard's band and ledger), the ``random`` module's state
    (``include_rng``) and ``extra`` (say, a DeviceFeed's state_dict)."""
    state: Dict = {"meta": {"format": _FORMAT}}
    if train_step is not None:
        state["train_step"] = (train_step.shard_state_dict() if sharded
                               else train_step.state_dict())
    if trainer is not None:
        state["trainer"] = _host_tree(trainer.state_dict())
    if block is not None:
        # positional keys: names carry per-process counters, so identity
        # is collect_params() order and shape; names ride along
        plist = list(block.collect_params().items())
        state["model"] = {
            "n_params": len(plist),
            "param_names": ",".join(n for n, _ in plist),
            "params": {f"p{i}": host_array(p.data()._data)
                       for i, (_, p) in enumerate(plist)},
        }
    if dataloader is not None:
        state["dataloader"] = _host_tree(dataloader.state_dict())
    if loss_scaler is not None:
        state["loss_scaler"] = loss_scaler.state_dict()
    if numerics is not None:
        state["numerics"] = numerics.state_dict()
    if include_rng:
        from .. import random as _random
        state["rng"] = _random.get_state()
    if extra:
        state["extra"] = _host_tree(dict(extra))
    return state


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, onp.ndarray)):
        return host_array(tree)
    return tree


def apply_state(state: Dict, *, train_step=None, trainer=None, block=None,
                dataloader=None, loss_scaler=None, numerics=None,
                restore_rng: bool = True, **_ignored):
    """Push a restored tree back into live objects (the inverse of
    :func:`capture_state`). A component asked for and missing raises."""
    def _want(key, obj):
        if obj is None:
            return None
        if key not in state:
            raise MXNetError(f"checkpoint has no {key!r} component; it holds "
                             f"{sorted(state)}")
        return state[key]

    ts = _want("train_step", train_step)
    if ts is not None:
        train_step.load_state_dict(ts)
    tr = _want("trainer", trainer)
    if tr is not None:
        trainer.load_state_dict(tr)
    mod = _want("model", block)
    if mod is not None:
        plist = list(block.collect_params().items())
        if int(mod["n_params"]) != len(plist):
            raise MXNetError(
                f"checkpoint holds {mod['n_params']} parameters, model has "
                f"{len(plist)} ({mod.get('param_names')})")
        for i, (name, p) in enumerate(plist):
            arr = onp.asarray(mod["params"][f"p{i}"])
            if tuple(arr.shape) != tuple(p.shape):
                raise MXNetError(
                    f"checkpoint param {i} ({name}) shape mismatch: "
                    f"{arr.shape} vs {tuple(p.shape)}")
            p.set_data(arr)
    dl = _want("dataloader", dataloader)
    if dl is not None:
        dataloader.load_state_dict(dl)
    ls = _want("loss_scaler", loss_scaler)
    if ls is not None:
        loss_scaler.load_state_dict(ls)
    nm = _want("numerics", numerics)
    if nm is not None:
        numerics.load_state_dict(nm)
    if restore_rng and "rng" in state:
        from .. import random as _random
        _random.set_state(state["rng"])
    guard = getattr(train_step, "_guard", None) if train_step is not None \
        else None
    if guard is not None:
        # re-anchor after the restores above: retained records must never
        # replay over restored state
        guard.reset()
    return state
