"""NumericsGuard: anomaly detection on the device and skip/rewind recovery
(the port of ``mxnet_tpu/resilience/numerics.py``).

In hot-path order:

1. **Detection on the device, read once a window.** While a guard is
   attached, every step of the ParallelTrainStep also computes two device
   scalars beside the loss: the global gradient norm (``torch._foreach_norm``
   over the gradients, then one norm of those) and a finite flag (the
   loss's and the norm's: a NaN or an inf anywhere reaches the norm). They
   are kept as tensors, not read. The guard keeps two windows of
   ``check_every_n`` steps and at each boundary reads the older one, in one
   host copy of scalars a window old: detection lags by up to ``2 *
   check_every_n`` steps, and recovery spans both windows.
2. **An EWMA z-score detector** flags non-finite steps (``nan_grad``) and
   outliers of the loss and gradient-norm series (``loss_spike``,
   ``grad_spike``) after a warm-up.
3. **Policies.** *skip*: restore the on-device snapshot taken at the older
   window's start (parameters, optimizer state, BatchNorm statistics, the
   step's dropout generator, ``t``) and replay the retained batches but
   the offending ones; every kept update is re-derived, so the run equals
   one fed the same batches minus the skipped ones, bit for bit.
   *quarantine*: skip, then fingerprint (sha256) and dump the batch and
   exclude its position through ``DataLoader.quarantine_batch``. *rewind*:
   restore the latest checkpoint through a CheckpointManager and
   quarantine the whole window. *auto*: skip a first offender, quarantine a
   fingerprint's second offense, rewind when exclusion cannot repair the
   window.
4. **SDC screening** every ``sdc_check_every_n`` steps: the verified window
   is re-executed from its snapshot with each step's recorded generator
   state and schedule (``ParallelTrainStep.replay_exact``) and the
   parameters' sha256 compared with the live run's. The step is
   deterministic (on the card: under ``torch.use_deterministic_algorithms``,
   for the embedding backward), so a mismatch is a silent-data-corruption
   suspect: a repro bundle is written for
   ``mxnet_tpu_torch/tools/replay_step.py``.

The injected ``numerics`` kinds become real corrupted inputs in
:meth:`NumericsGuard.intercept`: ``nan_grad``/``bad_batch`` set the first
element of a floating input batch to NaN, ``loss_spike`` scales it by 64.
A model whose input is token ids (BERT) cannot carry a NaN, so for an
integer batch the step multiplies its loss by NaN (or 64) before the
backward instead: the gradients and the update are as non-finite (or as
large) as a bad batch makes them. Replays of a retained record repeat its
corruption.

Snapshots live on the device: for BERT-base with Adam, the parameters and
both moments, about 1.3 GB a snapshot, and up to two are held.

Telemetry: the reference's ``mxtpu_numerics_*`` and ``mxtpu_sdc_*``
families. A guard's ``checks``, ``anomalies``, ``recoveries_by_action``,
``quarantined``, ``sdc_checks`` and ``sdc_suspects`` are its share of
them, ``last_grad_norm`` and ``last_loss`` the gauges as of its last
boundary read; an anomaly fires the ``numerics_anomaly`` flight trigger
and an SDC suspect the ``sdc_suspect`` one. ``recoveries`` and
``skipped_steps`` are the guard's lifetime totals, part of its checkpointed
state (a restarted job carries them on), as in the reference; this
process's recoveries and skipped steps are also counted in their families.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from .. import config as _config
from .. import telemetry as _telemetry
from ..telemetry import flight as _flight
from ..telemetry.metrics import Baseline
from . import faults as _faults
from .checkpoint import host_array

__all__ = ["NumericsGuard", "NumericsError", "BadBatchError",
           "SDCSuspectError", "EWMADetector", "batch_fingerprint"]

_CHECKS = _telemetry.counter(
    "mxtpu_numerics_checks_total",
    "NumericsGuard boundary checks by result: clean / anomaly.",
    labelnames=("result",))
_ANOMALIES = _telemetry.counter(
    "mxtpu_numerics_anomalies_total",
    "Numerical anomalies detected, by kind: nan_grad (non-finite loss or "
    "gradient), loss_spike / grad_spike (EWMA z-score outlier), bad_batch "
    "(an anomaly attributed to a poisoned input batch).",
    labelnames=("kind",))
_RECOVERIES = _telemetry.counter(
    "mxtpu_numerics_recoveries_total",
    "Recovery actions executed by the policy engine: skip / quarantine / "
    "rewind.", labelnames=("action",))
_SKIPPED = _telemetry.counter(
    "mxtpu_numerics_skipped_steps_total",
    "Optimizer updates discarded by skip/quarantine recovery (the clean "
    "run equivalent never trained on these batches).")
_QUARANTINED = _telemetry.counter(
    "mxtpu_numerics_quarantined_batches_total",
    "Batches fingerprinted, dumped and positionally excluded from replays.")
_GRAD_NORM = _telemetry.gauge(
    "mxtpu_numerics_grad_norm",
    "Global gradient norm at the last boundary read (lagged by up to "
    "MXNET_NUMERICS_CHECK_EVERY_N steps; free — no extra sync).")
_LOSS_LAST = _telemetry.gauge(
    "mxtpu_numerics_loss",
    "Loss at the last boundary read (lagged, free).")
_SDC_CHECKS = _telemetry.counter(
    "mxtpu_sdc_checks_total",
    "SDC screening re-executions by result: match / mismatch.",
    labelnames=("result",))
_SDC_SUSPECT = _telemetry.counter(
    "mxtpu_sdc_suspect_total",
    "Window re-executions whose parameter digest diverged from the live "
    "run — a silent-data-corruption suspect; each one writes a repro "
    "bundle for tools/replay_step.py.")


class NumericsError(MXNetError):
    """An anomaly the guard could not recover from. Fatal for
    :func:`~.retry.classify_error`: a NaN step re-run gives the NaN
    again."""


class BadBatchError(NumericsError):
    """A poisoned batch that could not be quarantined. Fatal."""


class SDCSuspectError(NumericsError):
    """Strict SDC screening (``sdc_raise=True``) found a re-execution that
    diverged from the live run. Fatal."""


class EWMADetector:
    """Exponentially weighted mean/variance z-score spike detector of one
    series. Only accepted readings update the statistics, so a spike
    cannot widen the band and mask the next. ``rel_floor`` floors the
    standard deviation at that fraction of the mean."""

    def __init__(self, alpha: float, zscore: float, warmup: int,
                 rel_floor: float = 0.1):
        self.alpha = float(alpha)
        self.zscore = float(zscore)
        self.warmup = int(warmup)
        self.rel_floor = float(rel_floor)
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def is_spike(self, value: float) -> bool:
        """True when ``value`` is non-finite or sits more than ``zscore``
        standard deviations above the mean (one-sided; never in
        warm-up)."""
        if not math.isfinite(value):
            return True
        if self.count < self.warmup:
            return False
        sd = max(math.sqrt(max(self.var, 0.0)),
                 self.rel_floor * abs(self.mean), 1e-12)
        return (value - self.mean) > self.zscore * sd

    def update(self, value: float):
        """Fold an accepted reading into the statistics."""
        if not math.isfinite(value):
            return
        if self.count == 0:
            self.mean = value
        else:
            d = value - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.count += 1

    def state_dict(self) -> Dict:
        return {"mean": float(self.mean), "var": float(self.var),
                "count": int(self.count)}

    def load_state_dict(self, st: Dict):
        self.mean = float(st["mean"])
        self.var = float(st["var"])
        self.count = int(st["count"])


def _leaves(tree) -> List:
    """The tensors of a label tuple or an optimizer state, in
    ``jax.tree_util.tree_leaves`` order (None has none)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def batch_fingerprint(x, y, extras=()) -> str:
    """sha256 over the host bytes of a batch (data, labels, extras, with
    shapes and dtypes): the identity quarantine records match."""
    h = hashlib.sha256()
    for leaf in [x] + _leaves(y) + list(extras):
        arr = host_array(leaf)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _digest_arrays(arrays) -> str:
    """sha256 over a sequence of tensors (the digest SDC screening and
    ``tools/replay_step.py`` compare: keep the two in step)."""
    h = hashlib.sha256()
    for a in arrays:
        arr = host_array(a)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class _StepRecord:
    """What re-derives one step bit for bit: the placed batch, the step
    generator's state before it, its lr/wd rows, ``t``, the corruption it
    carried, and its unread device health scalars."""

    __slots__ = ("x", "y", "extras", "key", "lrs", "wds", "t", "poison",
                 "loss", "grad_norm", "finite", "batch_pos", "injected",
                 "loss_v", "gnorm_v", "finite_v")

    def __init__(self, *, x, y, extras, key, lrs, wds, t, poison, loss,
                 grad_norm, finite, batch_pos=None, injected=None):
        self.x = x
        self.y = y
        self.extras = extras
        self.key = key
        self.lrs = lrs
        self.wds = wds
        self.t = int(t)
        self.poison = poison
        self.loss = loss
        self.grad_norm = grad_norm
        self.finite = finite
        self.batch_pos = batch_pos
        self.injected = injected
        self.loss_v = None
        self.gnorm_v = None
        self.finite_v = None


class NumericsGuard:
    """Numerical-health guard of a ParallelTrainStep. Arguments left None
    take the ``MXNET_NUMERICS_*``/``MXNET_SDC_*`` flags: ``check_every_n``,
    ``policy`` (skip | quarantine | rewind | auto), ``spike_zscore``,
    ``warmup_steps``, ``ewma_alpha``, ``max_recoveries`` (exclusion
    attempts a window), ``quarantine_dir``, ``sdc_check_every_n`` (0 =
    off), ``sdc_bundle_dir``; ``sdc_raise`` raises on a mismatch;
    ``dataloader`` gives each batch's position and takes exclusions;
    ``checkpoint_manager`` is the rewind target; ``loss_scaler`` (an
    ``amp.LossScaler``) adopts each step's finite flag; ``repro_meta`` is
    JSON embedded in SDC bundles."""

    def __init__(self, check_every_n: Optional[int] = None,
                 policy: Optional[str] = None,
                 spike_zscore: Optional[float] = None,
                 warmup_steps: Optional[int] = None,
                 ewma_alpha: Optional[float] = None,
                 max_recoveries: Optional[int] = None,
                 quarantine_dir: Optional[str] = None,
                 sdc_check_every_n: Optional[int] = None,
                 sdc_bundle_dir: Optional[str] = None,
                 sdc_raise: bool = False,
                 dataloader=None, checkpoint_manager=None,
                 loss_scaler=None, repro_meta: Optional[Dict] = None):
        g = _config.get
        self.check_every_n = int(check_every_n if check_every_n is not None
                                 else g("MXNET_NUMERICS_CHECK_EVERY_N"))
        if self.check_every_n < 1:
            raise MXNetError("check_every_n must be >= 1")
        self.policy = str(policy if policy is not None
                          else g("MXNET_NUMERICS_POLICY"))
        if self.policy not in ("skip", "quarantine", "rewind", "auto"):
            raise MXNetError(f"unknown numerics policy {self.policy!r}; "
                             "known: skip | quarantine | rewind | auto")
        self.max_recoveries = int(max_recoveries if max_recoveries is not None
                                  else g("MXNET_NUMERICS_MAX_RECOVERIES"))
        self.quarantine_dir = str(
            quarantine_dir if quarantine_dir is not None
            else g("MXNET_NUMERICS_QUARANTINE_DIR"))
        self.sdc_check_every_n = int(
            sdc_check_every_n if sdc_check_every_n is not None
            else g("MXNET_SDC_CHECK_EVERY_N"))
        self.sdc_bundle_dir = str(sdc_bundle_dir if sdc_bundle_dir is not None
                                  else g("MXNET_SDC_BUNDLE_DIR"))
        self.sdc_raise = bool(sdc_raise)
        zscore = float(spike_zscore if spike_zscore is not None
                       else g("MXNET_NUMERICS_SPIKE_ZSCORE"))
        alpha = float(ewma_alpha if ewma_alpha is not None
                      else g("MXNET_NUMERICS_EWMA_ALPHA"))
        warmup = int(warmup_steps if warmup_steps is not None
                     else g("MXNET_NUMERICS_WARMUP_STEPS"))
        self.loss_detector = EWMADetector(alpha, zscore, warmup,
                                          rel_floor=0.1)
        # gradient norms are heavy-tailed: the band is a full mean wide
        self.gnorm_detector = EWMADetector(alpha, zscore, warmup,
                                           rel_floor=1.0)
        self.dataloader = dataloader
        self.checkpoint_manager = checkpoint_manager
        self.loss_scaler = loss_scaler
        self.repro_meta = dict(repro_meta or {})
        self._ts = None
        # `_window` is the current (unread) window anchored at `_snapshot`;
        # `_prev` the older one anchored at `_snap_prev`, read at the next
        # boundary
        self._window: List[_StepRecord] = []
        self._prev: List[_StepRecord] = []
        self._snapshot = None
        self._snap_prev = None
        self._replaying = False
        self._steps_since_sdc = 0
        self._offenders: Dict[str, int] = {}
        self.last_anomaly: Optional[Dict] = None
        self.last_sdc: Optional[Dict] = None
        self.sdc_bundles: List[str] = []
        self.recoveries = 0
        self.skipped_steps = 0
        self.host_reads = 0          # host copies of health scalars
        # this guard's share of the numerics families
        self._own = Baseline({
            **{f"check_{r}": _CHECKS.labels(r) for r in ("clean", "anomaly")},
            **{f"sdc_{r}": _SDC_CHECKS.labels(r)
               for r in ("match", "mismatch")},
            "quarantined": _QUARANTINED, "sdc_suspects": _SDC_SUSPECT})
        self._anomalies = Baseline()
        self._recoveries = Baseline()
        self._read_health = False     # a boundary read set the gauges

    # -- wiring ------------------------------------------------------------
    def attach(self, train_step) -> "NumericsGuard":
        """Bind to a ParallelTrainStep: its steps compute the health
        scalars and report here."""
        if self._ts is not None and self._ts is not train_step:
            raise MXNetError("NumericsGuard is already attached to a "
                             "different ParallelTrainStep")
        train_step._attach_numerics_guard(self)
        self._ts = train_step
        self.reset()
        return self

    def reset(self):
        """Drop the retained windows and snapshot the step's current state
        (on attach and after an external restore)."""
        self._window = []
        self._prev = []
        self._snap_prev = None
        self._snapshot = self._take_snapshot()
        self._steps_since_sdc = 0

    def snapshot_bytes(self) -> int:
        """Device bytes the retained snapshots hold."""
        return sum(self._ts._snapshot_bytes(s)
                   for s in (self._snapshot, self._snap_prev) if s)

    def _take_snapshot(self) -> Dict:
        snap = self._ts._snapshot()
        snap["loader_pos"] = self._loader_pos()
        snap["wall_time"] = time.time()
        return snap

    def _loader_pos(self) -> Optional[Tuple[int, int]]:
        dl = self.dataloader
        if dl is None:
            return None
        return (int(dl.epoch), int(dl._pos))

    # -- the hot path --------------------------------------------------------
    def intercept(self, x, y):
        """The step's input shim: consumes an injected ``numerics`` fault
        and applies its corruption. Returns ``(x, y, injected, poison)``:
        ``poison`` is the factor the step multiplies its loss by when the
        batch cannot carry the corruption (integer inputs), else None.
        Replays are exempt: their records already carry it."""
        if self._replaying:
            return x, y, None, None
        try:
            _faults.check("numerics")
        except _faults.FaultInjected as e:
            if e.kind in ("nan_grad", "bad_batch", "loss_spike"):
                nan = e.kind != "loss_spike"
                if not x.is_floating_point():
                    return x, y, e.kind, (float("nan") if nan else 64.0)
                if nan:
                    x = x.clone()
                    x.view(-1)[0] = float("nan")
                else:
                    x = x * 64.0
                return x, y, e.kind, None
            raise
        return x, y, None, None

    def observe(self, *, x, y, extras, key, lrs, wds, t, loss, health,
                poison=None, injected=None):
        """A step's report (device values only; nothing here reads the
        device); every ``check_every_n`` steps the boundary check runs."""
        grad_norm, finite = health
        if self.loss_scaler is not None and not self._replaying:
            self.loss_scaler.observe_finite_flag(finite)
        rec = _StepRecord(x=x, y=y, extras=extras, key=key, lrs=lrs, wds=wds,
                          t=t, poison=poison, loss=loss, grad_norm=grad_norm,
                          finite=finite, batch_pos=self._current_batch_pos(),
                          injected=injected)
        self._window.append(rec)
        if self._replaying:
            return
        if len(self._window) >= self.check_every_n:
            self.check()

    def _current_batch_pos(self) -> Optional[Tuple[int, int]]:
        dl = self.dataloader
        if dl is None or self._replaying or dl._pos <= 0:
            return None
        # the loader's _pos counts the batches consumed: the step just
        # trained on the one at 0-based index _pos - 1 of this epoch
        return (int(dl.epoch), int(dl._pos) - 1)

    # -- the boundary --------------------------------------------------------
    def _read(self, records: Sequence[_StepRecord]):
        """One host copy of the unread records' health scalars: the only
        place the guard reads the device."""
        unread = [r for r in records if r.finite_v is None]
        if not unread:
            return
        vals = torch.stack([torch.stack([r.loss.float(),
                                         r.grad_norm.float(),
                                         r.finite.float()])
                            for r in unread]).cpu().tolist()
        self.host_reads += 1
        for rec, (loss_v, gnorm_v, finite_v) in zip(unread, vals):
            rec.loss_v = float(loss_v)
            rec.gnorm_v = float(gnorm_v)
            rec.finite_v = bool(finite_v)

    def _scan(self, records: Sequence[_StepRecord]
              ) -> Optional[Tuple[int, str]]:
        """(index, kind) of the first anomalous record, or None;
        non-finiteness first (every later record is contaminated)."""
        for i, rec in enumerate(records):
            if not rec.finite_v:
                return i, "nan_grad"
            if self.loss_detector.is_spike(rec.loss_v):
                return i, "loss_spike"
            if self.gnorm_detector.is_spike(rec.gnorm_v):
                return i, "grad_spike"
        return None

    def _accept(self, records: Sequence[_StepRecord]):
        for rec in records:
            self.loss_detector.update(rec.loss_v)
            self.gnorm_detector.update(rec.gnorm_v)

    def check(self, force: bool = False):
        """The boundary: verify the older window, then rotate the current
        one into its place under a fresh snapshot. ``force`` also verifies
        the window just rotated (before an exit or a flush)."""
        if self._replaying:
            return
        if not force and len(self._window) < self.check_every_n:
            return
        if self._verify_aged():
            return
        if self._window:
            self._snap_prev = self._snapshot
            self._prev = self._window
            self._window = []
            self._snapshot = self._take_snapshot()
        if force:
            self._verify_aged()

    def _verify_aged(self) -> bool:
        """Read and verify ``_prev``; True when a recovery ran."""
        if not self._prev:
            return False
        self._read(self._prev)
        bad = self._scan(self._prev)
        if bad is not None:
            _CHECKS.labels("anomaly").inc()
            self._recover(self._snap_prev,
                          list(self._prev) + list(self._window), *bad)
            return True
        _CHECKS.labels("clean").inc()
        self._accept(self._prev)
        tail = self._prev[-1]
        _GRAD_NORM.set(tail.gnorm_v)
        _LOSS_LAST.set(tail.loss_v)
        self._read_health = True
        self._maybe_sdc_check(self._prev, self._snap_prev)
        self._steps_since_sdc += len(self._prev)
        self._prev = []
        self._snap_prev = None
        return False

    def finalize(self):
        """Resolve both retained windows, so the step's state can be
        trusted (before a checkpoint or an exit)."""
        self.check(force=True)

    def _reanchor(self):
        self._window = []
        self._prev = []
        self._snap_prev = None
        self._snapshot = self._take_snapshot()

    # -- recovery ------------------------------------------------------------
    def _decide(self, kind: str, rec: _StepRecord) -> str:
        if self.policy != "auto":
            return self.policy
        if rec.injected == "bad_batch":
            return "quarantine"
        if self._offenders.get(self._fingerprint(rec), 0) >= 1:
            return "quarantine"
        return "skip"

    def _fingerprint(self, rec: _StepRecord) -> str:
        return batch_fingerprint(rec.x, rec.y, rec.extras)

    def _recover(self, snapshot: Dict, records: List[_StepRecord],
                 bad_idx: int, kind: str):
        rec = records[bad_idx]
        action = self._decide(kind, rec)
        label = "bad_batch" if action == "quarantine" else kind
        self._anomalies.add(label, _ANOMALIES.labels(label)).inc()
        self.last_anomaly = {
            "kind": label, "action": action, "t": rec.t,
            "loss": rec.loss_v, "grad_norm": rec.gnorm_v,
            "finite": rec.finite_v, "batch_pos": rec.batch_pos,
            "window_index": bad_idx, "injected": rec.injected,
        }
        _flight.trigger("numerics_anomaly", kind=label, action=action,
                        step=rec.t, batch_pos=rec.batch_pos,
                        loss=rec.loss_v, grad_norm=rec.gnorm_v)
        if action == "rewind":
            self._rewind(records)
            return
        self._skip_and_replay(snapshot, records, {bad_idx},
                              quarantine=(action == "quarantine"))

    def _count(self, action: str):
        self.recoveries += 1
        self._recoveries.add(action, _RECOVERIES.labels(action)).inc()

    def _skip(self, n: int):
        self.skipped_steps += n
        _SKIPPED.inc(n)

    @property
    def checks(self) -> Dict[str, int]:
        return {r: int(self._own[f"check_{r}"]) for r in ("clean", "anomaly")}

    @property
    def anomalies(self) -> Dict[str, int]:
        return self._anomalies.as_dict()

    @property
    def recoveries_by_action(self) -> Dict[str, int]:
        return self._recoveries.as_dict()

    @property
    def quarantined(self) -> int:
        return int(self._own["quarantined"])

    @property
    def sdc_checks(self) -> Dict[str, int]:
        return {r: int(self._own[f"sdc_{r}"]) for r in ("match", "mismatch")}

    @property
    def sdc_suspects(self) -> int:
        return int(self._own["sdc_suspects"])

    @property
    def last_grad_norm(self) -> Optional[float]:
        return _GRAD_NORM.value if self._read_health else None

    @property
    def last_loss(self) -> Optional[float]:
        return _LOSS_LAST.value if self._read_health else None

    def _skip_and_replay(self, snapshot: Dict, records: List[_StepRecord],
                         excluded: set, quarantine: bool):
        """Restore the snapshot and replay the records but ``excluded``;
        a replay that shows a new first anomaly grows the exclusion set and
        tries again, up to ``max_recoveries`` attempts."""
        attempts = 0
        while True:
            attempts += 1
            if attempts > self.max_recoveries or \
                    len(excluded) >= len(records) + 1:
                self._window = []
                self._prev = []
                self._snap_prev = None
                if self.policy == "auto" and \
                        self.checkpoint_manager is not None:
                    self._rewind(records)
                    return
                raise NumericsError(
                    f"numerics recovery failed: window of {len(records)} "
                    f"steps still anomalous after excluding "
                    f"{sorted(excluded)} ({attempts - 1} attempts); "
                    "restore from the latest checkpoint")
            keep = [i for i in range(len(records)) if i not in excluded]
            self._ts._restore_snapshot(snapshot)
            self._window = []
            self._replaying = True
            try:
                for i in keep:
                    r = records[i]
                    self._ts._step_impl(r.x, r.y, r.extras, poison=r.poison)
            finally:
                self._replaying = False
            replayed = self._window
            self._read(replayed)
            again = self._scan(replayed)
            if again is None:
                break
            excluded.add(keep[again[0]])
        self._accept(replayed)
        for i in sorted(excluded):
            bad = records[i]
            self._skip(1)
            if quarantine:
                self._quarantine(bad)
            else:
                fp = self._fingerprint(bad)
                self._offenders[fp] = self._offenders.get(fp, 0) + 1
        self._count("quarantine" if quarantine else "skip")
        self._steps_since_sdc += len(replayed)
        self._reanchor()

    def _quarantine(self, rec: _StepRecord):
        fp = self._fingerprint(rec)
        self._offenders[fp] = self._offenders.get(fp, 0) + 1
        _QUARANTINED.inc()
        if rec.batch_pos is not None and self.dataloader is not None:
            self.dataloader.quarantine_batch(*rec.batch_pos)
        if not self.quarantine_dir:
            return
        os.makedirs(self.quarantine_dir, exist_ok=True)
        stamp = f"t{rec.t:08d}-{fp[:12]}"
        payload = {"x": host_array(rec.x)}
        for j, leaf in enumerate(_leaves(rec.y)):
            payload[f"y{j}"] = host_array(leaf)
        for j, e in enumerate(rec.extras):
            payload[f"e{j}"] = host_array(e)
        onp.savez(os.path.join(self.quarantine_dir,
                               f"quarantine-{stamp}.npz"), **payload)
        meta = {"fingerprint": fp, "t": rec.t,
                "batch_pos": list(rec.batch_pos)
                if rec.batch_pos is not None else None,
                "loss": rec.loss_v, "grad_norm": rec.gnorm_v,
                "finite": rec.finite_v, "injected": rec.injected,
                "poison": rec.poison, "wall_time": time.time()}
        meta_path = os.path.join(self.quarantine_dir,
                                 f"quarantine-{stamp}.json")
        tmp = f"{meta_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
        os.replace(tmp, meta_path)

    def _rewind(self, window: Sequence[_StepRecord]):
        """Restore the latest checkpoint and quarantine every retained
        batch position, so the resumed loader skips them."""
        cm = self.checkpoint_manager
        if cm is None:
            raise NumericsError(
                "numerics policy 'rewind' needs a checkpoint_manager; "
                "none is attached")
        self._window = []
        self._prev = []
        self._snap_prev = None
        kw = {"train_step": self._ts}
        if self.dataloader is not None:
            kw["dataloader"] = self.dataloader
        restored = cm.restore_latest(**kw)
        if restored is None:
            raise NumericsError(
                "numerics rewind found no intact checkpoint to restore")
        if self.dataloader is not None:
            for rec in window:
                if rec.batch_pos is not None:
                    self.dataloader.quarantine_batch(*rec.batch_pos)
                    _QUARANTINED.inc()
        self._skip(len(window))
        self._count("rewind")
        self._snapshot = self._take_snapshot()
        self._steps_since_sdc = 0

    # -- SDC screening -------------------------------------------------------
    def _maybe_sdc_check(self, records: List[_StepRecord], start_snap: Dict):
        if self.sdc_check_every_n <= 0:
            return
        if self._steps_since_sdc + len(records) < self.sdc_check_every_n:
            return
        self._sdc_verify(records, start_snap)
        self._steps_since_sdc = -len(records)   # the caller adds it back

    def _sdc_verify(self, records: List[_StepRecord], start_snap: Dict):
        """Re-execute a verified window from its snapshot with its recorded
        generator states and schedules, and compare the parameters' digest
        with the state the live run reached at the window's end (the
        snapshot taken when it rotated)."""
        ts = self._ts
        live = ts._snapshot()
        digest_live = _digest_arrays(self._snapshot["params"])
        pre_digest = _digest_arrays(start_snap["params"])
        ts._restore_snapshot(start_snap)
        self._replaying = True
        try:
            for rec in records:
                ts.replay_exact(rec.x, rec.y, rec.extras, rec.key, rec.lrs,
                                rec.wds, rec.t, poison=rec.poison)
        finally:
            self._replaying = False
        replayed = [t.detach().clone() for t in ts._ordered_tensors()]
        injected = None
        try:
            _faults.check("sdc")
        except _faults.FaultInjected as e:
            if e.kind != "sdc":
                raise
            # the flaky chip: perturb one element of the re-execution
            injected = e.kind
            replayed[0].view(-1)[0] += 1e-3
        digest_replay = _digest_arrays(replayed)
        ts._restore_snapshot(live)      # screening is invisible to training
        match = digest_replay == digest_live
        _SDC_CHECKS.labels("match" if match else "mismatch").inc()
        self.last_sdc = {"match": match, "digest_live": digest_live,
                         "digest_replay": digest_replay,
                         "pre_digest": pre_digest,
                         "window": len(records), "injected": injected,
                         "t": int(self._snapshot["t"])}
        if match:
            return
        _SDC_SUSPECT.inc()
        bundle = None
        if self.sdc_bundle_dir:
            bundle = self._write_sdc_bundle(records, start_snap, digest_live,
                                            digest_replay, pre_digest)
            self.sdc_bundles.append(bundle)
            self.last_sdc["bundle"] = bundle
        _flight.trigger("sdc_suspect", t=int(self._snapshot["t"]),
                        digest_live=digest_live[:16],
                        digest_replay=digest_replay[:16],
                        window=len(records), sdc_bundle=bundle)
        if self.sdc_raise:
            raise SDCSuspectError(
                f"SDC suspect at t={self._snapshot['t']}: re-executed "
                f"window digest {digest_replay[:12]} != live "
                f"{digest_live[:12]}"
                + (f"; repro bundle: {bundle}" if bundle else ""))

    def _write_sdc_bundle(self, records: List[_StepRecord], snap: Dict,
                          digest_live: str, digest_replay: str,
                          pre_digest: str) -> str:
        """The repro bundle, the reference's layout: ``state.npz`` (the
        pre-window ``p{i}`` and ``s{j}_l{k}``, plus the port's
        ``generator``), ``records.npz`` (each record's batch, generator
        state as ``r{i}_key``, lr and wd rows, and ``r{i}_poison``) and
        ``meta.json`` with both digests."""
        root = self.sdc_bundle_dir
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, f"sdc-t{snap['t']:08d}-{digest_live[:8]}")
        os.makedirs(path, exist_ok=True)
        arrays = {f"p{i}": host_array(a) for i, a in enumerate(snap["params"])}
        for j, st in enumerate(snap["opt"]):
            for k, leaf in enumerate(st):
                arrays[f"s{j}_l{k}"] = host_array(leaf)
        arrays["generator"] = host_array(snap["generator"])
        onp.savez(os.path.join(path, "state.npz"), **arrays)
        recs, rec_meta = {}, []
        for i, rec in enumerate(records):
            recs[f"r{i}_x"] = host_array(rec.x)
            y_leaves = _leaves(rec.y)
            for j, leaf in enumerate(y_leaves):
                recs[f"r{i}_y{j}"] = host_array(leaf)
            for j, e in enumerate(rec.extras):
                recs[f"r{i}_e{j}"] = host_array(e)
            recs[f"r{i}_key"] = host_array(rec.key)
            recs[f"r{i}_lrs"] = onp.asarray(rec.lrs, onp.float32)
            recs[f"r{i}_wds"] = onp.asarray(rec.wds, onp.float32)
            rec_meta.append({"t": rec.t, "n_y": len(y_leaves),
                             "y_tuple": isinstance(rec.y, (tuple, list)),
                             "n_extras": len(rec.extras),
                             "key_impl": "torch", "key_typed": 0,
                             "poison": rec.poison})
        onp.savez(os.path.join(path, "records.npz"), **recs)
        meta = {"kind": "sdc_bundle", "version": 1,
                "t": int(snap["t"]), "n_records": len(records),
                "records": rec_meta,
                "digest_live": digest_live, "digest_replay": digest_replay,
                "pre_digest": pre_digest,
                "opt_arities": [len(st) for st in snap["opt"]],
                "repro": self.repro_meta, "wall_time": time.time()}
        meta_path = os.path.join(path, "meta.json")
        tmp = f"{meta_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True, indent=1)
        os.replace(tmp, meta_path)
        return path

    # -- checkpoint surface --------------------------------------------------
    def state_dict(self) -> Dict:
        """The detector bands and the offense ledger (the retained windows
        are not checkpointed: a restore re-anchors)."""
        return {"kind": "NumericsGuard", "version": 1,
                "loss_mean": self.loss_detector.mean,
                "loss_var": self.loss_detector.var,
                "loss_count": self.loss_detector.count,
                "gnorm_mean": self.gnorm_detector.mean,
                "gnorm_var": self.gnorm_detector.var,
                "gnorm_count": self.gnorm_detector.count,
                "offenders": json.dumps(self._offenders, sort_keys=True),
                "skipped_steps": int(self.skipped_steps),
                "recoveries": int(self.recoveries)}

    def load_state_dict(self, st: Dict):
        if st.get("kind") != "NumericsGuard":
            raise MXNetError(f"not a NumericsGuard state: {st.get('kind')!r}")
        self.loss_detector.load_state_dict(
            {"mean": st["loss_mean"], "var": st["loss_var"],
             "count": st["loss_count"]})
        self.gnorm_detector.load_state_dict(
            {"mean": st["gnorm_mean"], "var": st["gnorm_var"],
             "count": st["gnorm_count"]})
        self._offenders = {str(k): int(v) for k, v in
                           json.loads(st["offenders"]).items()}
        self.skipped_steps = int(st["skipped_steps"])
        self.recoveries = int(st["recoveries"])
        if self._ts is not None:
            self.reset()
