"""mxnet_tpu_torch.resilience: fault tolerance of the port's training (the
counterpart of ``mxnet_tpu/resilience``).

- :class:`CheckpointManager` (``checkpoint.py``): atomic (temp directory,
  fsync, manifest of sha256 sums written last, rename), rotating,
  optionally asynchronous checkpoints of parameters, optimizer state, the
  random state, ``t`` and the DataLoader's position; ``restore_latest()``
  skips corrupt checkpoints. The on-disk format is the JAX package's, so
  each package restores the other's checkpoints; sharded saves write one
  shard file a rank.
- :class:`RetryPolicy` (``retry.py``): backoff with seeded jitter and the
  transient/fatal split (a CUDA OOM is transient, a sticky CUDA error
  fatal); ``ParallelTrainStep`` and ``DLRMTrainStep`` retry through it.
- :class:`Watchdog` and :class:`CircuitBreaker` (``watchdog.py``).
- ``faults`` (``faults.py``): deterministic, seedable fault injection at
  the reference's sites.
- ``sharding`` and :class:`PreemptionGuard`: the sharded layout and the
  SIGTERM-to-checkpoint harness.
- :class:`NumericsGuard` (``numerics.py``): on-device NaN and spike
  detection read once a window, bitwise skip-and-replay, quarantine,
  rewind and SDC screening with repro bundles
  (``mxnet_tpu_torch/tools/replay_step.py``).

The acceptance bar is the reference's: under an injected device OOM every
3rd step plus a crash and a restore, a 20-step training run ends bitwise
equal to the uninterrupted run (``tests/test_torch_resilience.py`` on the
CPU; ``chip_smoke.py`` phase 18 with BERT-base on the card).

The serving half (dispatch retries, the breaker and the watchdog inside
``InferenceServer``, weight hot swap, worker failover) lives in
``serving/``. Each module reports into the port's telemetry registry
(retries, faults, checkpoints, preemptions, stalls, circuit states and the
numerics guard's families), with the ``oom``, ``watchdog_stall``,
``circuit_open``, ``preemption``, ``numerics_anomaly`` and ``sdc_suspect``
flight triggers. Not ported: ``tools/chaos_check.py`` (next in ROADMAP
Queue 1).
"""
from __future__ import annotations

from . import faults
from . import sharding
from .checkpoint import (CheckpointManager, capture_state, apply_state,
                         verify_checkpoint_dir)
from .numerics import (NumericsGuard, NumericsError, BadBatchError,
                       SDCSuspectError, EWMADetector, batch_fingerprint)
from .preemption import PreemptionGuard
from .retry import RetryPolicy, classify_error
from .watchdog import (CircuitBreaker, Watchdog,
                       HEALTHY, DEGRADED, OPEN, HALF_OPEN)

__all__ = [
    "faults", "sharding", "CheckpointManager", "capture_state", "apply_state",
    "verify_checkpoint_dir", "PreemptionGuard",
    "NumericsGuard", "NumericsError", "BadBatchError", "SDCSuspectError",
    "EWMADetector", "batch_fingerprint",
    "RetryPolicy", "classify_error", "CircuitBreaker", "Watchdog",
    "HEALTHY", "DEGRADED", "OPEN", "HALF_OPEN",
]
