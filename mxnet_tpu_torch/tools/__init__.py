"""Measurement tools of the port and the helpers they share with
``chip_smoke.py``. Everything here runs on the card."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["card", "median_ms", "seeded_bert_weights"]


def card() -> str:
    """Card 0's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn()`` in ms: CUDA events around each of
    ``reps`` calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def seeded_bert_weights(net, seed: int):
    """Seeded random weights for every parameter of ``net``, named as the
    JAX package names them: matrices N(0, 1/fan_in), embeddings N(0, 1),
    LayerNorm gamma 1 + N(0, 0.1^2), biases and beta N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    named = {}
    for k, p in net.state_dict().items():
        a = rng.standard_normal(p.shape, dtype=np.float32)
        if k.endswith(".gamma"):
            a = 1.0 + 0.1 * a
        elif p.dim() == 1:
            a = 0.02 * a
        elif "embed" not in k:
            a = a * np.float32(p.shape[1] ** -0.5)
        named[k] = a
    return named
