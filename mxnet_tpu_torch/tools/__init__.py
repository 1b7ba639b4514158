"""Measurement tools of the port and the helpers they share with
``chip_smoke.py``. Everything here runs on the card."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["card", "median_ms", "seeded_bert_weights", "PretrainStep",
           "pretrain_batch"]


def card() -> str:
    """Card 0's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, reps: int = 30, warmup: int = 5, calls: int = 1) -> float:
    """Median device time of one ``fn()`` in ms: CUDA events around
    ``calls`` back-to-back calls, ``reps`` times after ``warmup`` untimed
    ones, each elapsed time divided by ``calls``. Around a single call of a
    short kernel the events also catch the host's launch overhead; with
    several calls it overlaps the device work, as in a real stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
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


class PretrainStep(torch.nn.Module):
    """``bench.py``'s wrapper around ``BERTForPretraining``: ``(tokens,
    token_types, positions)`` -> ``(mlm_logits, nsp_logits)``, the block
    signature ``ParallelTrainStep`` calls with two extra inputs."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, tokens, token_types, positions):
        return self.inner(tokens, token_types, None, positions)


def pretrain_batch(rng, n: int, batch: int, seq: int, n_pred: int,
                   vocab: int = 30522):
    """``n`` stacked pretraining batches from ``rng`` (a numpy Generator),
    ``bench.py``'s recipe: ``(tokens, (mlm_labels, nsp_labels),
    token_types, positions)`` with ``n_pred`` sorted masked positions per
    row, all int32."""
    shape = (n, batch, seq)
    toks = rng.integers(0, vocab, shape, dtype=np.int32)
    tt = rng.integers(0, 2, shape, dtype=np.int32)
    pos = np.sort(rng.random(shape).argsort(-1)[..., :n_pred],
                  -1).astype(np.int32)
    mlm = rng.integers(0, vocab, (n, batch, n_pred), dtype=np.int32)
    nsp = rng.integers(0, 2, (n, batch), dtype=np.int32)
    return toks, (mlm, nsp), tt, pos
