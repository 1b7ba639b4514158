"""Measurement tools of the port and the helpers they share with
``chip_smoke.py``. Everything here runs on the card."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..gluon.model_zoo.carrier import load_jax_params
from ..gluon.model_zoo.vision import resnet50_v1
from ..optimizer import SGD
from ..parallel import ParallelTrainStep, make_mesh

__all__ = ["card", "median_ms", "graph_ms", "seeded_bert_weights",
           "seeded_resnet_weights", "PretrainStep", "pretrain_batch",
           "resnet_train_step", "resnet_batch"]


#: resnet50_v1's (1000 classes) parameters and running stats, as the JAX
#: package counts them after its first forward (tests/test_torch_zoo.py);
#: ``Block.summary`` prints it
RESNET50_V1_PARAM_COUNT = 25_629_032


def card() -> str:
    """Card 0's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()


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


def graph_ms(fn, calls: int = 10) -> float:
    """Device ms of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    the graph's replay timed by :func:`median_ms`, so no host work (checks,
    tensor maps, launches) lands in the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return median_ms(graph.replay) / calls


def seeded_bert_weights(net, seed: int):
    """Seeded random weights for every parameter of ``net``, named as the
    JAX package names them: matrices N(0, 1/fan_in), embeddings N(0, 1),
    LayerNorm gamma 1 + N(0, 0.1^2), biases and beta N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    named = {}
    for k, p in net._collect_params_with_prefix().items():
        a = rng.standard_normal(p.shape, dtype=np.float32)
        if k.endswith(".gamma"):
            a = 1.0 + 0.1 * a
        elif len(p.shape) == 1:
            a = 0.02 * a
        elif "embed" not in k:
            a = a * np.float32(p.shape[1] ** -0.5)
        named[k] = a
    return named


def seeded_resnet_weights(net, seed: int):
    """Seeded random weights for every parameter and running stat of the
    ResNet ``net``, under the JAX package's ``collect_params()`` names
    (``"resnetv10_"`` + ``net.jax_names()``): convolution and dense weights
    N(0, 1/fan_in), BatchNorm gamma 1 + N(0, 0.1^2), biases and beta
    N(0, 0.02^2), running mean 0 and running variance 1 (the reference's
    initial stats)."""
    rng = np.random.default_rng(seed)
    params = net._collect_params_with_prefix()
    named = {}
    for key, name in net.jax_names().items():
        shape = params[key].shape
        if key.endswith("running_mean"):
            a = np.zeros(shape, np.float32)
        elif key.endswith("running_var"):
            a = np.ones(shape, np.float32)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            if key.endswith("gamma"):
                a = 1.0 + 0.1 * a
            elif len(shape) == 1:
                a = 0.02 * a
            else:
                a = a * np.float32(np.prod(shape[1:]) ** -0.5)
        named["resnetv10_" + name] = a
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


def resnet_train_step(named, compute_dtype, ctx=None):
    """``bench.py``'s ResNet-50 training step: ``resnet50_v1(classes=1000)``
    with the weights ``named`` (``collect_params()`` names), ``SGD(0.05,
    momentum 0.9)`` and ``SoftmaxCrossEntropyLoss`` through
    ``ParallelTrainStep`` on ``ctx`` (default the card), ``compute_dtype``
    over f32 masters."""
    net = resnet50_v1(classes=1000)
    load_jax_params(net, named, ctx=ctx)
    return ParallelTrainStep(net, SoftmaxCrossEntropyLoss(),
                             SGD(learning_rate=0.05, momentum=0.9),
                             make_mesh({"dp": 1}, ctx=ctx),
                             compute_dtype=compute_dtype)


def resnet_batch(rng, n: int, batch: int):
    """``n`` stacked ImageNet-shaped batches from ``rng`` (a numpy
    Generator), as ``bench.py`` draws them: images (n, batch, 3, 224, 224)
    uniform in [0, 1) and labels in [0, 1000) as float32."""
    xs = rng.random((n, batch, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, (n, batch)).astype(np.float32)
    return xs, ys
