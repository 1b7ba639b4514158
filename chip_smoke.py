#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, nvcc and the repository checkout; it imports neither
JAX nor the JAX package. Phases (any failure exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi), the CUDA and
   PyTorch versions, nvcc's version; builds the flash-attention forward (K1)
   and backward (K2, K3) libraries and the fused 1x1-conv library (K4) from
   ``mxnet_tpu_torch/csrc``, one nvcc each, started together, and prints
   the build times and ptxas reports.
2. K1 against its plain version: ``flash_attention_fwd`` (O and LSE)
   against ``flash_attention_fwd_reference`` on the card at every listed
   shape (the serving and training shapes among them), f32 within 1e-4
   (sum order only) and bf16 within 2e-2 (P is rounded to bf16; one bf16
   ulp near 1 is 7.8e-3), each on q, k, v taken as the split (B, H, S, D)
   views of one seeded (B, S, 3 H D) QKV buffer and on contiguous copies
   of them: both within tolerance, and bitwise equal to each other. At the
   serving and the training shape it times the kernel on both layouts,
   the plain version and ``torch.nn.functional.
   scaled_dot_product_attention``'s forward (a yardstick only; the port
   never calls it) with CUDA events around 10 back-to-back calls, median
   of 30 such windows after warm-up, and the device time of the kernel and
   of SDPA replayed from a CUDA graph of 10 calls (no host work in the
   window); it prints the bound (bytes over 3.35 TB/s against operations
   over the peak for the type). Then the host microseconds of one K1 call,
   of its C entry alone (four tensor maps encoded, the launch) and of one
   SDPA call, timed in turns.
2b. K2 and K3, each against its own plain version, at every listed shape
   (the training and serving shapes, ragged tails, causal, D = 32/64/128)
   in bf16 and f32: ``flash_attention_bwd_dq`` (dq and delta, given K1's
   out and lse) against ``flash_attention_bwd_dq_reference``, and
   ``flash_attention_bwd_dkv`` (dk and dv, given K2's delta) against
   ``flash_attention_bwd_dkv_reference``, each output within tol *
   max(1, max|plain|): f32 1e-4 (sum order only), bf16 2e-2 (outputs
   rounded to bf16, and P and dS are rounded to bf16 on both sides, where
   an f32 sum order can flip an ulp). Inputs as the training path hands
   them over: q, k, v the split views of one QKV buffer, out K1's (B, S,
   H, D) memory, dout the transposed view of a (B, S, H, D) gradient; the
   same on contiguous copies must be bitwise equal. Then one head dim the
   kernels do not take (D = 16): ``multi_head_attention`` forward and QKV
   gradients on the card in f32 against the same on the CPU within 1e-4,
   launching no kernel, and in bf16 without raising. At the training and
   the serving shape it times K2, K3 and the whole backward
   (``flash_attention_bwd``) through the wrappers (10-call windows) and
   replayed from CUDA graphs, each kernel's plain version, and
   ``scaled_dot_product_attention``'s backward (a yardstick only: through
   autograd, and from a graph as the forward plus backward less the
   forward), with the bounds.
2c. K4 against its plain version: ``conv1x1_bn_act`` against
   ``conv1x1_bn_act_reference`` at ResNet-50's nine batch-128 1x1 shapes
   (bf16 x) and at a ragged M, K = 8, no ReLU and an f32 x: y within
   2e-2 x max(1, max|plain|) (bf16 output, sum order), each moment within
   1e-3 x max(1, max|plain|) of itself (f32 sums over up to 401,408 rows in
   another order); each of the nine twice, bitwise equal (the moments are
   reduced in a fixed order). At each of the nine it prints the schedule
   (tile width, blocks) and times the kernel, the plain
   version, ``torch.matmul`` of the pre-activated bf16 x with w (the
   product alone) and the library composition of the same function
   (``tools/k4_compare.py``: the prologue, ``torch.mm`` with an f32
   result, the rounding and the column sums; held to the plain version
   too), yardsticks the port never calls, each through its calls (10-call
   windows) and replayed from a CUDA graph of 10 calls, and the bound
   (bytes over 3.35 TB/s against 2 M K N operations over 989 TFLOP/s) with
   the graph time's share of it.
3. The serving slice: ``bert_base()`` at full width with seeded random
   weights, cast to bf16, served by ``ModelEndpoint`` + ``InferenceServer``
   to 8 client threads sending 96 requests of 1-8 rows of 512 tokens.
   Checks: every response is on the card and equals the direct forward of
   the same rows (``|a - b| <= 2e-2 + 2e-2 |b|``, bf16 with other batch
   sizes in the matrix products); K1's launch count is exactly 12 per
   executed batch (the construction probe and warm-up included); and one
   row run in f32 on the card matches the plain f32 forward on the CPU
   within 1e-3. Prints requests/s, tokens/s and p50/p99 latency beside the
   card.
4. The training slice: ``BERTForPretraining(bert_base(max_length=128))`` at
   full width, seeded weights through the weight carrier, ``Adam(1e-4)``,
   bf16 compute over f32 masters, dropout 0.1, batch 64 x 128 with P = 19
   masked positions, through ``ParallelTrainStep``: 2 warm-up steps, 3
   ``step_n`` calls of K = 10, then 10 steps on one fixed batch. Checks:
   every loss is finite; the fixed batch's loss falls; K1, K2 and K3 each
   launched exactly 12 times per step. Then one f32 step at batch 2 x 128
   on the card against the same step on the CPU (plain versions): loss
   within 1e-4 relative; parameters after the update within 2 lr (the most
   one Adam step can move a weight either way) and no more than 1e-3 of
   them beyond 0.1 lr (a near-zero gradient whose sign the sum order flips
   moves its weight by up to lr). Prints tokens/s (batch * seq * K * calls
   / wall, as bench.py), the step's median ms and the peak device memory
   beside the card.
5. The ResNet-50 slice: ``resnet50_v1(classes=1000)`` at full width and
   depth, seeded weights through the weight carrier (``collect_params()``
   names), ``SGD(0.05, momentum 0.9)`` and ``SoftmaxCrossEntropyLoss``,
   bf16 compute over f32 masters, batch 32 x 3 x 224 x 224 with labels in
   [0, 1000), as ``bench.py``: 2 warm-up steps, 3 ``step_n`` calls of
   K = 10, then 10 steps on one fixed batch. Checks: every loss is finite;
   the fixed batch's loss falls; the running stats moved from (0, 1) and are
   finite float32. Prints img/s (32 * K * calls / wall, closed by fetching
   the last loss), the step's median ms and the peak device memory beside
   the card. Then K4 on the model's own data: one bf16 training-mode
   forward with hooks at the 16 bottlenecks takes the 3x3 conv's output as
   an (N*H*W, C) matrix, the scale and shift its BatchNorm computes, and
   the last 1x1 conv's weight as (K, N); K4 is launched once per
   bottleneck (the count must be 16) and y + the conv's bias must equal the
   conv's output within 2e-2 x max(1, max|out|), and sum/M (+ bias) and
   sumsq/M - (sum/M)^2 the next BatchNorm's batch mean and variance within
   2^-7 of each column's rms and 2^-6 of its mean square (the conv's output
   is rounded to bf16, and the bias added in bf16, before that BatchNorm
   reads it: two roundings of at most 2^-9 each, doubled). Then one f32
   step at batch 2 on the card against the same step on the CPU: loss within
   1e-4 relative; running stats within 1e-4 x max(1, |stat|) (f32 batch
   moments, sum order only); and each parameter's update (w before - w
   after = lr * gradient on a first SGD step) held against the same step
   computed in f64 on the CPU (``tools/f32_drift.py`` runs all three):
   the card's f32 update of each leaf may be at most 3 times as far from
   it in norm as the CPU's f32 update of that leaf is, and its largest
   element error at most 3 times the CPU's largest in the same stage,
   each plus one f32 ulp of the leaf's weights. At random initialization
   f32 rounding alone puts this net's gradient percents away from f64,
   on the CPU as on the card: the forward's relative error grows block by
   block through the 16 bottlenecks, and the backward amplifies it, so
   each leaf's own f32 error, measured on the CPU, is the scale the card
   is held to. Element maxima come from the handful of ReLU mask flips
   each device makes at its own positions, so they are compared per
   stage.
6. The rtc slice and the imperative path (K5), on ``gpu(0)``: the three
   sources of ``csrc/rtc/`` compiled at run time by ``rtc.CudaModule``
   (NVRTC, sm_90a; compile seconds printed). Each of these must raise
   MXNetError at its call with the reference's message: a broken source
   ("failed to compile", with the log), a missing name ("not found"), a
   name outside ``exports`` ("not exported"), an argument of the wrong
   dtype, a CPU array, and a launch the card refuses (1025 threads a
   block, at ``launch``); an exported template (``twice<float>``) resolves
   through its lowered name. The main path, with ``rtc.launches`` set to 0
   just before and read just after: the reference's ``axpy``, ``scale`` and
   ``k`` at 8 elements, ``axpy`` over as many f32 values as ``resnet50_v1``
   has trainable parameters, three steps of ``GeluTanh`` (an
   ``autograd.Function`` over the GELU kernel pair) under
   ``autograd.record()`` at BERT-base's FFN width, (64 * 128, 3072) bf16
   from ``nd.random.normal``, with ``loss = (y * w).sum()`` and
   ``loss.backward()`` (2 launches a step), and ``log_softmax`` at the MLM
   logits' (64 * 19, 30522) bf16, one 128-thread block a row.
   Checks: axpy, scale and k bitwise equal to their plain versions (2x is
   exact, so an FMA cannot change the sum), y and x.grad within one bf16
   ulp of each value of the plain versions and of
   ``F.gelu(approximate="tanh")`` under torch autograd, log_softmax within
   one bf16 ulp of its plain version, the launch counts. Then each kernel
   is timed beside its bound, its plain version and one PyTorch call
   computing the same function (``torch.add(y, x, alpha=2)``, ``F.gelu``
   and its backward, ``torch.log_softmax``), the kernel and that call also
   replayed from CUDA graphs of 10 (device time), the host cost of one
   ``CudaKernel.launch`` at 8 elements beside one ``torch.add``, and
   NDArray/autograd cases run on the card against the same calls on
   ``cpu()``. ``rtc.launches`` at the end equals every launch the phase
   made.
7. The generate slice: ``TransformerLM`` at BERT-base width (12 layers, 768
   units, 12 heads, FFN 3072, vocab 30522, 512 positions; the causal
   encoder with a tied LM head), seeded weights through the weight carrier
   (the JAX test's Normal(0.5) recipe), bf16, in a ``DecodeEndpoint``
   (max_seq_len 512, max batch 8, pages of 16, 257 pages) registered with
   warm-up on an ``InferenceServer``: 4 client threads submit 24 sequences
   through ``server.generate`` (prompt lengths from the seed in [8, 448],
   four from each prefill bucket; 32 new tokens each; tenants "default"
   and one at 50 ms/token). Checks: every stream yields exactly 32 tokens;
   K1 launched 12 times per prefill (the 6 warm-up prefills included) and
   0 times per decode step; the same prompts decoded serially through the
   same engine give bitwise the same token lists, and 8 rows' first-step
   logits stepped together (bucket 8) equal each row's stepped alone
   (bucket 1) bitwise; greedy tokens depend on the context; K1 against its
   plain version at (1, 12, S, 64) causal for every prefill bucket S in
   bf16 and f32 at phase 2's tolerances; one sequence in f32 on the card
   against the CPU (prefill logits within 1e-3 x max(1, |logit|), first 8
   greedy tokens equal), with the repo's BERT weight recipe (under the wide
   init f32 rounding alone moves the logits by more than that: the CPU's
   f32 prefill against its f64 one is printed).
   Prints tokens/s, time to first token and inter-token gaps per tenant
   (p50, p99; client-side clocks), peak device memory, each prefill and
   decode bucket's ms (host clock and CUDA events), the decode step's
   device busy share (torch.profiler), and K1's causal times at
   (1, 12, 512, 64) and (1, 12, 128, 64) on split views, from CUDA graphs,
   beside the bound and SDPA's causal forward.
8. A JSON line with the kernels' numbers, then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mxnet_tpu_torch import MXNetError, autograd, cpu, gpu, nd, rtc, serving
from mxnet_tpu_torch.gluon.model_zoo.bert import (
    BERTForPretraining, BERTPretrainingLoss, TransformerLM, bert_base,
    load_jax_params)
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, resnet50_v1
from mxnet_tpu_torch.ops import _build, _nvrtc
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.ops.cuda import fused_conv1x1 as fc
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import ParallelTrainStep, make_mesh
from mxnet_tpu_torch.serving.generate import DecodeEndpoint
from mxnet_tpu_torch.tools import (PretrainStep, card, f32_drift, graph_ms,
                                   median_ms, pretrain_batch, resnet_batch,
                                   resnet_train_step, seeded_bert_weights,
                                   seeded_resnet_weights)
from mxnet_tpu_torch.tools import rtc_examples as rx
from mxnet_tpu_torch.tools.k4_compare import composition as k4_composition

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,       # dense tensor cores
              torch.float32: 67e12}         # fp32 without the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TIMED_CALLS = 10          # calls between two CUDA events (see median_ms)
BERT_SHAPE = (32, 12, 512, 64)
TRAIN_SHAPE = (64, 12, 128, 64)             # BERT-base pretraining, B x H
CHECK_SHAPES = [  # (B, H, S, D), causal
    (BERT_SHAPE, False), ((2, 2, 256, 64), False), ((2, 2, 256, 64), True),
    ((1, 1, 192, 64), False), ((1, 2, 640, 64), True),
    ((2, 4, 128, 32), False), ((1, 2, 256, 128), False),
    ((1, 2, 256, 128), True), (TRAIN_SHAPE, False)]
TIMED_SHAPES = {BERT_SHAPE: "serving", TRAIN_SHAPE: "training"}
K1_HOST_ROUNDS, K1_HOST_CALLS = 25, 20
SEQ_LEN = 512
N_CLIENTS = 8
REQS_PER_CLIENT = 12
BWD_SHAPES = [  # (B, H, S, D), causal
    (TRAIN_SHAPE, False), (BERT_SHAPE, False), ((2, 2, 300, 64), False),
    ((1, 2, 640, 64), True), ((2, 4, 128, 32), False),
    ((1, 2, 256, 128), False), ((1, 2, 256, 128), True)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_P = 64, 128, 19   # bench.py's BERT cell
TRAIN_K, TRAIN_CALLS, TRAIN_WARMUP, TRAIN_FIXED = 10, 3, 2, 10
TRAIN_LR = 1e-4
# ResNet-50 v1's distinct 1x1 convolutions at batch 128, as the reference's
# K4 benchmark lists them: (label, M = 128 * H * W, K = Cin, N = Cout)
K4_SHAPES = [("s2_reduce", 128 * 56 * 56, 64, 64),
             ("s2_expand", 128 * 56 * 56, 64, 256),
             ("s2_in", 128 * 56 * 56, 256, 64),
             ("s3_in", 128 * 28 * 28, 512, 128),
             ("s3_expand", 128 * 28 * 28, 128, 512),
             ("s4_in", 128 * 14 * 14, 1024, 256),
             ("s4_expand", 128 * 14 * 14, 256, 1024),
             ("s5_in", 128 * 7 * 7, 2048, 512),
             ("s5_expand", 128 * 7 * 7, 512, 2048)]
K4_EDGES = [  # (M, K, N, relu, x dtype): ragged M, K = 8, no ReLU, f32 x
    (1000, 64, 64, True, torch.bfloat16),
    (32 * 7 * 7, 512, 2048, True, torch.bfloat16),
    (1000, 8, 64, True, torch.bfloat16),
    (4000, 64, 256, False, torch.bfloat16),
    (32 * 7 * 7, 2048, 512, True, torch.float32)]
K4_Y_TOL, K4_MOMENT_TOL = 2e-2, 1e-3
RESNET_BATCH = 32                  # bench.py's cell
RESNET_BLOCKS = 3 + 4 + 6 + 3
F32_RATIO = 3.0       # card vs CPU: f32 distance to the f64 step
RTC_FFN = (TRAIN_BATCH * TRAIN_SEQ, 3072)     # BERT-base FFN activations
RTC_MLM = (TRAIN_BATCH * TRAIN_P, 30522)      # masked-LM logits
RTC_STEPS = 3
RTC_REPS, RTC_WARMUP = 30, 5                  # median_ms defaults
RTC_LAUNCH_CALLS = 100      # host cost of one launch, averaged over these
# the generate slice: BERT-base's encoder with the causal mask and a tied LM
# head (GPT-2-small's width), built with explicit arguments
LM_CONFIG = dict(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                 vocab_size=30522, max_length=512)
GEN_ENGINE = dict(max_seq_len=512, max_batch_size=8, page_size=16,
                  num_pages=257)
GEN_CLIENTS, GEN_SEQS, GEN_NEW_TOKENS = 4, 24, 32
GEN_PROMPT_RANGE = (8, 448)
GEN_TENANT, GEN_TENANT_SLO_MS = "slo50", 50.0
GEN_F32_PROMPT, GEN_F32_TOKENS, GEN_F32_PAGES = 40, 8, 33
GEN_TIMED_REPS, GEN_TIMED_POS, GEN_PROFILE_STEPS = 10, 300, 10
PREFILL_TIMED_SHAPES = [(1, 12, 512, 64), (1, 12, 128, 64)]
TEMPLATED_SOURCE = r"""
template <typename T> __global__ void twice(const T *x, int n, T *o) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    o[i] = x[i] + x[i];
}"""


def _bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


def bound_ms(shape, dtype, causal: bool, kernel: str = "fwd"):
    """Least time on an H100 for one call of ``kernel``: each input read
    once, each output written once, against the products this input needs
    (causal: the lower triangle only). fwd (K1): q, k, v -> o, lse; dq (K2):
    q, k, v, o, dO, lse -> dq, delta; dkv (K3): q, k, v, dO, lse, delta ->
    dk, dv; bwd (K2 + K3): q, k, v, o, dO, lse -> dq, dk, dv, with delta's
    products."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    mat, row = B * H * S * D * elt, B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    mats, rows, mults = {"fwd": (4, 1, 4), "dq": (6, 2, 6),
                         "dkv": (6, 2, 8), "bwd": (8, 1, 14)}[kernel]
    flops = mults * pairs * D + (2 * B * H * S * D if kernel == "bwd" else 0)
    return _bound(mats * mat + rows * row, flops, dtype)


# ---------------------------------------------------------------------------
def phase_environment(smi: str):
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    # one nvcc per library, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(fa._kernel), pool.submit(fa._bwd_kernels),
                  pool.submit(fc._kernel)]:
            f.result()
    print(f"built the three libraries in {time.perf_counter() - t0:.1f} s")
    for name in (fa._LIB_NAME, fa._BWD_LIB_NAME, fc._LIB_NAME):
        log = _build.build_log(name)
        print(f"built {log['path']} (nvcc {log['seconds']:.1f} s, "
              f"cached={log['cached']})")
        for line in log["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                print("  ptxas:", line.strip())


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def split_qkv(shape, gen, dtype):
    """q, k, v as the QKV projection hands them to K1: the (B, H, S, D)
    views of one seeded (B, S, 3 * H * D) buffer."""
    B, H, S, D = shape
    qkv = _randn((B, S, 3 * H * D), gen, dtype)
    return [x.view(B, S, H, D).transpose(1, 2)
            for x in qkv.split(H * D, dim=-1)]


def k1_host_us(gen, rounds: int = K1_HOST_ROUNDS,
               calls: int = K1_HOST_CALLS):
    """Host microseconds of one K1 call through its wrapper (checks, two
    allocations, the launch), of its C entry alone (four tensor maps
    encoded, the launch) and of one SDPA call, on split views at
    (1, 1, 128, 64) bf16: ``rounds`` rounds, each timing ``calls``
    back-to-back calls of the three in turn on the host clock (the device
    drained before each), the median round of each. Taking turns within a
    round keeps the three comparable on a host whose speed drifts."""
    q, k, v = split_qkv((1, 1, 128, 64), gen, torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v, 0.125, False)
    entry = fa._kernel()
    views = (ctypes.c_longlong * 16)(*(
        n for x in (q, k, v, out) for n in (x.data_ptr(), *fa.tma_strides(x))))
    stream = torch.cuda.current_stream().cuda_stream
    fns = {
        "k1": lambda: fa.flash_attention_fwd(q, k, v, 0.125, False),
        "entry": lambda: entry(views, lse.data_ptr(), 1, 1, 128, 64, 1,
                               0.125, 0, stream),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=0.125)}
    times = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(10):
            fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def phase_kernel(seed: int, smi: str):
    """K1 against its plain version at every listed shape, on the split
    views of one QKV buffer and on contiguous copies of them (the two
    results bitwise equal); times at the serving and training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    record = {}
    for shape, causal in CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = split_qkv(shape, gen, dtype)
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            scale = shape[-1] ** -0.5
            out, lse = fa.flash_attention_fwd(qc, kc, vc, scale, causal)
            out_s, lse_s = fa.flash_attention_fwd(q, k, v, scale, causal)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_fwd_reference(qc, kc, vc, scale,
                                                            causal)
            err_o = (out.float() - ref.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            err_os = (out_s.float() - ref.float()).abs().max().item()
            err_ls = (lse_s - ref_lse).abs().max().item()
            same = torch.equal(out_s, out) and torch.equal(lse_s, lse)
            ok = max(err_o, err_l, err_os, err_ls) <= TOL[dtype] and same
            line = (f"kernel {shape} {str(dtype)[6:]} causal={causal}: "
                    f"max|dO|={err_o:.3g} max|dLSE|={err_l:.3g}, split "
                    f"views max|dO|={err_os:.3g} max|dLSE|={err_ls:.3g}, "
                    f"bitwise equal to contiguous: {same}; "
                    f"tol={TOL[dtype]:g}")
            where = TIMED_SHAPES.get(shape)
            if where and not causal:
                ms = median_ms(lambda: fa.flash_attention_fwd(
                    qc, kc, vc, scale, causal), calls=TIMED_CALLS)
                ms_s = median_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, scale, causal), calls=TIMED_CALLS)
                plain = median_ms(lambda: fa.flash_attention_fwd_reference(
                    qc, kc, vc, scale, causal), reps=20, warmup=2,
                    calls=TIMED_CALLS)
                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=causal, scale=scale)

                lib = median_ms(sdpa, calls=TIMED_CALLS)
                dev = graph_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, scale, causal))
                lib_dev = graph_ms(sdpa)
                bms, by, nbytes, flops = bound_ms(shape, dtype, causal)
                line += (f" | {where}: kernel {ms:.4f} ms, on split views "
                         f"{ms_s:.4f} ms ({dev:.4f} ms from a CUDA graph), "
                         f"plain {plain:.4f} ms, sdpa {lib:.4f} ms "
                         f"({lib_dev:.4f} ms from a CUDA graph), bound "
                         f"{bms * 1e3:.1f} us ({by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP), {bms / ms:.1%} of bound "
                         f"on {smi}")
                record[where, dtype] = {
                    "max_abs_err": max(err_o, err_l, err_os, err_ls),
                    "ms": ms, "ms_strided": ms_s, "device_ms": dev,
                    "plain_ms": plain, "library_ms": lib,
                    "library_device_ms": lib_dev, "bound_ms": bms,
                    "bound_by": by}
            print(line)
            if not ok:
                raise SystemExit(f"FAIL: kernel disagrees with its plain "
                                 f"version, or the split views with the "
                                 f"contiguous copies, at {shape} {dtype} "
                                 f"causal={causal}")
            del q, k, v, qc, kc, vc, out, lse, out_s, lse_s, ref, ref_lse
    record["host_us"] = k1_host_us(gen)
    print(f"host cost of one K1 call (split views, 4 tensor maps encoded): "
          f"{record['host_us']['k1']:.2f} us, of which its C entry "
          f"{record['host_us']['entry']:.2f} us; one SDPA call "
          f"{record['host_us']['sdpa']:.2f} us (median of {K1_HOST_ROUNDS} "
          f"rounds of {K1_HOST_CALLS} calls each, in turns)")
    return record


def _bwd_errors(got, want, dtype):
    """max |kernel - plain| of each output, and whether every one is finite
    and within TOL[dtype] x max(1, max|plain|)."""
    errs, ok = [], True
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        ok &= err <= TOL[dtype] * max(1.0, b.float().abs().max().item()) \
            and bool(torch.isfinite(a).all())
        errs.append(err)
    return errs, ok


def _sdpa_bwd_graph_ms(q, k, v, do, scale, causal):
    """Device ms of SDPA's backward alone: a CUDA graph of its forward plus
    backward (autograd captured with the forward, on one stream) less a
    graph of its forward."""
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, scale=scale)

    both = graph_ms(lambda: torch.autograd.grad(fwd(), (qs, ks, vs), do))
    return both - graph_ms(fwd)


def time_backward(q, k, v, out, lse, do, scale, causal, smi, shape):
    """K2, K3 and the whole backward through the wrappers and from CUDA
    graphs, each kernel's plain version and SDPA's backward, beside the
    bounds, at one shape (bf16); prints them and returns the record."""
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale, causal)
    calls = {
        "dq": lambda: fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale,
                                                causal),
        "dkv": lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  scale, causal),
        "bwd": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                              causal)}
    plains = {
        "dq": lambda: fa.flash_attention_bwd_dq_reference(
            q, k, v, out, do, lse, scale, causal),
        "dkv": lambda: fa.flash_attention_bwd_dkv_reference(
            q, k, v, do, lse, delta, scale, causal),
        "bwd": lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, scale, causal)}
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, scale=scale)
    lib = median_ms(lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do, retain_graph=True), calls=TIMED_CALLS)
    lib_dev = _sdpa_bwd_graph_ms(q, k, v, do, scale, causal)
    record = {"library_ms": lib, "library_device_ms": lib_dev}
    line = (f"backward times at {shape} bf16 on {smi}: sdpa backward {lib:.4f}"
            f" ms through autograd, {lib_dev:.4f} ms from a CUDA graph "
            f"(dq, dk, dv together)")
    for name, fn in calls.items():
        ms = median_ms(fn, calls=TIMED_CALLS)
        dev = graph_ms(fn)
        plain = median_ms(plains[name], reps=20, warmup=2, calls=TIMED_CALLS)
        bms, by, nbytes, flops = bound_ms(shape, torch.bfloat16, causal, name)
        record[name] = {"ms": ms, "device_ms": dev, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by}
        line += (f"\n  {name}: {ms:.4f} ms ({dev:.4f} ms from a CUDA graph), "
                 f"plain {plain:.4f} ms, bound {bms * 1e3:.1f} us ({by}: "
                 f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                 f"{bms / dev:.1%} of bound from the graph")
    print(line)
    return record


def check_other_head_dim(gen):
    """A head dim the kernels do not take (D = 16, the generative test
    model's) through ``multi_head_attention`` on the card: forward and the
    QKV gradient in f32 against the same calls on the CPU within 1e-4 (the
    dense path on both, sum order only), no kernel launched; bf16 runs
    without raising."""
    N, L, H, D = 2, 64, 2, 16
    x = _randn((N, L, 3 * H * D), gen, torch.float32)
    g = _randn((N, L, H * D), gen, torch.float32)
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    results = []
    for dev_x, dev_g in ((x, g), (x.cpu(), g.cpu())):
        xr = dev_x.detach().requires_grad_()
        out = ops.multi_head_attention(*xr.split(H * D, dim=-1), None,
                                       heads=H, causal=True)
        (gx,) = torch.autograd.grad(out, (xr,), dev_g)
        results.append((out.detach().cpu(), gx.cpu()))
    xb = x.to(torch.bfloat16).requires_grad_()
    out = ops.multi_head_attention(*xb.split(H * D, dim=-1), None, heads=H)
    (gb,) = torch.autograd.grad(out, (xb,), g.to(torch.bfloat16))
    torch.cuda.synchronize()
    launched = (fa.launches, fa.launches_dq, fa.launches_dkv) != before
    (o_gpu, g_gpu), (o_cpu, g_cpu) = results
    err = max((o_gpu - o_cpu).abs().max().item(),
              (g_gpu - g_cpu).abs().max().item())
    finite = bool(torch.isfinite(gb.float()).all())
    print(f"head dim {D} (dense route) on the card: f32 forward and QKV "
          f"gradient vs the CPU max|d|={err:.3g} (tol 1e-4), kernels "
          f"launched: {launched}; bf16 gradient finite: {finite}")
    if err > 1e-4 or launched or not finite:
        raise SystemExit(f"FAIL: head dim {D} on the card")


def phase_backward(seed: int, smi: str):
    """K2 and K3 each against its own plain version at every listed shape,
    on the training path's layouts and on contiguous copies (bitwise
    equal); a head dim the kernels do not take; times and bounds at the
    training and serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    record = {}
    for shape, causal in BWD_SHAPES:
        B, H, S, D = shape
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = split_qkv(shape, gen, dtype)
            do = _randn((B, S, H, D), gen, dtype).transpose(1, 2)
            scale = D ** -0.5
            out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse,
                                                  scale, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                scale, causal)
            c = [x.contiguous() for x in (q, k, v, out, do)]
            cdq, cdelta = fa.flash_attention_bwd_dq(*c, lse, scale, causal)
            cdk, cdv = fa.flash_attention_bwd_dkv(*c[:3], c[4], lse, cdelta,
                                                  scale, causal)
            torch.cuda.synchronize()
            want_dq = fa.flash_attention_bwd_dq_reference(
                q, k, v, out, do, lse, scale, causal)
            want_dkv = fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, scale, causal)
            errs_dq, ok_dq = _bwd_errors((dq, delta), want_dq, dtype)
            errs_dkv, ok_dkv = _bwd_errors((dk, dv), want_dkv, dtype)
            same = all(torch.equal(a, b) for a, b in (
                (dq, cdq), (delta, cdelta), (dk, cdk), (dv, cdv)))
            print(f"backward {shape} {str(dtype)[6:]} causal={causal}: K2 "
                  f"max|d dq|={errs_dq[0]:.3g} max|d delta|={errs_dq[1]:.3g}"
                  f"; K3 max|d dk|={errs_dkv[0]:.3g} max|d dv|="
                  f"{errs_dkv[1]:.3g}; tol={TOL[dtype]:g} x max(1, "
                  f"max|plain|); split views bitwise equal to contiguous: "
                  f"{same}")
            if not (ok_dq and ok_dkv and same):
                raise SystemExit(f"FAIL: K2/K3 disagree with their plain "
                                 f"versions, or the views with contiguous "
                                 f"copies, at {shape} {dtype} causal={causal}")
            for name, errs in (("dq", errs_dq), ("dkv", errs_dkv)):
                record.setdefault(f"{name}_err", 0.0)
                record[f"{name}_err"] = max(record[f"{name}_err"], *errs)
            where = TIMED_SHAPES.get(shape)
            if where and not causal and dtype == torch.bfloat16:
                record[where] = time_backward(q, k, v, out, lse, do, scale,
                                              causal, smi, shape)
            del q, k, v, do, out, lse, delta, dq, dk, dv, c, cdq, cdelta, \
                cdk, cdv, want_dq, want_dkv
    check_other_head_dim(gen)
    return record


def k4_bound_ms(M, K, N, x_dtype=torch.bfloat16):
    """Least time on an H100 for one K4 call: x, w, scale, shift read once,
    y, col_sum, col_sumsq written once, against the product's 2 M K N
    operations at the bf16 tensor-core peak."""
    nbytes = M * K * (torch.finfo(x_dtype).bits // 8) + K * N * 2 + \
        2 * K * 4 + M * N * 2 + 2 * N * 4
    return _bound(nbytes, 2 * M * K * N, torch.bfloat16)


def _k4_inputs(gen, M, K, N, x_dtype):
    x = _randn((M, K), gen, x_dtype)
    w = (_randn((K, N), gen, torch.float32) * K ** -0.5).to(torch.bfloat16)
    scale = torch.rand(K, generator=gen, device="cuda") + 0.5
    shift = 0.1 * torch.randn(K, generator=gen, device="cuda")
    return x, w, scale, shift


def _k4_errors(got, want):
    """max |y - plain y| and the moments' max errors, each over its
    tolerance x max(1, max |plain|) (pass if every ratio <= 1)."""
    errs, ratios = [], []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        tol = (K4_Y_TOL if i == 0 else K4_MOMENT_TOL) * \
            max(1.0, b.abs().max().item())
        errs.append(err)
        ratios.append(err / tol if torch.isfinite(a).all() else float("inf"))
    return errs, ratios


def phase_fused_conv(seed: int, smi: str):
    """K4 against its plain version at ResNet-50's nine batch-128 1x1
    shapes (timed: the kernel, the plain version, torch.matmul of the
    pre-activated bf16 x with w as the product alone, and the bound) and at
    the edge cases; twice at each shape, to show the result does not change
    from run to run."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    record = {"shapes": {}, "max_abs_err": 0.0}
    for label, M, K, N in K4_SHAPES:
        x, w, scale, shift = _k4_inputs(gen, M, K, N, torch.bfloat16)
        got = fc.conv1x1_bn_act(x, w, scale, shift)
        again = fc.conv1x1_bn_act(x, w, scale, shift)
        torch.cuda.synchronize()
        want = fc.conv1x1_bn_act_reference(x, w, scale, shift)
        errs, ratios = _k4_errors(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again
        xh = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
        comp_ratio = max(_k4_errors(k4_composition(x, w, scale, shift)[0],
                                    want)[1])
        del want
        kernel = lambda: fc.conv1x1_bn_act(x, w, scale, shift)  # noqa: E731
        matmul = lambda: torch.matmul(xh, w)  # noqa: E731
        comp = lambda: k4_composition(x, w, scale, shift)  # noqa: E731
        ms = median_ms(kernel, reps=10, warmup=3, calls=TIMED_CALLS)
        plain = median_ms(lambda: fc.conv1x1_bn_act_reference(
            x, w, scale, shift), reps=5, warmup=1, calls=TIMED_CALLS)
        lib = median_ms(matmul, reps=10, warmup=3, calls=TIMED_CALLS)
        comp_ms = median_ms(comp, reps=10, warmup=3, calls=TIMED_CALLS)
        # device times: CUDA graphs of TIMED_CALLS calls, no host work
        dev, lib_dev, comp_dev = graph_ms(kernel), graph_ms(matmul), \
            graph_ms(comp)
        bms, by, nbytes, flops = k4_bound_ms(M, K, N)
        print(f"K4 {label} (M={M}, K={K}, N={N}) bf16, schedule "
              f"{fc._schedule(M, N, fc._sm_count(x.device))}: "
              f"max|dy|={errs[0]:.3g} max|dsum|={errs[1]:.3g} "
              f"max|dsumsq|={errs[2]:.3g} (worst {max(ratios):.3g} of "
              f"tolerance), repeatable={same} | kernel {ms:.4f} ms (graph "
              f"{dev:.4f}), plain {plain:.4f} ms, matmul of the product "
              f"alone {lib:.4f} ms (graph {lib_dev:.4f}), library "
              f"composition {comp_ms:.4f} ms (graph {comp_dev:.4f}, within "
              f"{comp_ratio:.3g} of tolerance), bound {bms * 1e3:.1f} us "
              f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{bms / dev:.1%} of bound from the graph on {smi}")
        if max(ratios) > 1 or not same:
            raise SystemExit(f"FAIL: K4 disagrees with its plain version "
                             f"(or with itself) at {label}")
        record["shapes"][label] = {
            "M": M, "K": K, "N": N, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "library_ms": lib, "library_device_ms": lib_dev,
            "composition_ms": comp_ms, "composition_device_ms": comp_dev,
            "bound_ms": bms, "bound_by": by, "bound_share": bms / dev}
        record["max_abs_err"] = max(record["max_abs_err"], *errs)
        del x, w, scale, shift, xh
    for M, K, N, relu, x_dtype in K4_EDGES:
        x, w, scale, shift = _k4_inputs(gen, M, K, N, x_dtype)
        got = fc.conv1x1_bn_act(x, w, scale, shift, relu=relu)
        torch.cuda.synchronize()
        errs, ratios = _k4_errors(got, fc.conv1x1_bn_act_reference(
            x, w, scale, shift, relu=relu))
        print(f"K4 (M={M}, K={K}, N={N}) relu={relu} x {str(x_dtype)[6:]}: "
              f"max|dy|={errs[0]:.3g} max|dsum|={errs[1]:.3g} "
              f"max|dsumsq|={errs[2]:.3g} (worst {max(ratios):.3g} of "
              f"tolerance)")
        if max(ratios) > 1:
            raise SystemExit(f"FAIL: K4 disagrees with its plain version at "
                             f"M={M} K={K} N={N} relu={relu} {x_dtype}")
        record["max_abs_err"] = max(record["max_abs_err"], *errs)
    return record


def phase_slice(seed: int, smi: str):
    net = bert_base()
    named = seeded_bert_weights(net, seed)
    load_jax_params(net, named)
    net = net.to(torch.bfloat16)

    layers, units = len(net.encoder._layers), net._units

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    ep = serving.ModelEndpoint("bert", net, [(SEQ_LEN,), (SEQ_LEN,)],
                               dtype="int32", max_batch_size=32)
    server = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=512)
    server.register(ep)
    server.start()
    results = [[] for _ in range(N_CLIENTS)]
    errors = []

    def client(i):
        rng = np.random.default_rng(seed * 1000 + i)
        try:
            for _ in range(REQS_PER_CLIENT):
                rows = int(rng.integers(1, 9))
                tok = rng.integers(0, 30522, (rows, SEQ_LEN), dtype=np.int32)
                typ = rng.integers(0, 2, (rows, SEQ_LEN), dtype=np.int32)
                seq, pooled = server.predict("bert", (tok, typ), timeout=300)
                results[i].append((tok, typ, seq, pooled))
        except Exception as e:        # surfaced below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    server.stop(drain=True)
    launches = fa.launches
    # ---- end of the main path ----

    if errors or any(t.is_alive() for t in threads):
        raise SystemExit(f"FAIL: client errors {errors[:3]}")
    snap = ep.stats.snapshot()
    c = snap["counters"]
    executed = c["batches"] + c["warmup_batches"]
    reqs = [r for rs in results for r in rs]
    rows_total = sum(r[0].shape[0] for r in reqs)
    print(f"served {len(reqs)} requests ({rows_total} rows) in "
          f"{c['batches']} batches + {c['warmup_batches']} probe/warm-up "
          f"runs, occupancy {snap['batch_occupancy']:.3f}; kernel launches "
          f"{launches} (expected {layers} x {executed} = "
          f"{layers * executed})")
    if len(reqs) != N_CLIENTS * REQS_PER_CLIENT or c["completed"] != len(reqs):
        raise SystemExit("FAIL: not every request was served")
    if launches != layers * executed:
        raise SystemExit("FAIL: kernel launches do not match one per layer "
                         "per batch")

    worst_abs, worst_excess = 0.0, -1.0
    with torch.inference_mode():
        for tok, typ, seq, pooled in reqs:
            if seq.device.type != "cuda" or pooled.device.type != "cuda":
                raise SystemExit("FAIL: a response came from the CPU")
            rows = tok.shape[0]
            if tuple(seq.shape) != (rows, SEQ_LEN, units) or \
                    tuple(pooled.shape) != (rows, units):
                raise SystemExit(f"FAIL: response shapes {seq.shape}, "
                                 f"{pooled.shape}")
            d_seq, d_pooled = net(torch.from_numpy(tok).cuda(),
                                  torch.from_numpy(typ).cuda())
            for a, b in ((seq, d_seq), (pooled, d_pooled)):
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    raise SystemExit("FAIL: non-finite response")
                diff = (a - b).abs()
                worst_abs = max(worst_abs, diff.max().item())
                worst_excess = max(worst_excess, (
                    diff - (2e-2 + 2e-2 * b.abs())).max().item())
    print(f"responses vs direct forward: max|d|={worst_abs:.4g}, "
          f"max(|d| - tol)={worst_excess:.4g} (pass if <= 0)")
    if worst_excess > 0:
        raise SystemExit("FAIL: a response differs from the direct forward")

    # one row in f32: the card (kernel f32 path) against the plain CPU path
    tok, typ = reqs[0][0][:1], reqs[0][1][:1]
    ref = bert_base()
    load_jax_params(ref, named)
    ref.eval()
    with torch.inference_mode():
        cpu_seq, cpu_pooled = ref(torch.from_numpy(tok), torch.from_numpy(typ))
        ref = ref.cuda()
        gpu_seq, gpu_pooled = ref(torch.from_numpy(tok).cuda(),
                                  torch.from_numpy(typ).cuda())
    err32 = max((gpu_seq.cpu() - cpu_seq).abs().max().item(),
                (gpu_pooled.cpu() - cpu_pooled).abs().max().item())
    bf = reqs[0][2][:1].float().cpu()
    rel16 = ((bf - cpu_seq).norm() / cpu_seq.norm()).item()
    print(f"f32 card vs f32 CPU plain forward (1 row): max|d|={err32:.3g} "
          f"(tol 1e-3); served bf16 vs f32 CPU: relative error {rel16:.3g}")
    if err32 > 1e-3:
        raise SystemExit("FAIL: the f32 forward on the card disagrees with "
                         "the plain CPU forward")

    lat = snap["latency"]
    print(f"serving bert_base S={SEQ_LEN} bf16, {N_CLIENTS} closed-loop "
          f"clients: {len(reqs) / wall:.2f} requests/s, "
          f"{rows_total * SEQ_LEN / wall:.0f} tokens/s, "
          f"p50 {lat['p50_us'] / 1e3:.2f} ms, p99 {lat['p99_us'] / 1e3:.2f} "
          f"ms, step p50 {snap['step']['p50_us'] / 1e3:.2f} ms "
          f"(wall {wall:.2f} s) on {smi}")
    return launches


def _train_step(named, dropout, compute_dtype, ctx=None, seed=0):
    model = BERTForPretraining(bert_base(max_length=TRAIN_SEQ,
                                         dropout=dropout))
    load_jax_params(model, named)
    mesh = make_mesh({"dp": 1}) if ctx is None else make_mesh({"dp": 1},
                                                               ctx=ctx)
    return ParallelTrainStep(PretrainStep(model), BERTPretrainingLoss(),
                             Adam(learning_rate=TRAIN_LR), mesh,
                             compute_dtype=compute_dtype,
                             extra_specs=("dp", "dp"), seed=seed)


def phase_train(seed: int, smi: str):
    rng = np.random.default_rng(seed + 2)
    named = seeded_bert_weights(BERTForPretraining(
        bert_base(max_length=TRAIN_SEQ, device="meta"), device="meta"), seed)
    step = _train_step(named, 0.1, "bfloat16", seed=seed)
    warm = pretrain_batch(rng, TRAIN_WARMUP, TRAIN_BATCH, TRAIN_SEQ,
                          TRAIN_P)
    bench = step.place_batch_n(*pretrain_batch(rng, TRAIN_K, TRAIN_BATCH,
                                               TRAIN_SEQ, TRAIN_P))
    fixed = step.place_batch_n(*pretrain_batch(rng, 1, TRAIN_BATCH,
                                               TRAIN_SEQ, TRAIN_P))
    fixed = (fixed[0][0], (fixed[1][0][0], fixed[1][1][0]), fixed[2][0],
             fixed[3][0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    losses = [step(warm[0][i], (warm[1][0][i], warm[1][1][i]), warm[2][i],
                   warm[3][i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CALLS):
        losses.append(step.step_n(*bench))
    losses[-1][-1].item()                  # the window closes on a fetch
    wall = time.perf_counter() - t0
    fixed_losses, step_ms = [], []
    for _ in range(TRAIN_FIXED):
        t1 = time.perf_counter()
        fixed_losses.append(step(*fixed).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = {"flash_attention_fwd": fa.launches,
              "flash_attention_bwd_dq": fa.launches_dq,
              "flash_attention_bwd_dkv": fa.launches_dkv}
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated()
    all_losses = torch.cat([x.reshape(-1) for x in losses]).cpu()
    steps = TRAIN_WARMUP + TRAIN_CALLS * TRAIN_K + TRAIN_FIXED
    layers = len(step._block.inner.backbone.encoder._layers)
    print(f"trained BERTForPretraining(bert_base) bf16, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, P={TRAIN_P}: {steps} steps; losses "
          f"first {all_losses[0].item():.4f}, last "
          f"{all_losses[-1].item():.4f}; fixed batch "
          f"{fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f}; launches "
          f"{counts} (expected {layers} x {steps} = {layers * steps} each)")
    if not torch.isfinite(all_losses).all() or \
            not np.isfinite(fixed_losses).all():
        raise SystemExit("FAIL: a training loss is not finite")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise SystemExit("FAIL: the fixed batch's loss did not fall")
    if any(n != layers * steps for n in counts.values()):
        raise SystemExit("FAIL: kernel launches do not match one per layer "
                         "per step")
    tokens = TRAIN_BATCH * TRAIN_SEQ * TRAIN_K * TRAIN_CALLS
    print(f"training bert_base S={TRAIN_SEQ} bf16: {tokens / wall:.0f} "
          f"tokens/s over {TRAIN_CALLS} step_n calls of K={TRAIN_K} (wall "
          f"{wall:.3f} s), step median {float(np.median(step_ms)):.2f} ms "
          f"(host clock to a fetched loss), peak device memory "
          f"{peak / 2**30:.2f} GiB on {smi}")
    del step, bench, fixed, losses

    # one f32 step at batch 2 on the card against the plain versions on
    # the CPU, same weights and batch, dropout 0
    batch = pretrain_batch(rng, 1, 2, TRAIN_SEQ, TRAIN_P)
    batch = (batch[0][0], (batch[1][0][0], batch[1][1][0]), batch[2][0],
             batch[3][0])
    results = []
    for ctx in (None, cpu()):
        st = _train_step(named, 0.0, None, ctx=ctx)
        loss = st(*batch).item()
        results.append((loss, {k: v.detach().cpu()
                               for k, v in st.params.items()}))
        del st
    (l_gpu, p_gpu), (l_cpu, p_cpu) = results
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    diff = torch.cat([(p_gpu[k] - p_cpu[k]).abs().reshape(-1)
                      for k in p_cpu])
    worst, frac = diff.max().item(), (diff > 0.1 * TRAIN_LR).float().mean()
    print(f"f32 step, card vs CPU plain versions (batch 2 x {TRAIN_SEQ}): "
          f"loss {l_gpu:.6f} vs {l_cpu:.6f} (relative {rel:.3g}, tol 1e-4); "
          f"parameters max|d| {worst / TRAIN_LR:.3g} lr (tol 2 lr), share "
          f"beyond 0.1 lr {frac.item():.3g} (tol 1e-3), mean|d| "
          f"{diff.mean().item() / TRAIN_LR:.3g} lr")
    if not (rel <= 1e-4 and worst <= 2 * TRAIN_LR and frac <= 1e-3):
        raise SystemExit("FAIL: the f32 training step on the card disagrees "
                         "with the CPU")
    return counts


def _k4_sites(net, cast, x):
    """One bf16 training-mode forward of ``net`` (parameters ``cast``)
    with hooks at every BottleneckV1: the 3x3 convolution's output, the
    scale and shift its BatchNorm computes from it, the last 1x1
    convolution's weight, bias and output, and the batch mean and variance
    of its BatchNorm. Returns one dict per block."""
    sites, handles = [], []

    def bn_stats(bn, inp):
        return ops.bn_scale_shift(inp, bn.gamma, bn.beta, bn.running_mean,
                                  bn.running_var, training=True,
                                  **{k: v for k, v in bn._kwargs.items()
                                     if k != "use_global_stats"})

    for blk in (m for m in net.modules() if isinstance(m, BottleneckV1)):
        site = {}
        sites.append(site)
        body = blk.body

        def pre_bn2(mod, args, site=site):
            site["x"] = args[0]
            site["a"], site["b"] = bn_stats(mod, args[0])[:2]

        def post_conv(mod, args, out, site=site):
            site["w"], site["bias"], site["out"] = mod.weight, mod.bias, out

        def pre_bn3(mod, args, site=site):
            site["mean"], site["var"] = bn_stats(mod, args[0])[2:4]

        handles += [body[4].register_forward_pre_hook(pre_bn2),
                    body[6].register_forward_hook(post_conv),
                    body[7].register_forward_pre_hook(pre_bn3)]
    try:
        with torch.no_grad():
            torch.func.functional_call(net, cast, (x,))
    finally:
        for h in handles:
            h.remove()
    return sites


def resnet_f32_step(named, seed: int):
    """One f32 step at batch 2 on the card against the same step on the CPU,
    both held against the step computed in f64 on the CPU, leaf by leaf:
    each parameter's update on the card may be at most F32_RATIO times as
    far from the f64 update as the CPU's f32 update of that parameter is,
    in norm, and at most F32_RATIO times the CPU's largest element error in
    the same stage, in its largest element; each plus one f32 ulp of the
    leaf's weights. Returns the per-leaf distances."""
    runs = f32_drift.step_runs(named, seed)
    probe = resnet50_v1(classes=1000, device="meta")
    leaves = f32_drift.leaf_distances(runs, probe.jax_names())
    stage_max = {}
    for v in leaves.values():
        stage_max[v["stage"]] = max(stage_max.get(v["stage"], 0.0),
                                    v["cpu_max"])
    margin = {k: max(v["card_norm"] / (F32_RATIO * v["cpu_norm"]
                                       + v["ulp_norm"]),
                     v["card_max"] / (F32_RATIO * stage_max[v["stage"]]
                                      + v["ulp_max"]))
              for k, v in leaves.items()}
    bad = [k for k, m in margin.items() if m > 1]
    total = sum(v["update_norm"] ** 2 for v in leaves.values()) ** 0.5
    cpu_sq = sum(v["cpu_norm"] ** 2 for v in leaves.values())
    e_card = sum(v["card_norm"] ** 2 for v in leaves.values()) ** 0.5 / total
    (l_gpu, s_gpu), (l_cpu, s_cpu) = ((runs[t]["loss"], runs[t]["buffers"])
                                      for t in ("card", "cpu"))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    stat_err = max(((s_gpu[k] - s_cpu[k]).abs().max()
                    / max(1.0, s_cpu[k].abs().max().item())).item()
                   for k in s_cpu)
    worst = max(margin, key=margin.get)
    print(f"f32 step, card vs CPU (batch 2): loss {l_gpu:.6f} vs {l_cpu:.6f}"
          f" (relative {rel:.3g}, tol 1e-4); running stats card vs CPU "
          f"max|d| {stat_err:.3g} x max(1, |stat|) (tol 1e-4); update "
          f"against the CPU's f64 step, all parameters: card f32 "
          f"{e_card:.4g}, CPU f32 {cpu_sq ** 0.5 / total:.4g} of its norm; "
          f"per leaf (tol: card <= {F32_RATIO:g} x the CPU's distance of the"
          f" leaf in norm and of the leaf's stage in max, + 1 ulp of the "
          f"weights): {len(leaves) - len(bad)} of {len(leaves)} hold; the "
          f"closest, {worst}, at {margin[worst]:.3g} of its tolerance")
    print("  the CPU's f32-vs-f64 distance is carried by: " + "; ".join(
        f"{k} {leaves[k]['cpu_norm'] ** 2 / cpu_sq:.1%} (card "
        f"{leaves[k]['card_norm'] / leaves[k]['update_norm']:.3g}, CPU "
        f"{leaves[k]['cpu_norm'] / leaves[k]['update_norm']:.3g} of the "
        f"leaf's update)"
        for k in sorted(leaves, key=lambda k: -leaves[k]["cpu_norm"])[:5]))
    for k in bad:
        print(f"  leaf beyond tolerance: {k} {leaves[k]}")
    if not (rel <= 1e-4 and stat_err <= 1e-4 and not bad):
        raise SystemExit("FAIL: the f32 ResNet-50 step on the card "
                         "disagrees with the CPU")
    return leaves


def phase_resnet(seed: int, smi: str):
    """ResNet-50 v1 training as bench.py runs it, K4 on the model's own
    activations, and one f32 step on the card against the CPU."""
    probe = resnet50_v1(classes=1000, device="meta")
    named = seeded_resnet_weights(probe, seed)
    step = resnet_train_step(named, "bfloat16")
    rng = np.random.default_rng(seed + 4)
    warm = step.place_batch_n(*resnet_batch(rng, TRAIN_WARMUP, RESNET_BATCH))
    bench = step.place_batch_n(*resnet_batch(rng, TRAIN_K, RESNET_BATCH))
    fixed = step.place_batch_n(*resnet_batch(rng, 1, RESNET_BATCH))
    # bench.py hands the step bf16 images
    warm, bench, fixed = ((xs.to(torch.bfloat16), ys)
                          for xs, ys in (warm, bench, fixed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: ResNet-50 training steps ----
    fc.launches = 0
    losses = [step(warm[0][i], warm[1][i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CALLS):
        losses.append(step.step_n(*bench))
    losses[-1][-1].item()                  # the window closes on a fetch
    wall = time.perf_counter() - t0
    fixed_losses, step_ms = [], []
    for _ in range(TRAIN_FIXED):
        t1 = time.perf_counter()
        fixed_losses.append(step(fixed[0][0], fixed[1][0]).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    train_launches = fc.launches       # the reference's net is unfused: 0
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated()
    all_losses = torch.cat([x.reshape(-1) for x in losses]).cpu()
    steps = TRAIN_WARMUP + TRAIN_CALLS * TRAIN_K + TRAIN_FIXED
    net = step._block
    stats = step.buffers
    means = torch.cat([v for k, v in stats.items() if k.endswith("mean")])
    varis = torch.cat([v for k, v in stats.items() if k.endswith("var")])
    print(f"trained resnet50_v1 bf16, batch {RESNET_BATCH} x 3 x 224 x 224, "
          f"SGD(lr 0.05, momentum 0.9): {steps} steps; losses first "
          f"{all_losses[0].item():.4f}, last {all_losses[-1].item():.4f}; "
          f"fixed batch {fixed_losses[0]:.4f} -> {fixed_losses[-1]:.4f}; "
          f"running means |max| {means.abs().max().item():.4g}, running "
          f"variances in [{varis.min().item():.4g}, "
          f"{varis.max().item():.4g}] over {len(stats) // 2} BatchNorms; "
          f"K4 launches {train_launches} (the net is unfused)")
    if not torch.isfinite(all_losses).all() or \
            not np.isfinite(fixed_losses).all():
        raise SystemExit("FAIL: a ResNet-50 training loss is not finite")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise SystemExit("FAIL: the fixed batch's loss did not fall")
    if not (torch.isfinite(means).all() and torch.isfinite(varis).all()
            and all(v.dtype == torch.float32 for v in stats.values())
            and (means != 0).any() and (varis != 1).any()):
        raise SystemExit("FAIL: the running stats did not move from (0, 1) "
                         "or are not finite float32")
    images = RESNET_BATCH * TRAIN_K * TRAIN_CALLS
    print(f"training resnet50_v1 bf16: {images / wall:.1f} img/s over "
          f"{TRAIN_CALLS} step_n calls of K={TRAIN_K} (wall {wall:.3f} s), "
          f"step median {float(np.median(step_ms)):.2f} ms (host clock to a "
          f"fetched loss), peak device memory {peak / 2**30:.2f} GiB on "
          f"{smi}")

    # ---- K4 on the model's own activations: counts from 0 just before ----
    cast = {n: p.to(torch.bfloat16) for n, p in step.params.items()}
    sites = _k4_sites(net, cast, fixed[0][0])
    fc.launches = 0
    results = []
    for site in sites:
        x = site["x"]
        n, c = x.shape[:2]
        xm = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
        w = site["w"].reshape(site["w"].shape[0], c).t().contiguous()
        results.append(fc.conv1x1_bn_act(xm, w, site["a"], site["b"]))
    torch.cuda.synchronize()
    k4_launches = fc.launches
    # ---- end of the K4 path ----
    worst_y = worst_m = worst_v = 0.0
    for site, (y, col_sum, col_sumsq) in zip(sites, results):
        out = site["out"]
        rows = out.numel() // out.shape[1]
        ref = out.permute(0, 2, 3, 1).reshape(rows, -1).float()
        bias = site["bias"].float()
        worst_y = max(worst_y, ((y.float() + bias - ref).abs().max()
                                / (K4_Y_TOL * max(1.0, ref.abs().max()
                                                  .item()))).item())
        mean = col_sum / rows
        var = col_sumsq / rows - mean.square()
        # y is rounded to bf16 (and the bias added in bf16) before the
        # BatchNorm sees it: two roundings of 2^-9 each bound the shift of
        # a column's mean by 2^-8 of its rms and of its variance by 2^-7
        # of its mean square; the tolerance is twice that
        sq = site["var"] + site["mean"].square()
        worst_m = max(worst_m, ((mean + bias - site["mean"]).abs()
                                / (2 ** -7 * sq.sqrt() + 1e-6)).max().item())
        worst_v = max(worst_v, ((var - site["var"]).abs()
                                / (2 ** -6 * sq + 1e-6)).max().item())
    print(f"K4 at the {len(sites)} bottlenecks of one bf16 training forward:"
          f" launches {k4_launches} (expected {RESNET_BLOCKS}); y + bias vs "
          f"the 1x1 conv's output {worst_y:.3g} of tolerance (2e-2 x "
          f"max(1, max|out|)); moments vs the next BatchNorm's mean "
          f"{worst_m:.3g} and variance {worst_v:.3g} of tolerance (2^-7 rms,"
          f" 2^-6 mean square)")
    if len(sites) != RESNET_BLOCKS or k4_launches != RESNET_BLOCKS:
        raise SystemExit("FAIL: K4 was not launched once per bottleneck")
    if max(worst_y, worst_m, worst_v) > 1:
        raise SystemExit("FAIL: K4 disagrees with the model's conv and "
                         "BatchNorm at a bottleneck")
    del step, warm, bench, fixed, losses, sites, results, cast

    resnet_f32_step(named, seed)
    return {"img_s": images / wall, "k4_launches": k4_launches,
            "train_launches": train_launches}


# ---------------------------------------------------------------------------
def _bf16_ulps(got, want):
    """max over the values of |got - want| in units of one bf16 ulp of
    want (the spacing of bf16 numbers at |want|; 2^-133 at 0)."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs())
    ulp = torch.ldexp(torch.ones_like(w), torch.where(w == 0, -133, e - 8))
    d = (g - w).abs() / ulp
    return d.max().item() if torch.isfinite(g).all() else float("inf")


def _expect_error(what, match, fn):
    """``fn()`` must raise MXNetError whose message holds ``match``."""
    try:
        fn()
    except MXNetError as e:
        msg = str(e)
        if match not in msg:
            raise SystemExit(f"FAIL: {what} raised without {match!r}: {msg}")
        print(f"  {what}: MXNetError ({msg.splitlines()[0][:110]})")
        return msg
    raise SystemExit(f"FAIL: {what} did not raise MXNetError")


def _imperative_cases(ctx):
    """A few of the CPU tests' NDArray and autograd cases on ``ctx``:
    numpy values and dtypes by name."""
    a = nd.array(np.arange(12, dtype=np.float32).reshape(3, 4), ctx=ctx)
    i = nd.array(np.array([1, 2, 3], np.int32), ctx=ctx)
    b = nd.full((3, 4), 2.0, ctx=ctx)
    out = {"array": a, "arange": nd.arange(0, 10, 2, ctx=ctx),
           "ones_int": nd.ones((2, 3), ctx=ctx, dtype="int32"),
           "arith": (a + b) * a - 1 / (a + 1) + a ** 2, "int_div": i / i,
           "int_scalar": i + 1, "compare": a > 5, "sum": a.sum(axis=0),
           "mean": a.mean(), "argmax": a.argmax(axis=1), "dot": nd.dot(a, a.T),
           "index": a[1:, ::2], "roundtrip": nd.array(a.asnumpy(), ctx=ctx)}
    x = nd.array([1.0, 2.0, 3.0], ctx=ctx)
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with autograd.record():
            y = (nd.exp(x) * x).sum()
        y.backward()
    out["grad_add"] = x.grad
    return {k: (v.asnumpy(), str(v.dtype), v.context) for k, v in out.items()}


def rtc_bound_ms(nbytes, ops_per_elt, n):
    """Least time on an H100: the bytes over 3.35 TB/s against the
    elementwise operations over the f32 rate without tensor cores."""
    return _bound(nbytes, ops_per_elt * n, torch.float32)


def phase_rtc(seed: int, smi: str):
    """The rtc slice and the imperative path on gpu(0) (phase 6)."""
    ctx = gpu(0)
    major, minor = _nvrtc.nvrtc_version()
    print(f"NVRTC {major}.{minor} ({_nvrtc.cuda_home()}), target "
          f"{' '.join(_nvrtc.ARCH_OPTIONS)}")
    rtc.launches = 0
    t0 = time.perf_counter()
    names = sorted(set(rx.SOURCES.values()))
    with ThreadPoolExecutor(len(names)) as pool:
        mods = dict(zip(names, pool.map(rx.module, names)))
    compile_s = {n: m.compile_seconds for n, m in mods.items()}
    print(f"compiled {len(mods)} rtc modules in "
          f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
              f"{n} {s:.3f} s" for n, s in compile_s.items()))

    # ---- errors, each at its call ----
    x8 = nd.array(np.arange(8, dtype=np.float32), ctx=ctx)
    y8 = nd.ones((8,), ctx=ctx)
    elementwise = (rx.CSRC_RTC / "elementwise.cu").read_text()
    msg = _expect_error("broken source", "failed to compile",
                        lambda: rtc.CudaModule(
                            'extern "C" __global__ void broken(float *x) '
                            '{ x[0] = ; }'))
    if "error" not in msg:
        raise SystemExit("FAIL: the compile error carries no NVRTC log")
    _expect_error("missing name", "not found",
                  lambda: rtc.CudaModule(elementwise).get_kernel(
                      "missing", rx.SIGNATURES["k"]))
    _expect_error("name outside exports", "not exported",
                  lambda: rtc.CudaModule(elementwise, exports=("k",)).get_kernel(
                      "axpy", rx.SIGNATURES["axpy"]))
    _expect_error("wrong dtype", "must be float32",
                  lambda: rx.axpy(x8.astype("float16"), y8))
    _expect_error("CPU array", "GPU context",
                  lambda: rx.axpy(x8.as_in_context(cpu()),
                                  y8.as_in_context(cpu())))
    _expect_error("1025 threads a block", "cuLaunchKernel",
                  lambda: rx.kernel("k").launch(
                      [x8, 8], block_dims=(1025, 1, 1), out_shapes=[(8,)]))
    torch.cuda.synchronize()       # the refused launch left nothing behind
    if rtc.launches != 0:
        raise SystemExit("FAIL: a refused call counted as a launch")
    # a templated kernel resolves through its lowered (mangled) name
    tmpl = rtc.CudaModule(TEMPLATED_SOURCE, exports=("twice<float>",))
    twice = tmpl.get_kernel("twice<float>", rx.SIGNATURES["k"]).launch(
        [x8, 8], block_dims=(32, 1, 1), out_shapes=[(8,)])
    ok = torch.equal(twice.data, 2 * x8.data)
    print(f"  exported template twice<float> -> {tmpl._lowered}: "
          f"{twice.asnumpy().tolist()} (equal to 2x: {ok})")
    if not ok:
        raise SystemExit("FAIL: the exported template kernel")

    n_params = sum(p.numel() for p in resnet50_v1(
        classes=1000, device="meta").parameters() if p.requires_grad)
    nd.random.seed(seed, ctx=ctx)
    xp = nd.random.normal(shape=(n_params,), ctx=ctx)
    yp = nd.random.normal(shape=(n_params,), ctx=ctx)
    xg = nd.random.normal(shape=RTC_FFN, dtype="bfloat16", ctx=ctx)
    wg = nd.random.normal(shape=RTC_FFN, dtype="bfloat16", ctx=ctx)
    logits = nd.random.normal(scale=4.0, shape=RTC_MLM, dtype="bfloat16",
                              ctx=ctx)
    xg.attach_grad()
    torch.cuda.synchronize()

    # ---- the main path: counts from 0 just before, read just after ----
    before_main = rtc.launches
    rtc.launches = 0
    for k in rx.SIGNATURES:
        rx.kernel(k).launches = 0
    ref_outs = {"axpy": rx.axpy(x8, y8), "scale": rx.scale(x8),
                "k": rx.identity(x8)}
    big = rx.axpy(xp, yp)
    per_step = []
    for _ in range(RTC_STEPS):
        before = rtc.launches
        with autograd.record():
            yg = rx.GeluTanh()(xg)
            loss = (yg * wg).sum()
        loss.backward()
        per_step.append(rtc.launches - before)
    lsm = rx.log_softmax(logits)
    lsm.wait_to_read()
    main_launches = rtc.launches
    by_launches = {k: rx.kernel(k).launches for k in rx.SIGNATURES}
    # ---- end of the main path ----
    torch.cuda.synchronize()
    expect_main = 3 + 1 + 2 * RTC_STEPS + 1
    print(f"rtc main path: {main_launches} launches (expected "
          f"{expect_main}), per GeluTanh step {per_step}, by kernel "
          f"{by_launches}")
    if main_launches != expect_main or per_step != [2] * RTC_STEPS or \
            sum(by_launches.values()) != main_launches:
        raise SystemExit("FAIL: rtc launch counts on the main path")

    plain = {"axpy": rx.axpy_plain(x8.data, y8.data),
             "scale": rx.scale_plain(x8.data), "k": rx.identity_plain(x8.data)}
    for k, out in ref_outs.items():
        same = torch.equal(out.data, plain[k])
        print(f"  {k} at 8 elements: {out.asnumpy().tolist()} bitwise equal "
              f"to the plain version: {same}")
        if not same:
            raise SystemExit(f"FAIL: rtc kernel {k} differs from its plain "
                             "version")
    lib_axpy = torch.add(yp.data, xp.data, alpha=2)
    same_big = torch.equal(big.data, rx.axpy_plain(xp.data, yp.data))
    same_lib = torch.equal(big.data, lib_axpy)
    print(f"  axpy over {n_params} f32 (resnet50_v1's trainable parameters):"
          f" bitwise equal to 2 * x + y: {same_big}, to torch.add(y, x, "
          f"alpha=2): {same_lib}")
    if not (same_big and same_lib):
        raise SystemExit("FAIL: axpy differs from its plain version")

    # GeluTanh: y and x.grad against the plain versions and torch autograd
    xd = xg.data.detach()
    xs = xd.clone().requires_grad_()
    ys = torch.nn.functional.gelu(xs, approximate="tanh")
    (ys * wg.data).sum().backward()
    errs = {"gelu_tanh_fwd": max(_bf16_ulps(yg.data, rx.gelu_tanh_plain(
                xd)), _bf16_ulps(yg.data, ys.detach())),
            "gelu_tanh_bwd": max(_bf16_ulps(xg.grad.data, rx.gelu_tanh_grad_plain(
                xd, wg.data)), _bf16_ulps(xg.grad.data, xs.grad)),
            "log_softmax": _bf16_ulps(lsm.data, rx.log_softmax_plain(
                logits.data))}
    def max_abs(got, *wants):
        return max((got.float() - w.float()).abs().max().item()
                   for w in wants)
    abs_err = {"gelu_tanh_fwd": max_abs(yg.data, rx.gelu_tanh_plain(xd),
                                        ys.detach()),
               "gelu_tanh_bwd": max_abs(xg.grad.data, rx.gelu_tanh_grad_plain(
                   xd, wg.data), xs.grad),
               "log_softmax": max_abs(lsm.data,
                                      rx.log_softmax_plain(logits.data)),
               "axpy": max_abs(big.data, rx.axpy_plain(xp.data, yp.data))}
    print(f"  GeluTanh at {RTC_FFN} bf16, {RTC_STEPS} recorded steps: y within"
          f" {errs['gelu_tanh_fwd']:.3g} and x.grad within "
          f"{errs['gelu_tanh_bwd']:.3g} bf16 ulp of the plain versions and "
          f"of F.gelu(approximate='tanh') under torch autograd (tol 1); "
          f"log_softmax at {RTC_MLM} bf16 within {errs['log_softmax']:.3g} "
          f"ulp (tol 1)")
    if max(errs.values()) > 1:
        raise SystemExit("FAIL: an rtc kernel is beyond one bf16 ulp of its "
                         "plain version")
    del xs, ys, yg, loss

    # ---- timing: kernel, plain, one PyTorch call, bound ----
    n_ffn, n_mlm = xg.size, logits.size
    dy = wg.data
    F = torch.nn.functional
    timed = {
        "axpy": (lambda: rx.axpy(xp, yp),
                 lambda: rx.axpy_plain(xp.data, yp.data),
                 lambda: torch.add(yp.data, xp.data, alpha=2),
                 rtc_bound_ms(12 * n_params, 2, n_params),
                 "torch.add(y, x, alpha=2)", [n_params], "float32"),
        "gelu_tanh_fwd": (lambda: rx.gelu_tanh_fwd(xg),
                          lambda: rx.gelu_tanh_plain(xd),
                          lambda: F.gelu(xd, approximate="tanh"),
                          rtc_bound_ms(4 * n_ffn, 9, n_ffn),
                          "F.gelu(x, approximate='tanh')", list(RTC_FFN),
                          "bfloat16"),
        "gelu_tanh_bwd": (lambda: rx.gelu_tanh_bwd(xg, wg),
                          lambda: rx.gelu_tanh_grad_plain(xd, dy),
                          lambda: torch.ops.aten.gelu_backward(
                              dy, xd, approximate="tanh"),
                          rtc_bound_ms(6 * n_ffn, 18, n_ffn),
                          "aten.gelu_backward(dy, x, approximate='tanh')",
                          list(RTC_FFN), "bfloat16"),
        "log_softmax": (lambda: rx.log_softmax(logits),
                        lambda: rx.log_softmax_plain(logits.data),
                        lambda: torch.log_softmax(logits.data, -1),
                        rtc_bound_ms(4 * n_mlm, 6, n_mlm),
                        "torch.log_softmax(x, -1)", list(RTC_MLM),
                        "bfloat16"),
    }
    by_kernel = {}
    for name, (kern, pl, lib, bound, lib_name, shape, dt) in timed.items():
        ms = median_ms(kern, reps=RTC_REPS, warmup=RTC_WARMUP,
                       calls=TIMED_CALLS)
        plain_ms = median_ms(pl, reps=RTC_REPS, warmup=RTC_WARMUP,
                             calls=TIMED_CALLS)
        lib_ms = median_ms(lib, reps=RTC_REPS, warmup=RTC_WARMUP,
                           calls=TIMED_CALLS)
        # device times: the launches replayed from a CUDA graph of
        # TIMED_CALLS (no host work in the window)
        dev_ms, lib_dev_ms = graph_ms(kern), graph_ms(lib)
        bms, by, nbytes, _ = bound
        print(f"  {name} {shape} {dt}: kernel {ms:.4f} ms (graph "
              f"{dev_ms:.4f}), plain {plain_ms:.4f} ms, {lib_name} "
              f"{lib_ms:.4f} ms (graph {lib_dev_ms:.4f}), bound "
              f"{bms * 1e3:.1f} us ({by}: {nbytes / 1e6:.1f} MB), "
              f"{bms / dev_ms:.1%} of bound from the graph on {smi}")
        by_kernel[name] = {"launches": by_launches[name], "ms": ms,
                           "device_ms": dev_ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms,
                           "library_device_ms": lib_dev_ms,
                           "library": lib_name, "bound_ms": bms,
                           "bound_by": by, "max_abs_err": abs_err[name],
                           "shape": shape, "dtype": dt}

    # host cost of one launch (allocating form, 8 elements) beside torch.add
    host = {}
    for label, fn in (("rtc_launch_us", lambda: rx.axpy(x8, y8)),
                      ("torch_add_us",
                       lambda: torch.add(y8.data, x8.data, alpha=2))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RTC_LAUNCH_CALLS):
            fn()
        host[label] = (time.perf_counter() - t1) / RTC_LAUNCH_CALLS * 1e6
        torch.cuda.synchronize()
    print(f"  host cost of one CudaKernel.launch (axpy, 8 elements, output "
          f"allocated): {host['rtc_launch_us']:.2f} us; one torch.add: "
          f"{host['torch_add_us']:.2f} us (mean of {RTC_LAUNCH_CALLS} calls)")

    # NDArray and autograd on the card against the same calls on the CPU
    on_card, on_cpu = _imperative_cases(ctx), _imperative_cases(cpu())
    worst = 0.0
    for k, (a, dt, c) in on_card.items():
        b, dt_cpu, _ = on_cpu[k]
        if dt != dt_cpu or c != ctx or a.shape != b.shape:
            raise SystemExit(f"FAIL: NDArray case {k}: {dt} on {c} vs "
                             f"{dt_cpu} on the CPU")
        worst = max(worst, float(np.max(np.abs(a.astype(np.float64) - b)
                                        / np.maximum(1.0, np.abs(b)))))
    print(f"  NDArray/autograd on {ctx} vs cpu(): {len(on_card)} cases, "
          f"dtypes equal, max |d| / max(1, |cpu|) = {worst:.3g} (tol 1e-6: "
          f"f32 exp and sums in another order)")
    if worst > 1e-6:
        raise SystemExit("FAIL: NDArray on the card differs from the CPU")

    # median_ms's calls, then graph_ms's: one warm-up and the captured
    # calls (replays launch nothing from Python)
    per_timing = RTC_WARMUP + RTC_REPS * TIMED_CALLS + 1 + TIMED_CALLS
    expect_all = before_main + main_launches + len(timed) * per_timing + \
        10 + RTC_LAUNCH_CALLS
    made = before_main + rtc.launches       # the counter restarted at 0
    print(f"rtc launches over the phase: {made} (expected {expect_all})")
    if made != expect_all:
        raise SystemExit("FAIL: rtc.launches does not count every launch")
    return {"launches": main_launches, "compile_seconds": compile_s,
            "by_kernel": by_kernel, **host}


# ---------------------------------------------------------------------------
def lm_weights(seed: int):
    """Seeded weights for the generate slice's TransformerLM, named as the
    JAX package names them, drawn as the JAX package's generate test draws
    its (``mx.init.Normal(0.5)``): weights and embeddings N(0, 0.5^2),
    biases and LayerNorm beta 0, gamma 1. At 768 units every layer's
    attention is then nearly one-hot, so greedy tokens depend on the
    context, and any difference in rounding grows from layer to layer, so
    batched and serial decode agree only if they compute alike."""
    rng = np.random.default_rng(seed)
    named = {}
    for k, p in TransformerLM(**LM_CONFIG, device="meta").state_dict().items():
        if k.endswith("gamma"):
            named[k] = np.ones(p.shape, np.float32)
        elif k.endswith(("beta", "bias")):
            named[k] = np.zeros(p.shape, np.float32)
        else:
            named[k] = rng.standard_normal(p.shape, dtype=np.float32) \
                * np.float32(0.5)
    return named


def _lm(named, dtype=torch.float32):
    lm = TransformerLM(**LM_CONFIG)
    load_jax_params(lm, named)
    return lm.to(dtype)


def gen_prompts(seed: int, buckets):
    """GEN_SEQS prompts with lengths drawn from the seed in
    GEN_PROMPT_RANGE, in turn from each prefill bucket's share of it (so
    every bucket is exercised), tokens uniform over the vocabulary."""
    rng = np.random.default_rng(seed + 8)
    lo, hi = GEN_PROMPT_RANGE
    edges = [0] + list(buckets)
    ranges = [(max(lo, a + 1), min(hi, b)) for a, b in zip(edges, edges[1:])
              if max(lo, a + 1) <= min(hi, b)]
    lengths = [int(rng.integers(r[0], r[1] + 1)) for r in
               (ranges[i % len(ranges)] for i in range(GEN_SEQS))]
    return [rng.integers(0, LM_CONFIG["vocab_size"], n).tolist()
            for n in lengths]


def serial_decode(eng, prompt, max_new: int, sid: int):
    """One sequence at a time through ``eng`` (the JAX package's test
    oracle), returning its tokens and K1's launches during its prefill and
    during its decode steps."""
    eng.pool.reserve(sid, len(prompt) + max_new)
    n0 = fa.launches
    toks = [eng.prefill(prompt, eng.pool.table(sid))]
    n1 = fa.launches
    pos = len(prompt)
    for _ in range(max_new - 1):
        (t,) = eng.decode_step([(toks[-1], pos, eng.pool.table(sid))])
        toks.append(t)
        pos += 1
    eng.pool.free(sid)
    return toks, n1 - n0, fa.launches - n1


def first_step_logits(eng, rows):
    """The logits of one decode step of ``rows`` ((id, position, table)
    each) stepped together, as the engine's decode step computes them,
    without its scatter and argmax."""
    B = serving.bucketing.bucket_for(len(rows), eng.decode_buckets)
    with torch.inference_mode():
        dev = torch.from_numpy(eng._decode_host(rows)).to(eng.device)
        return eng._step_outputs(dev, B)[0][:len(rows)].float().cpu()


def k1_prefill_shapes(gen, buckets, smi: str):
    """K1 against its plain version at each prefill bucket's causal shape
    (1, 12, S, 64), bf16 and f32, on the split views of one QKV buffer;
    times at PREFILL_TIMED_SHAPES beside the plain version, SDPA's causal
    forward (a yardstick) and the causal bound."""
    H, D = LM_CONFIG["num_heads"], LM_CONFIG["units"] // LM_CONFIG["num_heads"]
    worst = 0.0
    for S in buckets:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = split_qkv((1, H, S, D), gen, dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5, True)
            ref, ref_lse = fa.flash_attention_fwd_reference(
                q, k, v, D ** -0.5, True)
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            print(f"kernel (1, {H}, {S}, {D}) {str(dtype)[6:]} causal "
                  f"(prefill bucket): max|d| {err:.3g} (tol {TOL[dtype]:g})")
            if err > TOL[dtype]:
                raise SystemExit(f"FAIL: K1 disagrees with its plain version "
                                 f"at the prefill shape S={S} {dtype}")
            worst = max(worst, err)
    timed = {}
    for shape in PREFILL_TIMED_SHAPES:
        q, k, v = split_qkv(shape, gen, torch.bfloat16)
        scale = shape[-1] ** -0.5

        def k1():
            return fa.flash_attention_fwd(q, k, v, scale, True)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)

        ms = median_ms(k1, calls=TIMED_CALLS)
        dev = graph_ms(k1)
        plain = median_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, scale, True), reps=20, warmup=2, calls=TIMED_CALLS)
        lib, lib_dev = median_ms(sdpa, calls=TIMED_CALLS), graph_ms(sdpa)
        bms, by, nbytes, flops = bound_ms(shape, torch.bfloat16, True)
        print(f"K1 causal {shape} bf16 on split views: {ms:.4f} ms through "
              f"the wrapper, {dev:.4f} ms from a CUDA graph of 10 calls; "
              f"plain {plain:.4f} ms; sdpa causal {lib:.4f} ms ({lib_dev:.4f}"
              f" ms from a graph); bound {bms * 1e3:.2f} us ({by}: "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), graph time "
              f"{bms / dev:.1%} of bound on {smi}")
        timed["x".join(map(str, shape))] = {
            "ms": ms, "device_ms": dev, "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev, "bound_ms": bms, "bound_by": by}
    return worst, timed


def time_buckets(eng, smi: str):
    """Each prefill bucket (a prompt of exactly its length) and each decode
    bucket (rows at position GEN_TIMED_POS) run GEN_TIMED_REPS times: the
    median host-clock ms of one call (each ends in a sync for its tokens)
    and the median CUDA-event ms around it."""
    def timed(fn):
        host, ev = [], []
        for _ in range(GEN_TIMED_REPS + 2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            b.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(a.elapsed_time(b))
        return {"host_ms": float(np.median(host[2:])),
                "event_ms": float(np.median(ev[2:]))}

    sids = range(60_000, 60_000 + eng.max_batch_size)
    for sid in sids:
        eng.pool.reserve(sid, eng.max_seq_len)
    tables = [eng.pool.table(sid) for sid in sids]
    prefill = {S: timed(lambda: eng.prefill(list(range(1, S + 1)), tables[0]))
               for S in eng.prefill_buckets}
    rows = [(7, GEN_TIMED_POS, t) for t in tables]
    decode = {B: timed(lambda: eng.decode_step(rows[:B]))
              for B in eng.decode_buckets}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = eng.decode_buckets[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(GEN_PROFILE_STEPS):
            eng.decode_step(rows[:B])
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3 \
        / GEN_PROFILE_STEPS
    for sid in sids:
        eng.pool.free(sid)
    for S, t in prefill.items():
        print(f"prefill bucket S={S}: {t['host_ms']:.3f} ms host clock, "
              f"{t['event_ms']:.3f} ms CUDA events (median of "
              f"{GEN_TIMED_REPS}) on {smi}")
    for b, t in decode.items():
        print(f"decode step bucket B={b} (products at {B} rows, context "
              f"{eng.max_seq_len} lanes): {t['host_ms']:.3f} ms host clock, "
              f"{t['event_ms']:.3f} ms CUDA events (median of "
              f"{GEN_TIMED_REPS}) on {smi}")
    busy = device_ms / decode[B]["host_ms"]
    print(f"decode step B={B}: {device_ms:.3f} ms of kernels per step "
          f"(torch.profiler, {GEN_PROFILE_STEPS} steps) in a "
          f"{decode[B]['host_ms']:.3f} ms step: device busy share "
          f"{busy:.3f} on {smi}")
    return {"prefill": prefill, "decode": decode,
            "decode_device_ms": device_ms, "decode_busy_share": busy}


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, |want|) over the values."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def f32_card_vs_cpu(seed: int, wide, prompt, smi: str):
    """One sequence in f32: prefill logits on the card (K1's f32 path)
    against the CPU (plain versions) within 1e-3 x max(1, |logit|), and the
    first GEN_F32_TOKENS greedy tokens of both engines equal. The weights
    are the repo's BERT recipe (``seeded_bert_weights``: matrices
    N(0, 1/fan_in), embeddings N(0, 1)): under the generate phase's wide
    init (``wide``) the 12 layers' sharp attention amplifies f32 rounding
    without bound, so that no two f32 orders of summation agree to 1e-3;
    the CPU's own f32 prefill against its f64 one shows it (printed)."""
    named = seeded_bert_weights(TransformerLM(**LM_CONFIG, device="meta"),
                                seed)
    cpu_lm, gpu_lm = _lm(named), _lm(named).cuda()
    wide32, wide64 = _lm(wide), _lm(wide, torch.float64)
    tok = torch.tensor([prompt])
    with torch.inference_mode():
        err = _rel_err(gpu_lm.prefill_collect(tok.cuda())[0],
                       cpu_lm.prefill_collect(tok)[0])
        chaos = _rel_err(wide32.prefill_collect(tok)[0],
                         wide64.prefill_collect(tok)[0])
    del wide32, wide64
    kw = dict(max_seq_len=GEN_ENGINE["max_seq_len"],
              max_batch_size=GEN_ENGINE["max_batch_size"],
              page_size=GEN_ENGINE["page_size"], num_pages=GEN_F32_PAGES)
    cpu_toks = serial_decode(DecodeEndpoint("lm_cpu", cpu_lm, ctx=cpu(), **kw),
                             prompt, GEN_F32_TOKENS, 1)[0]
    gpu_toks = serial_decode(DecodeEndpoint("lm_f32", gpu_lm, **kw),
                             prompt, GEN_F32_TOKENS, 1)[0]
    print(f"f32 card vs CPU plain, prompt of {len(prompt)}: prefill logits "
          f"max |d| / max(1, |logit|) = {err:.3g} (tol 1e-3); first "
          f"{GEN_F32_TOKENS} greedy tokens card {gpu_toks}, CPU {cpu_toks} "
          f"on {smi}. Under the wide init the CPU's f32 prefill logits lie "
          f"{chaos:.3g} x max(1, |logit|) from its f64 ones")
    if err > 1e-3 or gpu_toks != cpu_toks:
        raise SystemExit("FAIL: the f32 generate path on the card disagrees "
                         "with the CPU")
    return err


def phase_generate(seed: int, smi: str):
    """The generate slice (phase 7): TransformerLM at BERT-base width in
    bf16 behind an InferenceServer's generator, 4 clients, 24 sequences."""
    named = lm_weights(seed)
    lm = _lm(named, torch.bfloat16)
    layers = LM_CONFIG["num_layers"]

    # ---- the main path: counts from 0 just before, read just after ----
    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # by earlier phases
    eng = DecodeEndpoint("lm", lm, **GEN_ENGINE)
    server = serving.InferenceServer()
    t0 = time.perf_counter()
    server.register_generator(eng, warmup=True,
                              tenants={GEN_TENANT: GEN_TENANT_SLO_MS})
    warm_s = time.perf_counter() - t0
    warm_launches = fa.launches
    server.start()
    prompts = gen_prompts(seed, eng.prefill_buckets)
    results, errors = {}, []

    def client(c):
        rng = np.random.default_rng(seed * 100 + c)
        mine = []
        try:
            for i in range(c, GEN_SEQS, GEN_CLIENTS):
                tenant = GEN_TENANT if i % 2 else "default"
                stamps = []
                t_sub = time.perf_counter()
                s = server.generate(
                    "lm", prompts[i], max_new_tokens=GEN_NEW_TOKENS,
                    tenant=tenant,
                    on_token=lambda _, st=stamps: st.append(
                        time.perf_counter()))
                mine.append((i, tenant, t_sub, stamps, s))
                time.sleep(float(rng.uniform(0.0, 0.02)))
            for i, tenant, t_sub, stamps, s in mine:
                results[i] = (tenant, t_sub, stamps, s.result(timeout=600))
        except Exception as e:        # surfaced below; the phase fails
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(GEN_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    server.stop(drain=True)
    gen_launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path ----

    if errors or any(t.is_alive() for t in threads) or \
            len(results) != GEN_SEQS:
        raise SystemExit(f"FAIL: generate clients: {errors[:3]}")
    snap = eng.snapshot()
    c = snap["stats"]["counters"]
    n_warm = len(eng.prefill_buckets)
    print(f"generate: {len(eng.prefill_buckets)} prefill + "
          f"{len(eng.decode_buckets)} decode buckets warmed in {warm_s:.1f} s "
          f"(K1 launches {warm_launches} = {layers} x {n_warm}); "
          f"{GEN_SEQS} sequences, {c['tokens']} tokens, {c['steps']} decode "
          f"steps; K1 launches {gen_launches} (expected {layers} x "
          f"({n_warm} + {GEN_SEQS}) = {layers * (n_warm + GEN_SEQS)})")
    short = [i for i, r in results.items() if len(r[3]) != GEN_NEW_TOKENS]
    if short:
        raise SystemExit(f"FAIL: streams {short} did not yield exactly "
                         f"{GEN_NEW_TOKENS} tokens")
    if warm_launches != layers * n_warm or \
            gen_launches != layers * (n_warm + GEN_SEQS):
        raise SystemExit("FAIL: K1 launches do not match one per layer per "
                         "prefill")

    # the same prompts, serially through the same engine
    serial, d_prefill, d_decode = [], set(), set()
    for i, p in enumerate(prompts):
        toks, dp, dd = serial_decode(eng, p, GEN_NEW_TOKENS, 20_000 + i)
        serial.append(toks)
        d_prefill.add(dp)
        d_decode.add(dd)
    print(f"serial decode: K1 launches per prefill {sorted(d_prefill)}, per "
          f"sequence's {GEN_NEW_TOKENS - 1} decode steps {sorted(d_decode)}")
    if d_prefill != {layers} or d_decode != {0}:
        raise SystemExit("FAIL: K1 launched other than 12 times per prefill "
                         "and 0 times per decode step")
    batched = [results[i][3] for i in range(GEN_SEQS)]
    diverge = [(i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
               for i, (x, y) in enumerate(zip(batched, serial)) if x != y]
    bitwise = not diverge
    print(f"batched continuous decode == serial decode, token lists bitwise "
          f"equal: {bitwise} ({len(diverge)} of {GEN_SEQS} differ; first "
          f"diverging token (sequence, index): {diverge[:6]}); distinct "
          f"tokens per sequence {sorted(len(set(t)) for t in serial)}")
    if max(len(set(t)) for t in serial) <= 2:
        raise SystemExit("FAIL: greedy tokens do not depend on the context")

    # each row's first-step logits: alone (bucket 1) and stepped with the
    # others (the top bucket)
    sids = range(30_000, 30_000 + eng.max_batch_size)
    rows = []
    for sid, p in zip(sids, prompts):
        eng.pool.reserve(sid, len(p) + GEN_NEW_TOKENS)
        rows.append((eng.prefill(p, eng.pool.table(sid)), len(p),
                     eng.pool.table(sid)))
    together = first_step_logits(eng, rows)
    alone = torch.cat([first_step_logits(eng, [r]) for r in rows])
    for sid in sids:
        eng.pool.free(sid)
    d_logit = (together - alone).abs().max().item()
    same = torch.equal(together, alone)
    print(f"first-step logits of {len(rows)} rows, bucket {len(rows)} vs "
          f"bucket 1: bitwise equal {same}, max |dlogit| {d_logit:.4g}")
    if not (bitwise and same):
        raise SystemExit("FAIL: batched decode is not bitwise equal to "
                         "serial decode")

    ttft = [(r[2][0] - r[1]) * 1e3 for r in results.values()]
    gaps = {}
    for tenant, _, stamps, _ in results.values():
        gaps.setdefault(tenant, []).extend(np.diff(stamps) * 1e3)
    tokens = sum(len(r[3]) for r in results.values())
    print(f"generate {LM_CONFIG['num_layers']} x {LM_CONFIG['units']} bf16, "
          f"{GEN_CLIENTS} clients x {GEN_SEQS // GEN_CLIENTS} sequences, "
          f"prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens, {GEN_NEW_TOKENS} new each: {tokens / wall:.1f} tokens/s "
          f"(wall {wall:.2f} s); time to first token p50 "
          f"{np.percentile(ttft, 50):.1f} ms, p99 "
          f"{np.percentile(ttft, 99):.1f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB of it held "
          f"before the phase) on {smi}")
    for tenant, g in sorted(gaps.items()):
        print(f"  inter-token, tenant {tenant!r}: p50 "
              f"{np.percentile(g, 50):.2f} ms, p99 {np.percentile(g, 99):.2f}"
              f" ms over {len(g)} gaps")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    k1_err, k1_timed = k1_prefill_shapes(gen, eng.prefill_buckets, smi)
    buckets = time_buckets(eng, smi)
    f32_err = f32_card_vs_cpu(seed, named, prompts[2][:GEN_F32_PROMPT], smi)
    return {"launches": gen_launches, "k1_max_abs_err": k1_err,
            "k1_timed": k1_timed, "bitwise": bitwise, "diverge": diverge,
            "max_dlogit": d_logit, "tokens_per_s": tokens / wall,
            "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                        "p99": float(np.percentile(ttft, 99))},
            "intertoken_ms": {t: {"p50": float(np.percentile(g, 50)),
                                  "p99": float(np.percentile(g, 99))}
                              for t, g in gaps.items()},
            "peak_bytes": peak, "held_bytes": held, "f32_err": f32_err,
            **buckets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    smi = card()
    phase_environment(smi)
    record = phase_kernel(args.seed, smi)
    bwd = phase_backward(args.seed, smi)
    k4 = phase_fused_conv(args.seed, smi)
    serve_launches = phase_slice(args.seed, smi)
    train_launches = phase_train(args.seed, smi)
    resnet = phase_resnet(args.seed, smi)
    k5 = phase_rtc(args.seed, smi)
    gen = phase_generate(args.seed, smi)
    r, tr = record["serving", torch.bfloat16], record["training", torch.bfloat16]
    pallas = "mxnet_tpu/ops/pallas/flash_attention.py"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": f"{pallas}:213",
         "launches": serve_launches + train_launches["flash_attention_fwd"]
         + gen["launches"],
         "launches_by_path": {
             "serving": serve_launches,
             "training": train_launches["flash_attention_fwd"],
             "generate": gen["launches"]},
         "max_abs_err": max(r["max_abs_err"], tr["max_abs_err"],
                            gen["k1_max_abs_err"]),
         "ms": r["ms"], "ms_strided": r["ms_strided"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "library": "scaled_dot_product_attention forward",
         "shape": list(BERT_SHAPE), "dtype": "bfloat16",
         "ms_training_shape": tr["ms"],
         "ms_strided_training_shape": tr["ms_strided"],
         "plain_ms_training_shape": tr["plain_ms"],
         "bound_ms_training_shape": tr["bound_ms"],
         "library_ms_training_shape": tr["library_ms"],
         "device_ms": r["device_ms"],
         "library_device_ms": r["library_device_ms"],
         "device_ms_training_shape": tr["device_ms"],
         "library_device_ms_training_shape": tr["library_device_ms"],
         "causal_prefill": gen["k1_timed"],
         "host_us": record["host_us"]["k1"],
         "entry_host_us": record["host_us"]["entry"],
         "library_host_us": record["host_us"]["sdpa"]}]
    for name, wrapper, line in (("dq", "flash_attention_bwd_dq", 403),
                                ("dkv", "flash_attention_bwd_dkv", 421)):
        t, sv = bwd["training"], bwd["serving"]
        kernels.append({
            "name": wrapper, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"{pallas}:{line}",
            "launches": train_launches[wrapper],
            "max_abs_err": bwd[f"{name}_err"], "ms": t[name]["ms"],
            "device_ms": t[name]["device_ms"],
            "plain_ms": t[name]["plain_ms"],
            "plain": f"{wrapper}_reference",
            "bound_ms": t[name]["bound_ms"], "bound_by": t[name]["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "library": "scaled_dot_product_attention backward (dq, dk, dv "
                       "together)",
            "shape": list(TRAIN_SHAPE), "dtype": "bfloat16",
            "backward_ms": t["bwd"]["ms"],
            "backward_device_ms": t["bwd"]["device_ms"],
            "backward_bound_ms": t["bwd"]["bound_ms"],
            "ms_serving_shape": sv[name]["ms"],
            "device_ms_serving_shape": sv[name]["device_ms"],
            "plain_ms_serving_shape": sv[name]["plain_ms"],
            "bound_ms_serving_shape": sv[name]["bound_ms"],
            "library_ms_serving_shape": sv["library_ms"],
            "library_device_ms_serving_shape": sv["library_device_ms"]})
    s2 = k4["shapes"]["s2_reduce"]
    kernels.append({
        "name": "conv1x1_bn_act", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/fused_conv1x1.cu",
        "replaces": "mxnet_tpu/ops/pallas/fused_conv1x1.py:84",
        "launches": resnet["k4_launches"] + resnet["train_launches"],
        "launches_by_path": {"resnet50_training":
                             resnet["train_launches"],
                             "resnet50_bottleneck_sites":
                             resnet["k4_launches"]},
        "max_abs_err": k4["max_abs_err"], "ms": s2["ms"],
        "device_ms": s2["device_ms"], "plain_ms": s2["plain_ms"],
        "bound_ms": s2["bound_ms"], "bound_by": s2["bound_by"],
        "library_ms": s2["library_ms"],
        "library_device_ms": s2["library_device_ms"],
        "library": "torch.matmul of the pre-activated bf16 x with w (the "
                   "product alone)",
        "composition_ms": s2["composition_ms"],
        "composition_device_ms": s2["composition_device_ms"],
        "composition": "relu(addcmul(shift, x, scale)) to bf16, torch.mm "
                       "with an f32 result, y to bf16, column sums of y "
                       "and y^2 (tools/k4_compare.py)",
        "shape": [s2["M"], s2["K"], s2["N"]], "dtype": "bfloat16",
        "by_shape": k4["shapes"]})
    head = k5["by_kernel"]["gelu_tanh_fwd"]   # the differentiable path's
    kernels.append({
        "name": "rtc", "route": "cuda", "source": "mxnet_tpu_torch/rtc.py",
        "kernel_sources": sorted(f"mxnet_tpu_torch/csrc/rtc/{f}"
                                 for f in set(rx.SOURCES.values())),
        "replaces": "mxnet_tpu/rtc.py:64", "launches": k5["launches"],
        "max_abs_err": max(v["max_abs_err"]
                           for v in k5["by_kernel"].values()),
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_device_ms": head["library_device_ms"],
        "headline": "gelu_tanh_fwd",
        "compile_seconds": k5["compile_seconds"],
        "launch_host_us": k5["rtc_launch_us"],
        "torch_add_host_us": k5["torch_add_us"],
        "by_kernel": k5["by_kernel"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
