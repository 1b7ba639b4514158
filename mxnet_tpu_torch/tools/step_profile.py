"""Where the time of one BERT-base step goes on the card.

    python3 -m mxnet_tpu_torch.tools.step_profile [--bucket 32] [--seed 0]
    python3 -m mxnet_tpu_torch.tools.step_profile --train [--seed 0]

Serving (default): builds ``bert_base()`` in bf16 with seeded random weights
on ``gpu(0)`` and runs the endpoint's forward at one batch bucket of
512-token rows (the step ``ModelEndpoint.execute`` runs).

``--train``: one pretraining step of ``BERTForPretraining(bert_base(
max_length=128))`` through ``ParallelTrainStep`` (bf16 compute over f32
masters, Adam, dropout 0.1) at batch 64 x 128 with 19 masked positions, the
step ``chip_smoke.py`` phase 4 runs.

Reports:

- the step's wall time (serving: CUDA events, median of 10 after warm-up;
  training: host clock to a fetched loss, median of 10);
- from ``torch.profiler`` over a few steps: device time per kernel, grouped
  as the flash-attention kernels (K1 forward; K2 dq and K3 dk/dv in
  training), matrix products (cuBLAS/CUTLASS kernels), the optimizer
  (kernels under the train step's ``mxt.optimizer`` range) and everything
  else (elementwise, reductions, dropout masks, dtype and layout copies),
  the top kernels by time, and the device busy share (kernel time over wall
  time).

Prints the result as one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import (PretrainStep, card, median_ms, pretrain_batch,
               seeded_bert_weights)

_MATMUL_MARKS = ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_",
                 "matmul")
_KERNELS = (("flash_bwd_dq", "K2 flash_attention_bwd_dq"),
            ("flash_bwd_dkv", "K3 flash_attention_bwd_dkv"),
            ("flash_fwd", "K1 flash_attention_fwd"))
_OPTIMIZER_RANGE = "mxt.optimizer"


def _category(name: str) -> str:
    n = name.lower()
    for mark, cat in _KERNELS:
        if mark in n:
            return cat
    if any(m in n for m in _MATMUL_MARKS):
        return "matmul"
    return "other"


def _range_ms(events, name):
    """(kernel ms, device window ms) under the host range ``name``: the
    device time of the kernels launched inside it, and the span of its
    annotation on the device timeline (first kernel start to last end)."""
    from torch.autograd import DeviceType

    kernel_us = window_us = 0.0
    stack = [e for e in events if e.name == name
             and e.device_type == DeviceType.CPU]
    for e in events:
        if e.name == name and e.device_type == DeviceType.CUDA:
            window_us += e.device_time_total
    while stack:
        e = stack.pop()
        kernel_us += sum(k.duration for k in e.kernels if k.name != name)
        stack.extend(e.cpu_children)
    return kernel_us / 1e3, window_us / 1e3


def _serving_step(args):
    from ..gluon.model_zoo.bert import bert_base, load_jax_params

    net = bert_base()
    load_jax_params(net, seeded_bert_weights(net, args.seed))
    net = net.to("cuda", torch.bfloat16).eval()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    tok = torch.randint(0, 30522, (args.bucket, 512), generator=g,
                        device="cuda", dtype=torch.int32)
    typ = torch.randint(0, 2, (args.bucket, 512), generator=g, device="cuda",
                        dtype=torch.int32)

    def step():
        with torch.inference_mode():
            return net(tok, typ)

    desc = f"bert_base bf16 serving, bucket {args.bucket} x 512 tokens"
    return step, median_ms(step, reps=10, warmup=3), desc, \
        {"bucket": args.bucket, "seq": 512}


def _train_step(args):
    from ..gluon.model_zoo.bert import (BERTForPretraining,
                                        BERTPretrainingLoss, bert_base,
                                        load_jax_params)
    from ..optimizer import Adam
    from ..parallel import ParallelTrainStep, make_mesh

    batch, seq, n_pred = 64, 128, 19
    model = BERTForPretraining(bert_base(max_length=seq))
    load_jax_params(model, seeded_bert_weights(model, args.seed))
    ts = ParallelTrainStep(PretrainStep(model), BERTPretrainingLoss(),
                           Adam(learning_rate=1e-4), make_mesh({"dp": 1}),
                           compute_dtype="bfloat16",
                           extra_specs=("dp", "dp"), seed=args.seed)
    toks, (mlm, nsp), tt, pos = ts.place_batch_n(*pretrain_batch(
        np.random.default_rng(args.seed), 1, batch, seq, n_pred))
    x, y, tt, pos = toks[0], (mlm[0], nsp[0]), tt[0], pos[0]

    def step():
        return ts(x, y, tt, pos)

    for _ in range(3):
        step().item()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step().item()
        times.append((time.perf_counter() - t0) * 1e3)
    desc = (f"BERTForPretraining(bert_base) bf16 training step, batch "
            f"{batch} x {seq}, P={n_pred}, Adam, dropout 0.1")
    return step, float(np.median(times)), desc, \
        {"batch": batch, "seq": seq, "masked": n_pred}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile one pretraining step instead of serving")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda import flash_attention as fa

    smi = card()
    step, step_ms, desc, shape = (_train_step if args.train
                                  else _serving_step)(args)

    n_steps = 3 if args.train else 5
    counts0 = (fa.launches, fa.launches_dq, fa.launches_dkv)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    launches = [(b - a) / n_steps for a, b in
                zip(counts0, (fa.launches, fa.launches_dq, fa.launches_dkv))]
    # the optimizer's range also appears on the device timeline, as an
    # annotation spanning its kernels: keep it out of the kernel sums
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and e.key != _OPTIMIZER_RANGE]
    by_cat = {}
    for e in kernels:
        c = _category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total / 1e3
    # the optimizer's kernels are elementwise: move them out of "other"
    opt_ms, opt_window_ms = _range_ms(prof.events(), _OPTIMIZER_RANGE)
    if opt_ms:
        by_cat["optimizer (Adam, under mxt.optimizer)"] = opt_ms
        by_cat["other"] = by_cat.get("other", 0.0) - opt_ms
    per_step = {c: ms / n_steps for c, ms in by_cat.items()}
    device_ms = sum(per_step.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(f"card: {smi}")
    print(f"{desc}: step {step_ms:.3f} ms (median of 10); profiled device "
          f"time {device_ms:.3f} ms/step, busy share "
          f"{device_ms / step_ms:.3f}; launches per step K1 {launches[0]:.0f}"
          f", K2 {launches[1]:.0f}, K3 {launches[2]:.0f}")
    for c, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        print(f"  {c:40s} {ms:8.3f} ms/step  {ms / step_ms:6.1%} of step")
    if opt_window_ms:
        print(f"  optimizer window on the device {opt_window_ms / n_steps:.3f}"
              f" ms/step for {opt_ms / n_steps:.3f} ms of kernels (the rest "
              "is the device waiting for the host's launches)")
    for e in top:
        print(f"  top: {e.self_device_time_total / 1e3 / n_steps:8.3f} "
              f"ms/step  x{e.count // n_steps:<4d} {e.key[:90]}")
    result = {"card": smi, "mode": "train" if args.train else "serve",
              **shape, "step_ms": step_ms, "device_ms": device_ms,
              "busy_share": device_ms / step_ms,
              "ms_per_step": per_step,
              "optimizer_window_ms": opt_window_ms / n_steps,
              "launches_per_step": dict(zip(("K1", "K2", "K3"), launches)),
              "top": [{"kernel": e.key,
                       "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                       "calls_per_step": e.count / n_steps} for e in top]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
