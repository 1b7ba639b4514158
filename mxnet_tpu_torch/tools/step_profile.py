"""Where the time of one BERT-base or ResNet-50 step goes on the card.

    python3 -m mxnet_tpu_torch.tools.step_profile [--bucket 32] [--seed 0]
    python3 -m mxnet_tpu_torch.tools.step_profile --train [--seed 0]
    python3 -m mxnet_tpu_torch.tools.step_profile --resnet [--seed 0]

Serving (default): builds ``bert_base()`` in bf16 with seeded random weights
on ``gpu(0)`` and runs the endpoint's forward at one batch bucket of
512-token rows (the step ``ModelEndpoint.execute`` runs).

``--train``: one pretraining step of ``BERTForPretraining(bert_base(
max_length=128))`` through ``ParallelTrainStep`` (bf16 compute over f32
masters, Adam, dropout 0.1) at batch 64 x 128 with 19 masked positions, the
step ``chip_smoke.py`` phase 4 runs.

``--resnet``: one training step of ``resnet50_v1(classes=1000)`` through
``ParallelTrainStep`` (bf16 compute over f32 masters, SGD with momentum 0.9,
``SoftmaxCrossEntropyLoss``) at batch 32 x 3 x 224 x 224, the step
``chip_smoke.py`` phase 5 runs. Its kernels are grouped by the host op
that launched them: convolution forward (``aten::convolution``) and
backward (``aten::convolution_backward``), cuDNN's layout transforms
included; the Dense layer's product; pooling and the loss; the SGD update
(under ``mxt.optimizer``); and everything else (BatchNorm and ReLU
elementwise work, reductions and casts). The device idle share is the rest
of the step.

Reports:

- the step's wall time (serving: CUDA events, median of 10 after warm-up;
  training: host clock to a fetched loss, median of 10);
- from ``torch.profiler`` over a few steps: device time per kernel, grouped
  as the flash-attention kernels (K1 forward; K2 dq and K3 dk/dv in
  training), matrix products (cuBLAS/CUTLASS kernels), the optimizer
  (kernels under the train step's ``mxt.optimizer`` range) and everything
  else (elementwise, reductions, dropout masks, dtype and layout copies),
  the top kernels by time, the layout copies (kernels launched under
  ``aten::contiguous`` or a copying ``aten::reshape``), and the device busy
  share (kernel time over wall time);
- ``--train`` also: the device time and kernel count of attention's
  backward, every kernel launched inside the ``FlashAttentionBackward``
  autograd node (K2, K3, and whatever the backward runs around them).

Prints the result as one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import (PretrainStep, card, median_ms, pretrain_batch, resnet_batch,
               resnet_train_step, seeded_bert_weights, seeded_resnet_weights)

_MATMUL_MARKS = ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_",
                 "matmul")
_KERNELS = (("flash_bwd_dq", "K2 flash_attention_bwd_dq"),
            ("flash_bwd_dkv", "K3 flash_attention_bwd_dkv"),
            ("flash_fwd", "K1 flash_attention_fwd"))
_OPTIMIZER_RANGE = "mxt.optimizer"
_LAYOUT_OPS = ("aten::contiguous", "aten::reshape")
_ATTENTION_BACKWARD = "FlashAttentionBackward"


# ResNet-50's classes, by the host op that launched each kernel: (class,
# test on the op's name)
_RESNET_OPS = (
    ("conv forward (cuDNN, with its layout transforms)",
     lambda n: n == "aten::convolution"),
    ("conv backward (cuDNN, with its layout transforms)",
     lambda n: n == "aten::convolution_backward"),
    ("matmul (the Dense layer)", lambda n: n in ("aten::addmm", "aten::mm")),
    ("pooling and loss", lambda n: any(
        m in n for m in ("max_pool2d", "log_softmax", "gather"))))
_RESNET_OTHER = "other: BatchNorm/ReLU elementwise, reductions, casts"


def _category(name: str) -> str:
    n = name.lower()
    for mark, cat in _KERNELS:
        if mark in n:
            return cat
    if any(m in n for m in _MATMUL_MARKS):
        return "matmul"
    return "other"


def _kernels_under(events, match, skip: str = ""):
    """(count, device ms) of the kernels launched inside any host op whose
    name passes ``match`` (or inside its children), each kernel counted
    once; kernels named ``skip`` (a range's own annotation) are left out."""
    from torch.autograd import DeviceType

    seen = {}
    stack = [e for e in events
             if e.device_type == DeviceType.CPU and match(e.name)]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            if k.name != skip:
                seen[id(k)] = k.duration
        stack.extend(e.cpu_children)
    return len(seen), sum(seen.values()) / 1e3



def _range_ms(events, name):
    """(kernel ms, device window ms) under the host range ``name``: the
    device time of the kernels launched inside it, and the span of its
    annotation on the device timeline (first kernel start to last end)."""
    from torch.autograd import DeviceType

    window_us = sum(e.device_time_total for e in events
                    if e.name == name and e.device_type == DeviceType.CUDA)
    return _kernels_under(events, lambda n: n == name, skip=name)[1], \
        window_us / 1e3


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

    times = _host_times(step)
    desc = (f"BERTForPretraining(bert_base) bf16 training step, batch "
            f"{batch} x {seq}, P={n_pred}, Adam, dropout 0.1")
    return step, float(np.median(times)), desc, \
        {"batch": batch, "seq": seq, "masked": n_pred}


def _resnet_step(args):
    from ..gluon.model_zoo.vision import resnet50_v1

    batch = 32
    named = seeded_resnet_weights(resnet50_v1(classes=1000, device="meta"),
                                  args.seed)
    ts = resnet_train_step(named, "bfloat16")
    xs, ys = ts.place_batch_n(*resnet_batch(
        np.random.default_rng(args.seed), 1, batch))
    x, y = xs[0].to(torch.bfloat16), ys[0]

    def step():
        return ts(x, y)

    times = _host_times(step)
    desc = (f"resnet50_v1 bf16 training step, batch {batch} x 3 x 224 x 224,"
            f" SGD momentum 0.9")
    return step, float(np.median(times)), desc, {"batch": batch}


def _host_times(step, warmup: int = 3, reps: int = 10):
    """Host-clock ms of ``reps`` steps, each closed by fetching its loss,
    after ``warmup`` untimed ones."""
    for _ in range(warmup):
        step().item()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step().item()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile one BERT pretraining step")
    mode.add_argument("--resnet", action="store_true",
                      help="profile one ResNet-50 training step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda import flash_attention as fa

    smi = card()
    training = args.train or args.resnet
    step, step_ms, desc, shape = (_resnet_step if args.resnet else
                                  _train_step if args.train
                                  else _serving_step)(args)

    n_steps = 3 if training else 5
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
    events = prof.events()
    if args.resnet:
        by_cat = {c: _kernels_under(events, match)[1]
                  for c, match in _RESNET_OPS}
        other = _RESNET_OTHER
        by_cat[other] = sum(e.self_device_time_total for e in kernels) \
            / 1e3 - sum(by_cat.values())
    else:
        other, by_cat = "other", {}
        for e in kernels:
            c = _category(e.key)
            by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total / 1e3
    # the optimizer's kernels are elementwise: move them out of "other"
    opt_ms, opt_window_ms = _range_ms(events, _OPTIMIZER_RANGE)
    if opt_ms:
        name = "SGD" if args.resnet else "Adam"
        by_cat[f"optimizer ({name}, under mxt.optimizer)"] = opt_ms
        by_cat[other] = by_cat.get(other, 0.0) - opt_ms
    per_step = {c: ms / n_steps for c, ms in by_cat.items()}
    # layout copies: what .contiguous() and a copying reshape launch (the
    # attention's q, k, v and output went through them before K1 took views)
    n_copies, copies_ms = _kernels_under(events, _LAYOUT_OPS.__contains__)
    n_attn_bwd, attn_bwd_ms = _kernels_under(
        events, lambda n: _ATTENTION_BACKWARD in n)
    device_ms = sum(per_step.values())
    if training:
        per_step["device idle"] = max(0.0, step_ms - device_ms)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[
        :25 if args.resnet else 12]
    print(f"card: {smi}")
    print(f"{desc}: step {step_ms:.3f} ms (median of 10); profiled device "
          f"time {device_ms:.3f} ms/step, busy share "
          f"{device_ms / step_ms:.3f}; launches per step K1 {launches[0]:.0f}"
          f", K2 {launches[1]:.0f}, K3 {launches[2]:.0f}")
    for c, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        print(f"  {c:40s} {ms:8.3f} ms/step  {ms / step_ms:6.1%} of step")
    print(f"  layout copies (kernels under {' / '.join(_LAYOUT_OPS)}): "
          f"{n_copies / n_steps:.0f} per step, {copies_ms / n_steps:.3f} "
          f"ms/step (inside the classes above)")
    if args.train:
        print(f"  attention backward (kernels under {_ATTENTION_BACKWARD}): "
              f"{n_attn_bwd / n_steps:.0f} kernels, "
              f"{attn_bwd_ms / n_steps:.3f} ms/step")
    if opt_window_ms:
        print(f"  optimizer window on the device {opt_window_ms / n_steps:.3f}"
              f" ms/step for {opt_ms / n_steps:.3f} ms of kernels (the rest "
              "is the device waiting for the host's launches)")
    for e in top:
        print(f"  top: {e.self_device_time_total / 1e3 / n_steps:8.3f} "
              f"ms/step  x{e.count // n_steps:<4d} {e.key[:90]}")
    result = {"card": smi, "mode": "resnet" if args.resnet else
              "train" if args.train else "serve",
              **shape, "step_ms": step_ms, "device_ms": device_ms,
              "busy_share": device_ms / step_ms,
              "ms_per_step": per_step,
              "optimizer_window_ms": opt_window_ms / n_steps,
              "launches_per_step": dict(zip(("K1", "K2", "K3"), launches)),
              "layout_copies_per_step": n_copies / n_steps,
              "layout_copies_ms_per_step": copies_ms / n_steps,
              "attention_backward_kernels_per_step": n_attn_bwd / n_steps,
              "attention_backward_ms_per_step": attn_bwd_ms / n_steps,
              "top": [{"kernel": e.key,
                       "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                       "calls_per_step": e.count / n_steps} for e in top]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
