"""Where the time of one served BERT-base step goes on the card.

    python3 -m mxnet_tpu_torch.tools.step_profile [--bucket 32] [--seed 0]

Builds ``bert_base()`` in bf16 with seeded random weights on ``gpu(0)``, runs
the endpoint's forward at one batch bucket of 512-token rows (the step
``ModelEndpoint.execute`` runs), and reports:

- the step's wall time (CUDA events, median of 10 after warm-up);
- from ``torch.profiler`` over 5 steps: device time per kernel, grouped as
  the flash-attention kernel, matrix products (cuBLAS/CUTLASS kernels) and
  everything else (elementwise, reductions, layout copies), the top kernels
  by time, and the device busy share (kernel time over wall time).

Prints the result as one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import card, median_ms, seeded_bert_weights

_MATMUL_MARKS = ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_",
                 "matmul")


def _category(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention_fwd"
    if any(m in n for m in _MATMUL_MARKS):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bucket", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..gluon.model_zoo.bert import bert_base, load_jax_params
    from ..ops.cuda import flash_attention as fa

    smi = card()
    net = bert_base()
    named = seeded_bert_weights(net, args.seed)
    load_jax_params(net, named)
    net = net.to("cuda", torch.bfloat16).eval()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    tok = torch.randint(0, 30522, (args.bucket, 512), generator=g,
                        device="cuda", dtype=torch.int32)
    typ = torch.randint(0, 2, (args.bucket, 512), generator=g, device="cuda",
                        dtype=torch.int32)

    def step():
        with torch.inference_mode():
            return net(tok, typ)

    step_ms = median_ms(step, reps=10, warmup=3)

    n_steps = 5
    launches0 = fa.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    kernel_launches = fa.launches - launches0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    by_cat = {}
    for e in kernels:
        c = _category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total / 1e3
    per_step = {c: ms / n_steps for c, ms in by_cat.items()}
    device_ms = sum(per_step.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    print(f"card: {smi}")
    print(f"bert_base bf16, bucket {args.bucket} x 512 tokens: step "
          f"{step_ms:.3f} ms (CUDA events, median of 10); profiled device "
          f"time {device_ms:.3f} ms/step, busy share "
          f"{device_ms / step_ms:.3f}; flash kernel launches "
          f"{kernel_launches / n_steps:.0f}/step")
    for c, ms in sorted(per_step.items(), key=lambda kv: -kv[1]):
        print(f"  {c:22s} {ms:8.3f} ms/step  {ms / step_ms:6.1%} of step")
    for e in top:
        print(f"  top: {e.self_device_time_total / 1e3 / n_steps:8.3f} "
              f"ms/step  x{e.count // n_steps:<4d} {e.key[:90]}")
    result = {"card": smi, "bucket": args.bucket, "seq": 512,
              "step_ms": step_ms, "device_ms": device_ms,
              "busy_share": device_ms / step_ms,
              "ms_per_step": per_step,
              "flash_launches_per_step": kernel_launches / n_steps,
              "top": [{"kernel": e.key,
                       "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                       "calls_per_step": e.count / n_steps} for e in top]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
