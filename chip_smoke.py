#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, nvcc and the repository checkout; it imports neither
JAX nor the JAX package. Phases (any failure exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi), the CUDA and
   PyTorch versions, nvcc's version; builds the flash-attention kernel from
   ``mxnet_tpu_torch/csrc`` and prints the build time and ptxas report.
2. Kernel against its plain version: ``flash_attention_fwd`` (O and LSE)
   against ``flash_attention_fwd_reference`` on the card at every listed
   shape, f32 within 1e-4 (sum order only) and bf16 within 2e-2 (P is
   rounded to bf16; one bf16 ulp near 1 is 7.8e-3). At the BERT-base shape
   it times the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only;
   the port never calls it) with CUDA events, median of 30 after warm-up,
   and prints the bound (bytes over 3.35 TB/s against operations over the
   peak for the type).
3. The slice: ``bert_base()`` at full width with seeded random weights,
   cast to bf16, served by ``ModelEndpoint`` + ``InferenceServer`` to 8
   client threads sending 96 requests of 1-8 rows of 512 tokens. Checks:
   every response is on the card and equals the direct forward of the same
   rows (``|a - b| <= 2e-2 + 2e-2 |b|``, bf16 with other batch sizes in the
   matrix products); the kernel's launch count is exactly 12 per executed
   batch (the construction probe and warm-up included); and one row run in
   f32 on the card matches the plain f32 forward on the CPU within 1e-3.
   Prints requests/s, tokens/s and p50/p99 latency beside the card.
4. A JSON line with the kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo.bert import bert_base, load_jax_params
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.tools import card, median_ms, seeded_bert_weights

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,       # dense tensor cores
              torch.float32: 67e12}         # fp32 without the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BERT_SHAPE = (32, 12, 512, 64)
CHECK_SHAPES = [  # (B, H, S, D), causal
    (BERT_SHAPE, False), ((2, 2, 256, 64), False), ((2, 2, 256, 64), True),
    ((1, 1, 192, 64), False), ((1, 2, 640, 64), True),
    ((2, 4, 128, 32), False), ((1, 2, 256, 128), False),
    ((1, 2, 256, 128), True)]
SEQ_LEN = 512
N_CLIENTS = 8
REQS_PER_CLIENT = 12


def bound_ms(shape, dtype, causal: bool):
    """Least time on an H100 for one forward: each input read once, each
    output written once, against the products this input needs."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * H * S * D * elt + B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * pairs * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, nbytes, flops


# ---------------------------------------------------------------------------
def phase_environment(smi: str):
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    fa._kernel()
    log = _build.build_log(fa._LIB_NAME)
    print(f"built {log['path']} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {log['seconds']:.1f} s, cached={log['cached']})")
    for line in log["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernel(seed: int, smi: str):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    record = {}
    for shape, causal in CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(dtype)
                       for _ in range(3))
            scale = shape[-1] ** -0.5
            out, lse = fa.flash_attention_fwd(q, k, v, scale, causal)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale,
                                                            causal)
            err_o = (out.float() - ref.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            ok = err_o <= TOL[dtype] and err_l <= TOL[dtype]
            line = (f"kernel {shape} {str(dtype)[6:]} causal={causal}: "
                    f"max|dO|={err_o:.3g} max|dLSE|={err_l:.3g} "
                    f"tol={TOL[dtype]:g}")
            if shape == BERT_SHAPE:
                ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, scale,
                                                              causal))
                plain = median_ms(lambda: fa.flash_attention_fwd_reference(
                    q, k, v, scale, causal), reps=20, warmup=2)
                lib = median_ms(lambda: torch.nn.functional
                                .scaled_dot_product_attention(
                                    q, k, v, is_causal=causal, scale=scale))
                bms, by, nbytes, flops = bound_ms(shape, dtype, causal)
                line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                         f"sdpa {lib:.4f} ms, bound {bms * 1e3:.1f} us "
                         f"({by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP) on {smi}")
                record[dtype] = {"max_abs_err": max(err_o, err_l), "ms": ms,
                                 "plain_ms": plain, "library_ms": lib,
                                 "bound_ms": bms, "bound_by": by}
            print(line)
            if not ok:
                raise SystemExit(f"FAIL: kernel disagrees with its plain "
                                 f"version at {shape} {dtype} causal={causal}")
            del q, k, v, out, lse, ref, ref_lse
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
    launches = phase_slice(args.seed, smi)
    r = record[torch.bfloat16]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:213",
        "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": list(BERT_SHAPE), "dtype": "bfloat16"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
