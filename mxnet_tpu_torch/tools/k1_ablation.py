"""Where K1's time goes on the card: the bf16 flash-attention forward with
parts of its main loop taken out or changed, each timed beside the kernel
as built.

    python3 -m mxnet_tpu_torch.tools.k1_ablation [--seed 0]

Builds ``csrc/flash_attention_fwd.cu`` for bf16 at D = 64 (BERT-base's
head) as it is and once per variant, each variant a text substitution on
the source (the tool stops if a substitution no longer matches it):

- ``no_softmax``: P is the raw scores: no row maxima, exponentials, sums or
  rescale (wrong results; timed only);
- ``no_pv``: the P V product is not issued (wrong results; timed only);
- ``no_s``: the Q K^T product is not issued (wrong results; timed only);
- ``s_only``: neither the softmax nor P V: the Q K^T product and the loads
  alone (timed only);
- ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns;
- ``mufu_exp_only``: every exponential on the multi-function unit;
- ``fma_exp_quarter``: a quarter of them on the FMA pipes (as built: an
  eighth);
- ``stages_2``, ``stages_4``: a K/V ring of 2 or 4 stages (as built: 3).

The variants that keep the arithmetic are held to the kernel as built
within 2e-2 (bf16 outputs; the FMA-pipe exponentials round differently).
Each variant is timed twice, in turns (as built first and last), with CUDA
events around 20 back-to-back launches of the C entry (no Python wrapper in
the window), median of 20 windows, at the serving shape (32, 12, 512, 64),
the training shape (64, 12, 128, 64) and (8, 12, 2048, 64), beside SDPA's
forward. Prints one JSON line at the end. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _build
from ..ops.cuda import flash_attention as fa
from . import card, median_ms

SHAPES = [(32, 12, 512, 64), (64, 12, 128, 64), (8, 12, 2048, 64)]
_ONLY_D64 = [
    ("return is_bf16 ? run(launch_bf16<32>) : run(launch_f32<32>);",
     "return -1;"),
    ("return is_bf16 ? run(launch_bf16<128>) : run(launch_f32<128>);",
     "return -1;"),
    ("return is_bf16 ? run(launch_bf16<64>) : run(launch_f32<64>);",
     "return run(launch_bf16<64>);")]
_SOFTMAX = """online_softmax<BK, T::EX2_FMA_EVERY>(
            s, m0, m1, l0, l1, scale_log2, need_mask(it * BK), it * BK, t,
            row0, row1, S, causal);"""
_PV = "            wgmma_rs_n64(o[p], pa[kc], db);"
_S = "        wgmma_ss_n128(\n"
_FMA = "static constexpr int EX2_FMA_EVERY = D == 128 ? 0 : 8;"
_STAGES = "static constexpr int STAGES = D == 128 ? 2 : 3;"
_PINGPONG = [("turn_begin();", ""), ("turn_end(false);", ""),
             ("turn_end(last_work);", ""),
             ('if (c == 1) asm volatile("bar.arrive 3, 256;\\n" ::: "memory");',
              "")]
VARIANTS = {  # name: (substitutions, keeps the arithmetic)
    "as_built": ([], True),
    "no_softmax": ([(_SOFTMAX, "make_float2(1.f, 1.f);")], False),
    "no_pv": ([(_PV, "            (void)db;")], False),
    "no_s": ([(_S, "        if (false) wgmma_ss_n128(\n")], False),
    "s_only": ([(_SOFTMAX, "make_float2(1.f, 1.f);"),
                (_PV, "            (void)db;")], False),
    "no_pingpong": (_PINGPONG, True),
    "mufu_exp_only": ([(_FMA, "static constexpr int EX2_FMA_EVERY = 0;")],
                      True),
    "fma_exp_quarter": ([(_FMA, "static constexpr int EX2_FMA_EVERY = 4;")],
                        True),
    "stages_2": ([(_STAGES, "static constexpr int STAGES = 2;")], True),
    "stages_4": ([(_STAGES, "static constexpr int STAGES = 4;")], True),
}


def _source(subs):
    src = (_build.CSRC / "flash_attention_fwd.cu").read_text()
    for old, new in _ONLY_D64 + subs:
        if old not in src:
            raise SystemExit(f"k1_ablation: the source no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def _build_variant(name):
    """The variant's C entry, its source written under the build directory
    and built and loaded as the port builds its kernels."""
    out_dir = _build.BUILD_DIR / "k1_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(_source(VARIANTS[name][0]))
    return fa.bind_fwd(_build.load(f"k1_ablation_{name}", [cu]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": smi, "ms": {}}
    for shape in SHAPES:
        B, H, S, D = shape
        qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda",
                          dtype=torch.float32).to(torch.bfloat16)
        q, k, v = (x.view(B, S, H, D).transpose(1, 2)
                   for x in qkv.split(H * D, dim=-1))
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        outs, views = {}, {}
        for name in VARIANTS:
            outs[name] = torch.empty((B, S, H, D), dtype=torch.bfloat16,
                                     device="cuda").transpose(1, 2)
            views[name] = (ctypes.c_longlong * 16)(*(
                n for x in (q, k, v, outs[name])
                for n in (x.data_ptr(), *fa.tma_strides(x))))

        def call(name):
            rc = fns[name](views[name], lse.data_ptr(), B, H, S, D, 1,
                           D ** -0.5, 0, stream)
            if rc:
                raise SystemExit(f"k1_ablation: {name} returned {rc}")

        for name in VARIANTS:
            call(name)
        torch.cuda.synchronize()
        for name, (_, exact) in VARIANTS.items():
            err = (outs[name].float() - outs["as_built"].float()).abs().max()
            if exact and not err <= 2e-2:
                raise SystemExit(f"k1_ablation: {name} disagrees with the "
                                 f"kernel as built by {err.item():.3g}")
        times = {name: [] for name in VARIANTS}
        order = list(VARIANTS)
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(median_ms(
                    lambda: call(name), reps=20, calls=20))
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        sdpa = median_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(qc, kc, vc),
                         reps=20, calls=20)
        result["ms"][str(shape)] = {"sdpa": sdpa, **times}
        print(f"{shape} on {smi}: sdpa forward {sdpa:.4f} ms")
        for name, t in times.items():
            print(f"  {name:16s} {t[0]:.4f} / {t[1]:.4f} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
