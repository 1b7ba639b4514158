"""Where the time of K2 and K3 goes on the card: the bf16 flash-attention
backward kernels with parts of their loops taken out or changed, each timed
beside the kernels as built.

    python3 -m mxnet_tpu_torch.tools.bwd_ablation [--base FILE] [--seed 0]

Builds ``csrc/flash_attention_bwd.cu`` for bf16 at D = 64 (BERT-base's
head) as it is and once per variant, each variant a text substitution on
the source (the tool stops if a substitution no longer matches it):

- ``no_elementwise``: P and dS are not computed: the raw scores go to the
  accumulating products (wrong results; timed only);
- ``no_accumulate``: the accumulating products (K2 dq += dS K; K3 dv +=
  P^T dO, dk += dS^T Q) are not issued (wrong results; timed only);
- ``no_scores``: the score products (S and dP, or their transposes) are
  not issued (wrong results; timed only);
- ``loads_only``: no product and no elementwise work: the TMA loads, the
  barriers and the stores alone (wrong results; timed only);
- ``no_pingpong``: K2's two consumer warpgroups issue their products
  without taking turns;
- ``k2_stages_2``: K2's K/V ring of 2 stages (as built: 3);
  ``k3_stages_2``, ``k3_stages_4``: K3's Q/dO ring of 2 or 4 (as built:
  3);
- ``base`` (with ``--base FILE``): another ``flash_attention_bwd.cu`` with
  the same C entries (an earlier commit's, from ``git show``), as it is.

The variants that keep the arithmetic are held to the kernels as built
within 2e-2 (bf16 outputs). Each variant is timed twice, in turns (as built
first and last), K2 and K3 apart, each call of its C entry replayed from a
CUDA graph of 10 (``tools.graph_ms``: no host work in the window), at the
training shape (64, 12, 128, 64), the serving shape (32, 12, 512, 64) and
(8, 12, 2048, 64), beside SDPA's backward (forward plus backward less
forward). Prints one JSON line at the end. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import _build
from ..ops.cuda import flash_attention as fa
from . import card, graph_ms

SHAPES = [(64, 12, 128, 64), (32, 12, 512, 64), (8, 12, 2048, 64)]
_ONLY_D64 = [("    MXT_CASE(32)\n", ""), ("    MXT_CASE(128)\n", "")]
_K2_ELEMENTWISE = "for (int j = 0; j < BK / 8; ++j) {"
_K3_ELEMENTWISE = "for (int j = 0; j < BQ / 8; ++j) {"
# (each substitution replaces every occurrence)
_NO_ACCUMULATE = [
    ("issue_accumulate<D, BK>(dq, sa, kt);", "(void)kt;"),
    ("issue_accumulate<D, BQ>(dv, pa, gt);", "(void)gt;"),
    ("issue_accumulate<D, BQ>(dk, sa, qt);", "(void)qt;")]
_NO_SCORES = [
    ("issue_scores<D, BK>(s, q_half, k_tile(st));", "(void)0;"),
    ("issue_scores<D, BK>(dp, g_half, k_tile(st) + M::STREAM);", "(void)0;"),
    ("issue_scores<D, BQ>(s, k_half, qt);", "(void)0;"),
    ("issue_scores<D, BQ>(dp, v_half, gt);", "(void)0;")]
_NO_PINGPONG = [("turns_open(c);", ""), ("turn_begin(c);", ""),
                ("turn_end(c, false);", ""),
                ("turn_end(c, !more && last_work);", "")]
_K2_STAGES = "static constexpr int STAGES = 3;               // K and V tiles"
_K3_STAGES = "static constexpr int STAGES = 3;               // Q and dO tiles"
_NO_ELEMENTWISE = [(_K2_ELEMENTWISE, "for (int j = 0; j < 0; ++j) {"),
                   (_K3_ELEMENTWISE, "for (int j = 0; j < 0; ++j) {")]
VARIANTS = {  # name: (substitutions, keeps the arithmetic)
    "as_built": ([], True),
    "no_elementwise": (_NO_ELEMENTWISE, False),
    "no_accumulate": (_NO_ACCUMULATE, False),
    "no_scores": (_NO_SCORES, False),
    "loads_only": (_NO_ELEMENTWISE + _NO_ACCUMULATE + _NO_SCORES, False),
    "no_pingpong": (_NO_PINGPONG, True),
    "k2_stages_2": ([(_K2_STAGES, _K2_STAGES.replace("3;", "2;"))], True),
    "k3_stages_2": ([(_K3_STAGES, _K3_STAGES.replace("3;", "2;"))], True),
    "k3_stages_4": ([(_K3_STAGES, _K3_STAGES.replace("3;", "4;"))], True),
}


def _source(subs, path=None):
    src = (path or _build.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in _ONLY_D64 + subs:
        if old not in src:
            raise SystemExit(f"bwd_ablation: the source no longer holds "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def _build_variant(name, base=None):
    """The variant's (K2, K3) C entries, its source written under the build
    directory and built and loaded as the port builds its kernels (the
    shared header is found in csrc/)."""
    out_dir = _build.BUILD_DIR / "bwd_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(_source([], base) if name == "base"
                  else _source(VARIANTS[name][0]))
    return fa.bind_bwd(_build.load(f"bwd_ablation_{name}", [cu]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path,
                    help="another flash_attention_bwd.cu to time as it is")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    variants = dict(VARIANTS)
    if args.base:
        variants["base"] = ([], True)
    with ThreadPoolExecutor(len(variants)) as pool:
        fns = dict(zip(variants, pool.map(
            lambda n: _build_variant(n, args.base), variants)))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": smi, "ms": {}}
    for shape in SHAPES:
        B, H, S, D = shape
        qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda",
                          dtype=torch.float32).to(torch.bfloat16)
        q, k, v = (x.view(B, S, H, D).transpose(1, 2)
                   for x in qkv.split(H * D, dim=-1))
        do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                         dtype=torch.float32).to(torch.bfloat16).transpose(1, 2)
        out, lse = fa.flash_attention_fwd(q, k, v, D ** -0.5, False)
        outs = {}
        for name in variants:
            dq, dk, dv = (fa._bshd_like(q) for _ in range(3))
            delta = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
            outs[name] = (dq, dk, dv, delta,
                          fa._views(q, k, v, out, do, dq),
                          fa._views(q, k, v, do, dk, dv))

        def call(name, which):
            dq, dk, dv, delta, views_dq, views_dkv = outs[name]
            views = views_dq if which == 0 else views_dkv
            rc = fns[name][which](
                views, lse.data_ptr(), delta.data_ptr(), B, H, S, D, 1,
                D ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"bwd_ablation: {name} returned {rc}")

        for name in variants:
            call(name, 0)
            call(name, 1)
        torch.cuda.synchronize()
        for name, (_, exact) in variants.items():
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(outs[name][:4], outs["as_built"][:4]))
            if exact and not err <= 2e-2:
                raise SystemExit(f"bwd_ablation: {name} disagrees with the "
                                 f"kernels as built by {err:.3g}")
        times = {name: {"k2": [], "k3": []} for name in variants}
        order = list(variants)
        for names in (order, order[::-1]):
            for name in names:
                for which, kern in ((0, "k2"), (1, "k3")):
                    times[name][kern].append(graph_ms(
                        lambda: call(name, which)))
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, scale=D ** -0.5)

        sdpa_bwd = graph_ms(lambda: torch.autograd.grad(
            sdpa(), (qs, ks, vs), do)) - graph_ms(sdpa)
        result["ms"][str(shape)] = {"sdpa_backward": sdpa_bwd, **times}
        print(f"{shape} on {smi}: sdpa backward {sdpa_bwd:.4f} ms (graph)")
        for name, t in times.items():
            print(f"  {name:16s} K2 {t['k2'][0]:.4f} / {t['k2'][1]:.4f} ms, "
                  f"K3 {t['k3'][0]:.4f} / {t['k3'][1]:.4f} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
