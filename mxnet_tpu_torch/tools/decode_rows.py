"""Which ops of the generate path's decode step give a row a result that
depends on the batch it is in, on the card, and what the step costs with
its attention at the batch bucket or at the top bucket's rows.

    python3 -m mxnet_tpu_torch.tools.decode_rows [--seed 0]

Batched continuous decode equals serial decode only if every op of the
decode step computes a row the same way whatever the batch holds. For each
op of ``TransformerLM.decode_step`` at BERT-base width (768 units, 12 heads
of 64, FFN 3072, vocab 30522, 512 context lanes), bf16 as served, it runs
seeded rows twice and compares row 0 bitwise:

- "by rows": row 0 alone (1 row) against row 0 among 2, 4 and 8 rows;
- "fixed rows": row 0 among 8 rows against row 0 among 8 other rows.

The attention's parts (scores, softmax, P V, all f32 as the reference) are
compared in two formulations: batched matrix products (``torch.matmul``)
and, as ``single_query_attention`` computes them, an elementwise product
and a sum over the innermost axis; each also with its rows zero-padded
to 8. Then the whole ``decode_step`` of a full-width ``TransformerLM``
(random weights) is timed from a CUDA graph of one step (device time, no
host work), its products at 8 rows and its context at 1 row and at 8
rows. Prints one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..gluon.model_zoo.bert import TransformerLM
from ..ops import nn as ops
from . import card, graph_ms

U, H, D, L, FFN, V, R = 768, 12, 64, 512, 3072, 30522, 8


def _compare(fn, make, rows=(1, 2, 4, 8)):
    """Row 0 of ``fn`` over the first n rows of ``make()``'s batch for each
    n in ``rows``, against n = rows[0]: [(n, bitwise, max |d|)]."""
    args = make()
    base = fn(*(a[:rows[0]] for a in args))[0].float()
    out = []
    for n in rows[1:]:
        got = fn(*(a[:n] for a in args))[0].float()
        out.append((n, bool(torch.equal(got, base)),
                    (got - base).abs().max().item()))
    return out


def _fixed(fn, make):
    """Row 0 of ``fn`` over R rows against row 0 over R rows whose other
    rows differ: (bitwise, max |d|)."""
    a, b = make(), make()
    for x, y in zip(a, b):
        y[0] = x[0]
    got, want = fn(*a)[0].float(), fn(*b)[0].float()
    return bool(torch.equal(got, want)), (got - want).abs().max().item()


def _padded(fn, make, rows=(1, 2, 4)):
    """``fn`` over the first n rows zero-padded to R rows, row 0 against
    the same over all R rows."""
    args = make()

    def pad(a, n):
        p = torch.zeros_like(a)
        p[:n] = a[:n]
        return p

    want = fn(*args)[0].float()
    out = []
    for n in rows:
        got = fn(*(pad(a, n) for a in args))[0].float()
        out.append((n, bool(torch.equal(got, want)),
                    (got - want).abs().max().item()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_rows: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    res = {}
    for name, (n_in, n_out) in {"qkv": (U, 3 * U), "proj": (U, U),
                                "ffn1": (U, FFN), "ffn2": (FFN, U),
                                "lm_head": (U, V)}.items():
        w = randn(n_out, n_in, scale=n_in ** -0.5)
        res[f"linear_{name}"] = {
            "by_rows": _compare(lambda x: F.linear(x, w),
                                lambda: [randn(R, n_in)]),
            "fixed_rows": _fixed(lambda x: F.linear(x, w),
                                 lambda: [randn(R, n_in)])}
    g, b = randn(U, dtype=torch.float32), randn(U, dtype=torch.float32)
    res["layer_norm"] = {
        "by_rows": _compare(lambda x: ops.layer_norm(x, g, b),
                            lambda: [randn(R, U, scale=30.0)]),
        "fixed_rows": _fixed(lambda x: ops.layer_norm(x, g, b),
                             lambda: [randn(R, U, scale=30.0)])}
    res["gelu_tanh"] = {"by_rows": _compare(
        ops.gelu_tanh, lambda: [randn(R, FFN, scale=3.0)])}

    def attn_inputs():
        """q, k_new and v_new as the model hands them over: the split
        views of one (rows, 3 * U) QKV output."""
        q, k, v = randn(R, 3 * U, scale=3.0).split(U, dim=-1)
        return [q, randn(R, L, U, scale=3.0), randn(R, L, U), k, v,
                torch.tensor([300, 17, 511, 64, 0, 128, 256, 400],
                             device="cuda")]

    res["single_query_attention"] = {"by_rows": _compare(
        lambda *a: ops.single_query_attention(*a, heads=H), attn_inputs)}

    def f32(x):
        return x.to(torch.float32, memory_format=torch.contiguous_format)

    def qk_inputs():
        return [f32(randn(R, U, scale=3.0).reshape(R, H, 1, D)),
                f32(randn(R, L, U, scale=3.0).reshape(R, L, H, D)
                    .transpose(1, 2))]

    def pv_inputs():
        p = torch.softmax(torch.randn(R, H, L, generator=gen,
                                      device="cuda") * 8, -1).to(bf).float()
        v = randn(R, L, U).reshape(R, L, H, D)
        return [p, f32(v.transpose(1, 2)), f32(v.permute(0, 2, 3, 1))]

    forms = {   # the attention's three parts, f32, in two formulations
        "scores_matmul": (lambda q, k: torch.matmul(q, k.transpose(-1, -2)),
                          qk_inputs),
        "scores_inner_sum": (lambda q, k: (q * k).sum(-1), qk_inputs),
        "softmax": (lambda s: torch.softmax(s, -1),
                    lambda: [torch.randn(R, H, L, generator=gen,
                                         device="cuda") * 8]),
        "pv_matmul": (lambda p, v, vt: torch.matmul(p[:, :, None, :], v),
                      pv_inputs),
        "pv_inner_sum": (lambda p, v, vt: (p[:, :, None, :] * vt).sum(-1),
                         pv_inputs)}
    for name, (fn, make) in forms.items():
        res[name] = {"by_rows": _compare(fn, make),
                     "padded_to_8": _padded(fn, make)}

    # the whole step from a CUDA graph: device ms
    lm = TransformerLM(num_layers=12, units=U, hidden_size=FFN, num_heads=H,
                       vocab_size=V, max_length=L).to("cuda", bf).eval()
    ids = torch.randint(0, V, (R,), generator=gen, device="cuda")
    pos = torch.full((R,), L - 1, device="cuda")
    ctx = [randn(R, L, U) for _ in range(24)]
    steps = {}
    with torch.inference_mode():
        for b in (1, 8):
            steps[f"context_{b}_rows"] = graph_ms(
                lambda: lm.decode_step(ids, pos, *(c[:b] for c in ctx)),
                calls=1)

    print(f"card: {smi}")
    for k, v in res.items():
        print(f"  {k:24s} {v}")
    print(f"  decode_step from a CUDA graph (products at {R} rows, {L} "
          f"lanes): {steps}")
    print(json.dumps({"card": smi, "ops": res, "step_device_ms": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
