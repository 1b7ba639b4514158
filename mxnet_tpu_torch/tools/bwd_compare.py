"""The flash-attention backward (K2 + K3) beside an earlier build of it on
the card, in turns, each replayed from CUDA graphs.

    git show <commit>:mxnet_tpu_torch/csrc/flash_attention_bwd.cu \\
        > build/parent_bwd.cu
    python3 -m mxnet_tpu_torch.tools.bwd_compare \\
        --parent-source build/parent_bwd.cu [--seed 0]

The earlier source is one from before commit ead8616, whose C entries
take contiguous (B*H, S, D) tensors and a delta computed outside them:
``mxt_flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq, bh, seq,
head_dim, is_bf16, sm_scale, causal, stream)`` and ``..._dkv`` with dk and
dv. It is built as the port builds its kernels (``_build.load``, its own
library name) and bound here.

At the training shape (64, 12, 128, 64) and the serving shape (32, 12, 512,
64), bf16, with q, k, v the split views of one QKV buffer, out K1's output
and dout the transposed view of a (B, S, H, D) gradient (the training
path's layouts), it times:

- the earlier kernels as its ``FlashAttention.backward`` ran them on that
  path: dout, q, k, v and out made contiguous, delta as four eager f32 ops,
  K2, K3, then the three gradients' (B, H, S, D) -> (B, S, H*D) copies that
  ``multi_head_attention``'s reshape made in autograd (``parent_path``);
  and the same without the copies, on contiguous inputs
  (``parent_kernels``), and its K2 and K3 alone;
- this tree's K2 and K3 alone and ``flash_attention_bwd`` on the views as
  they are (``change``; the reshape of its outputs is a view);
- ``scaled_dot_product_attention``'s backward (forward plus backward less
  forward).

Every window is a CUDA graph of 10 calls (``tools.graph_ms``), no host work
inside; the variants run in turns (parent, change, change, parent). The
earlier kernels' gradients are held against this tree's within 2e-2 x
max(1, max|plain|) first. Prints one JSON line at the end. Needs one CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops.cuda import flash_attention as fa
from . import card, graph_ms

SHAPES = {"training": (64, 12, 128, 64), "serving": (32, 12, 512, 64)}
TOL = 2e-2


def _bind_parent(source: Path):
    lib = _build.load("parent_flash_attention_bwd", [str(source.resolve())])
    dq, dkv = lib.mxt_flash_attention_bwd_dq, lib.mxt_flash_attention_bwd_dkv
    ints = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
    dq.argtypes = [ctypes.c_void_p] * 7 + ints
    dkv.argtypes = [ctypes.c_void_p] * 8 + ints
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _parent_calls(fns, shape, scale):
    """(K2, K3) of the earlier build on contiguous (B, H, S, D) bf16
    tensors; each raises SystemExit if the launch fails."""
    B, H, S, D = shape

    def stream():   # at call time: a graph captures on its own stream
        return torch.cuda.current_stream().cuda_stream

    def k2(q, k, v, g, lse, delta):
        dq = torch.empty_like(q)
        rc = fns[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H,
                    S, D, 1, scale, 0, stream())
        if rc:
            raise SystemExit(f"bwd_compare: the earlier K2 returned {rc}")
        return dq

    def k3(q, k, v, g, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = fns[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B * H, S, D, 1, scale, 0, stream())
        if rc:
            raise SystemExit(f"bwd_compare: the earlier K3 returned {rc}")
        return dk, dv

    return k2, k3


def compare(fns, shape, gen):
    B, H, S, D = shape
    scale = D ** -0.5
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda",
                      dtype=torch.float32).to(torch.bfloat16)
    q, k, v = (x.view(B, S, H, D).transpose(1, 2)
               for x in qkv.split(H * D, dim=-1))
    do = torch.randn((B, S, H, D), generator=gen, device="cuda",
                     dtype=torch.float32).to(torch.bfloat16).transpose(1, 2)
    out, lse = fa.flash_attention_fwd(q, k, v, scale, False)
    k2, k3 = _parent_calls(fns, shape, scale)
    qc, kc, vc, oc, gc = (x.contiguous() for x in (q, k, v, out, do))
    delta = (gc.float() * oc.float()).sum(dim=-1)

    def parent_kernels():
        d = (gc.float() * oc.float()).sum(dim=-1)
        return k2(qc, kc, vc, gc, lse, d), *k3(qc, kc, vc, gc, lse, d)

    def parent_path():
        g = do.contiguous()
        a, b, c, o = (x.contiguous() for x in (q, k, v, out))
        d = (g.float() * o.float()).sum(dim=-1)
        grads = (k2(a, b, c, g, lse, d), *k3(a, b, c, g, lse, d))
        return [x.transpose(1, 2).reshape(B, S, H * D) for x in grads]

    def change():
        return [x.transpose(1, 2).reshape(B, S, H * D) for x in
                fa.flash_attention_bwd(q, k, v, out, lse, do, scale, False)]

    got, want = parent_path(), change()
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        err = (a.float() - b.float()).abs().max().item()
        if not err <= TOL * max(1.0, b.float().abs().max().item()):
            raise SystemExit(f"bwd_compare: the earlier {name} differs from "
                             f"this tree's by {err:.3g} at {shape}")
    _, new_delta = fa.flash_attention_bwd_dq(q, k, v, out, do, lse, scale,
                                             False)
    variants = {
        "parent_path": parent_path,
        "parent_kernels": parent_kernels,
        "parent_delta": lambda: (gc.float() * oc.float()).sum(dim=-1),
        "parent_k2": lambda: k2(qc, kc, vc, gc, lse, delta),
        "parent_k3": lambda: k3(qc, kc, vc, gc, lse, delta),
        "change": change,
        "change_k2": lambda: fa.flash_attention_bwd_dq(
            q, k, v, out, do, lse, scale, False),
        "change_k3": lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, new_delta, scale, False)}
    parents = [n for n in variants if n.startswith("parent")]
    changes = [n for n in variants if n.startswith("change")]
    times = {n: [] for n in variants}
    for names in (parents, changes, changes, parents):
        for n in names:
            times[n].append(graph_ms(variants[n]))
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, scale=scale)

    times["sdpa_backward"] = [
        graph_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), do))
        - graph_ms(sdpa)]
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-source", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_compare: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    fns = _bind_parent(args.parent_source)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": smi, "ms": {}}
    for where, shape in SHAPES.items():
        times = compare(fns, shape, gen)
        result["ms"][where] = times
        print(f"{where} {shape} bf16 on {smi}, ms from CUDA graphs (in "
              f"turns):")
        for name, t in times.items():
            print(f"  {name:16s} " + " / ".join(f"{x:.4f}" for x in t))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
