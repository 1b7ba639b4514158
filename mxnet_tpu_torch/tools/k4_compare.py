"""K4, the fused 1x1 convolution + BatchNorm kernel, beside an earlier build
of it and beside the library, on the card, from CUDA graphs.

    git show <commit>:mxnet_tpu_torch/csrc/fused_conv1x1.cu \\
        > build/parent_k4.cu
    python3 -m mxnet_tpu_torch.tools.k4_compare \\
        [--parent-source build/parent_k4.cu] [--schedules] [--variants] \\
        [--shapes s5_in,s5_expand] [--seed 0]

At ResNet-50's nine batch-128 1x1 shapes (bf16 x), it times, each replayed
from a CUDA graph of 10 calls (``tools.graph_ms``: no host work inside):

- ``change``: this tree's ``conv1x1_bn_act`` with its own schedule;
- ``parent``: the earlier kernel (the ``mma.sync`` design, up to commit
  0f3769a), whose C entry is ``mxt_conv1x1_bn_act(x, w, scale, shift, y,
  col_sum, col_sumsq, partial, counter, M, K, N, x_is_bf16, relu,
  block_n, grid_m, stream)`` (128-row tiles, its ticket counter zeroed by
  a fill every call, as its wrapper did), built as the port builds its kernels under its own name;
  parent and change run in turns (parent, change, change, parent), and the
  parent's outputs are held to this tree's within 2e-2 (y) and 1e-3 (the
  moments) x max(1, max|plain|) first;
- ``composition``: the same function from library calls, as the
  reference's baseline composes it: the prologue as one elementwise
  expression (``relu(addcmul(shift, x, scale))`` rounded to bf16), the
  bf16 product with an f32 result (``torch.mm(..., out_dtype=float32)``
  where this torch has it, else the bf16 product widened, said in the
  output), y rounded to bf16, and the column sums of y and y^2;
- ``matmul``: ``torch.matmul`` of the pre-activated bf16 x with w, the
  product alone;

and the bound (bytes over 3.35 TB/s against operations over 989
TFLOP/s). ``--schedules`` also times this tree's kernel under every other
tile width (64, 128, 256 columns, up to N), each held to the plain
version first. ``--variants`` builds the source with parts of the kernel
taken out, each a text substitution (the tool stops if one no longer
matches), timed under the chosen schedule (wrong results, timed only): ``no_affine`` (x goes to the
products as it is), ``no_products`` (no wgmma), ``no_moments`` (y stored,
no moments), ``no_epilogue`` (neither y nor moments), ``loads_only`` (the
three together: the TMA ring and its barriers), ``no_store_wait`` (y's
staging does not wait for the last store to have read it). It prints the
kernels' ptxas notes (registers, spills, warnings), and one JSON line at
the end. Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops.cuda import fused_conv1x1 as fc
from . import card, graph_ms

SHAPES = {"s2_reduce": (128 * 56 * 56, 64, 64),
          "s2_expand": (128 * 56 * 56, 64, 256),
          "s2_in": (128 * 56 * 56, 256, 64),
          "s3_in": (128 * 28 * 28, 512, 128),
          "s3_expand": (128 * 28 * 28, 128, 512),
          "s4_in": (128 * 14 * 14, 1024, 256),
          "s4_expand": (128 * 14 * 14, 256, 1024),
          "s5_in": (128 * 7 * 7, 2048, 512),
          "s5_expand": (128 * 7 * 7, 512, 2048)}
Y_TOL, MOMENT_TOL = 2e-2, 1e-3
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12

_AFFINE = ("  const float2 s = *reinterpret_cast<const float2*>(ss + col);\n"
           "  const float2 t = *reinterpret_cast<const float2*>(ss + kKC + "
           "col);\n  float a = fmaf(v.x, s.x, t.x), b = fmaf(v.y, s.y, t.y);")
_PRODUCTS = "        wgmma_rs<BN>(acc, f, smem_desc("
_Y = "    // ---- y: bf16, staged swizzled, stored by TMA ----"
_MOMENTS = "    // ---- moments of the f32 y over rows below M ----"
_NO_AFFINE = [(_AFFINE, "  float a = v.x, b = v.y;")]
_NO_PRODUCTS = [(_PRODUCTS, "        if (relu < 0) " + _PRODUCTS.lstrip())]
_NO_MOMENTS = [(_MOMENTS, "    if (kchunks > 0) continue;\n" + _MOMENTS)]
_NO_EPILOGUE = [(_Y, "    if (kchunks > 0) continue;\n" + _Y)]
_STORE_WAIT = ('    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: '
               '"memory");\n    group_sync(c);')
_NO_STORE_WAIT = [(_STORE_WAIT, "    group_sync(c);")]
VARIANTS = {  # name: (substitutions, keeps the arithmetic)
    "no_affine": (_NO_AFFINE, False), "no_products": (_NO_PRODUCTS, False),
    "no_moments": (_NO_MOMENTS, False), "no_epilogue": (_NO_EPILOGUE, False),
    "loads_only": (_NO_AFFINE + _NO_PRODUCTS + _NO_EPILOGUE, False),
    "no_store_wait": (_NO_STORE_WAIT, False)}


def _source(subs, path=None):
    src = (path or _build.CSRC / "fused_conv1x1.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"k4_compare: anchor not found: {old!r}")
        src = src.replace(old, new)
    return src


def _build_variant(name):
    out_dir = _build.BUILD_DIR / "k4_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"fused_conv1x1_{name}.cu"
    cu.write_text(_source(VARIANTS[name][0]))
    return fc.bind(_build.load(f"k4_variant_{name}", [str(cu)]))


def _bind_parent(source: Path):
    fn = _build.load("parent_fused_conv1x1",
                     [str(source.resolve())]).mxt_conv1x1_bn_act
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _parent_call(fn, x, w, scale, shift, sms):
    """The earlier kernel as its wrapper launched it: 64-column tiles for
    N <= 64, else 128, about two blocks per SM along M, a fresh zeroed
    ticket counter every call."""
    M, K = x.shape
    N = w.shape[1]
    block_n = 64 if N <= 64 else 128
    n_tiles, m_tiles = -(-N // block_n), -(-M // 128)
    grid_m = max(1, min(m_tiles, -(-2 * sms // n_tiles)))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    col_sum = torch.empty(N, dtype=torch.float32, device=x.device)
    col_sumsq = torch.empty(N, dtype=torch.float32, device=x.device)
    partial = torch.empty((2, grid_m, N), dtype=torch.float32,
                          device=x.device)
    counter = torch.zeros(n_tiles, dtype=torch.int32, device=x.device)
    rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            y.data_ptr(), col_sum.data_ptr(), col_sumsq.data_ptr(),
            partial.data_ptr(), counter.data_ptr(), M, K, N, 1, 1, block_n,
            grid_m, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"k4_compare: the earlier kernel returned {rc}")
    return y, col_sum, col_sumsq


def composition(x, w, scale, shift):
    """K4's function from library calls: ``(y bf16, col_sum, col_sumsq)``;
    the second value says whether the product's f32 result came from
    ``torch.mm(..., out_dtype=torch.float32)``."""
    xh = torch.relu(torch.addcmul(shift, x, scale)).to(torch.bfloat16)
    try:
        y = torch.mm(xh, w, out_dtype=torch.float32)
        direct = True
    except TypeError:       # this torch has no out_dtype: widen the bf16 y
        y = torch.mm(xh, w).float()
        direct = False
    return (y.to(torch.bfloat16), y.sum(dim=0), y.square().sum(dim=0)), direct


def bound_ms(M, K, N):
    nbytes = M * K * 2 + K * N * 2 + 2 * K * 4 + M * N * 2 + 2 * N * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * M * K * N / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def _errors(got, want):
    """Each output's max error over its tolerance x max(1, max|want|)."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        tol = (Y_TOL if i == 0 else MOMENT_TOL) * \
            max(1.0, b.abs().max().item())
        err = (a - b).abs().max().item()
        out.append(err / tol if torch.isfinite(a).all() else float("inf"))
    return max(out)


def _schedules(M, N, sms):
    """Every (block_n, blocks) the C entry takes at this shape, tile widths
    up to N, one block per SM at most."""
    return [(bn, min(-(-M // 128) * -(-N // bn), sms))
            for bn in (64, 128, 256) if bn <= max(64, N)]


def compare(label, shape, gen, sms, parent, variants, schedules):
    M, K, N = shape
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5) \
        .to(torch.bfloat16)
    scale = torch.rand(K, generator=gen, device="cuda") + 0.5
    shift = 0.1 * torch.randn(K, generator=gen, device="cuda")
    plain = fc.conv1x1_bn_act_reference(x, w, scale, shift)
    chosen = fc._schedule(M, N, sms)
    res = {"M": M, "K": K, "N": N, "schedule": list(chosen)}
    if _errors(fc.conv1x1_bn_act(x, w, scale, shift), plain) > 1:
        raise SystemExit(f"k4_compare: K4 disagrees with its plain version "
                         f"at {label}")
    change = lambda: fc.conv1x1_bn_act(x, w, scale, shift)  # noqa: E731
    calls = {"change": change}
    if parent is not None:
        if _errors(_parent_call(parent, x, w, scale, shift, sms), plain) > 1:
            raise SystemExit(f"k4_compare: the earlier kernel disagrees "
                             f"with the plain version at {label}")
        calls["parent"] = lambda: _parent_call(parent, x, w, scale, shift,
                                               sms)
    order = (["parent", "change", "change", "parent"] if parent is not None
             else ["change", "change"])
    times = {n: [] for n in calls}
    for n in order:
        times[n].append(graph_ms(calls[n]))
    comp, direct = composition(x, w, scale, shift)
    if _errors(comp, plain) > 1:
        raise SystemExit(f"k4_compare: the composition disagrees at {label}")
    xh = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
    times["composition"] = [graph_ms(lambda: composition(x, w, scale,
                                                         shift))]
    times["matmul"] = [graph_ms(lambda: torch.matmul(xh, w))]
    res["composition_out_dtype_f32"] = direct
    res["bound_ms"], res["bound_by"] = bound_ms(M, K, N)
    res["ms"] = times
    xs, ws, ss, ts = fc._checked(x, w, scale, shift)
    if schedules:
        res["schedules"] = {}
        for sch in _schedules(M, N, sms):
            got = fc._run(xs, ws, ss, ts, True, *sch)
            if _errors(got, plain) > 1:
                raise SystemExit(f"k4_compare: schedule {sch} disagrees at "
                                 f"{label}")
            res["schedules"][str(list(sch))] = graph_ms(
                lambda: fc._run(xs, ws, ss, ts, True, *sch))
    if variants:
        res["variants"] = {
            name: graph_ms(lambda: fc._run(xs, ws, ss, ts, True, *chosen,
                                           fn=fn))
            for name, fn in variants.items()}
    return res


def _ptxas_notes(name):
    return [ln.strip() for ln in _build.build_log(name).get(
        "ptxas", "").splitlines()
            if any(k in ln for k in ("arning", "erformance", "wgmma",
                                     "spill", "registers"))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-source", type=Path)
    ap.add_argument("--schedules", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_compare: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    fc._kernel()
    for ln in _ptxas_notes(fc._LIB_NAME):
        print("  ptxas:", ln)
    parent = _bind_parent(args.parent_source) if args.parent_source else None
    variants = {n: _build_variant(n) for n in VARIANTS} if args.variants \
        else {}
    sms = fc._sm_count(torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": smi, "shapes": {}}
    for label in args.shapes.split(","):
        res = compare(label, SHAPES[label], gen, sms, parent, variants,
                      args.schedules)
        result["shapes"][label] = res
        t = res["ms"]
        print(f"{label} {res['M']}x{res['K']}x{res['N']} schedule "
              f"{res['schedule']} on {smi}, ms from CUDA graphs: " +
              ", ".join(f"{n} " + " / ".join(f"{v:.4f}" for v in vs)
                        for n, vs in t.items()) +
              f"; bound {res['bound_ms']:.4f} ({res['bound_by']})")
        for key in ("schedules", "variants"):
            if key in res:
                print(f"  {key}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res[key].items()))
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
