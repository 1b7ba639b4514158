"""Where an int8 net's output on the card leaves the CPU port's, layer by
layer, and what carries the difference.

    python3 -m mxnet_tpu_torch.tools.int8_drift [--seed 0] [--seq 32]

Builds ``chip_smoke.py``'s phase 15(b) net: ``bert_base()`` with seeded
weights, calibrated (naive) on the card on two seeded batches of 8 x 128
tokens, and its CPU twin with the same ranges (:func:`quantized_like`).
One seeded row of ``seq`` tokens (the phase's card-vs-CPU row) then runs:

- through the int8 net on the card with K1, and again with K1's plain
  version on the card;
- through the int8 net on the CPU;
- through the f32 net on the card and on the CPU (the float path's own
  card-vs-CPU distance).

For every quantized layer, in call order, it reports against the CPU run:
the layer's input (max |d| / max |CPU|), its input codes (how many
differ, and by how many steps), and the layer's own error: the CPU layer
run on the card's input against the card layer's output (0 where the
codes, the int32 sums, the dequantize and the bias agree bitwise). It then
runs the CPU net with every quantized layer's output pinned to the card's
(:func:`pinned_run`): what is left is the float path around the layers.
:func:`compare` is the comparison ``chip_smoke.py``'s phase 15 gates.

Prints one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import cpu, gpu, nd
from ..contrib import quantization as qz
from ..gluon.model_zoo.bert import bert_base
from ..gluon.nn import Dense
from ..gluon.model_zoo.carrier import load_jax_params
from ..ops import quantization as Q
from ..ops.cuda import flash_attention as fa
from . import card, seeded_bert_weights

_QUANTIZED = (qz.QuantizedDense, qz.QuantizedConv2D)


def quantized_like(net, qnet):
    """``net`` (the float architecture of ``qnet``) converted in place with
    ``qnet``'s calibrated ranges, layer by layer (no calibration pass)."""
    for path, blk in qnet.named_modules():
        if isinstance(blk, _QUANTIZED):
            parent_path, _, name = path.rpartition(".")
            parent = net.get_submodule(parent_path) if parent_path else net
            parent._modules[name] = type(blk)(parent._modules[name],
                                              blk._amax)
    return net


def _tensor(x):
    return x._data if isinstance(x, nd.NDArray) else x


def _outputs(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def capture(net, inputs, kinds=_QUANTIZED):
    """One forward of ``net`` on ``inputs``: (its outputs, ``{path: (input,
    output)}`` of every block of ``kinds``, in call order)."""
    seen, hooked = {}, []
    for path, blk in net.named_modules():
        if isinstance(blk, kinds):
            def post(block, args, out, path=path):
                seen[path] = (_tensor(args[0]).detach(),
                              _tensor(out).detach())
            hooked.append((blk, blk.register_forward_hook(post)))
    try:
        with torch.inference_mode():
            out = _outputs(net(*inputs))
    finally:
        for blk, h in hooked:
            blk._gluon_hooks.remove(h)
    return out, seen


def rel_max(got, want) -> float:
    """max over the outputs of max |got - want| / max |want| (on the CPU)."""
    return max(((g.cpu().float() - w.cpu().float()).abs().max()
                / w.cpu().float().abs().max()).item()
               for g, w in zip(_outputs(got), _outputs(want)))


def _codes(layer, x):
    return Q.quantize_v2(x.cpu(), min_calib_range=-layer._amax,
                         max_calib_range=layer._amax)[0].to(torch.int32)


def layer_table(card_seen, host_seen, host_net):
    """One row a quantized layer, in the card's call order: the layer's
    input card vs CPU, its input codes, and its own error (the CPU layer on
    the card's input against the card layer's output)."""
    blocks = dict(host_net.named_modules())
    rows = []
    for path, (xc, yc) in card_seen.items():
        xh, _ = host_seen[path]
        layer = blocks[path]
        xc = xc.cpu()
        step = (_codes(layer, xc) - _codes(layer, xh)).abs()
        with torch.inference_mode():
            local = layer(xc)
        d = (local - yc.cpu()).abs()
        top = float(yc.abs().max().cpu())
        rows.append({
            "layer": path, "amax": layer._amax,
            "input_rel": rel_max(xc, xh),
            "codes": step.numel(),
            "codes_differing": int((step > 0).sum()),
            "max_code_step": int(step.max()),
            "own_max_abs": float(d.max()),
            "own_ulps": float(d.max()) / float(np.spacing(np.float32(top))),
            "own_bitwise": bool(torch.equal(local, yc.cpu()))})
    return rows


def pinned_run(host_net, card_seen, inputs):
    """The CPU net on ``inputs`` with every quantized layer's output
    replaced by the card's (``card_seen``): (its outputs, ``{path: the
    layer's input as the CPU computed it}``)."""
    pinned, fed = [], {}
    for path, blk in host_net.named_modules():
        if isinstance(blk, _QUANTIZED):
            def fixed(x, _out=card_seen[path][1].cpu(), _path=path):
                fed[_path] = _tensor(x).detach()
                return _out
            blk.forward = fixed
            pinned.append(blk)
    try:
        with torch.inference_mode():
            return _outputs(host_net(*inputs)), fed
    finally:
        for blk in pinned:
            del blk.forward


def compare(card_net, host_net, host_f32, card_inputs, host_inputs):
    """An int8 net on the card against its CPU twin ``host_net`` (the same
    ranges) and the CPU's float net ``host_f32``, on the same inputs:

    - ``layers``: :func:`layer_table`; ``own_ulps``, the largest of the
      layers' own errors in ulps of that layer's largest output, and
      ``own_bitwise``, how many layers are bitwise;
    - ``pinned_inputs_rel`` and ``pinned_outputs_rel``: the CPU's float
      path with every quantized output pinned to the card's
      (:func:`pinned_run`), its layer inputs and outputs against the
      card's;
    - the free-running run: ``first_flip`` (the first layer whose input
      codes differ) with ``first_flip_input_rel``, ``codes_differing`` of
      ``codes`` over all layers, and ``free_running_rel``, the outputs'
      max |d| / max |CPU|;
    - ``int8_vs_f32_rel``: the int8 net's own error on the CPU, against
      ``host_f32``."""
    out_card, seen_card = capture(card_net, card_inputs)
    out_host, seen_host = capture(host_net, host_inputs)
    with torch.inference_mode():
        out_f32 = _outputs(host_f32(*host_inputs))
    rows = layer_table(seen_card, seen_host, host_net)
    pin_out, fed = pinned_run(host_net, seen_card, host_inputs)
    flips = [r for r in rows if r["codes_differing"]]
    return {
        "layers": rows,
        "own_ulps": max(r["own_ulps"] for r in rows),
        "own_bitwise": sum(r["own_bitwise"] for r in rows),
        "pinned_inputs_rel": max(rel_max(seen_card[p][0], fed[p])
                                 for p in seen_card),
        "pinned_outputs_rel": rel_max(out_card, pin_out),
        "first_flip": flips[0]["layer"] if flips else None,
        "first_flip_input_rel": flips[0]["input_rel"] if flips else None,
        "codes_differing": sum(r["codes_differing"] for r in rows),
        "codes": sum(r["codes"] for r in rows),
        "free_running_rel": rel_max(out_card, out_host),
        "int8_vs_f32_rel": rel_max(out_host, out_f32)}


def bert_case(seed: int, seq: int):
    """Phase 15(b)'s nets and row: (the seeded weights, the calibrated int8
    net on the card, the row's token ids and types as numpy)."""
    net = bert_base()
    named = seeded_bert_weights(net, seed)
    load_jax_params(net, named, ctx=gpu(0))
    rng = np.random.default_rng(seed + 17)

    def tokens(rows, s):
        return (rng.integers(0, 30522, (rows, s), dtype=np.int32),
                rng.integers(0, 2, (rows, s), dtype=np.int32))
    calib = [tuple(nd.array(a, ctx=gpu(0), dtype="int32")
                   for a in tokens(8, 128)) for _ in range(2)]
    qnet = qz.quantize_net(net, calib_data=calib, calib_mode="naive")
    return named, qnet.eval(), tokens(1, seq)


def run(seed: int = 0, seq: int = 32) -> dict:
    named, qnet, tok = bert_case(seed, seq)
    host, host32, card32 = bert_base(), bert_base(), bert_base()
    for n, ctx in ((host, cpu()), (host32, cpu()), (card32, gpu(0))):
        load_jax_params(n, named, ctx=ctx)
        n.eval()
    quantized_like(host, qnet)
    on_card = tuple(torch.from_numpy(a).cuda() for a in tok)
    on_host = tuple(torch.from_numpy(a) for a in tok)
    res = {"card": card(), "seq": seq,
           "k1": compare(qnet, host, host32, on_card, on_host)}
    kernel = fa.flash_attention_fwd
    fa.flash_attention_fwd = fa.flash_attention_fwd_reference
    try:
        res["plain"] = compare(qnet, host, host32, on_card, on_host)
        out_plain, _ = capture(qnet, on_card)
    finally:
        fa.flash_attention_fwd = kernel
    out_k1, _ = capture(qnet, on_card)
    out32_card, seen32_card = capture(card32, on_card, (Dense,))
    out32_host, seen32_host = capture(host32, on_host, (Dense,))
    res["k1_vs_plain_on_card"] = rel_max(out_k1, out_plain)
    res["f32_card_vs_cpu"] = rel_max(out32_card, out32_host)
    res["f32_layer_inputs_rel"] = max(
        rel_max(seen32_card[p][0], seen32_host[p][0]) for p in seen32_card)
    return res


def _print(res: dict) -> None:
    print(f"int8 BERT-base, 1 x {res['seq']} tokens, on {res['card']}: "
          f"int8 card with K1 vs with the plain attention "
          f"{res['k1_vs_plain_on_card']:.3g}; f32 card vs CPU "
          f"{res['f32_card_vs_cpu']:.3g} (the Dense inputs "
          f"{res['f32_layer_inputs_rel']:.3g}) (max |d| / max |CPU|)")
    for route in ("k1", "plain"):
        r = res[route]
        print(f"  card ({route} attention) vs CPU: free-running "
              f"{r['free_running_rel']:.3g}, the int8 net's own error "
              f"{r['int8_vs_f32_rel']:.3g}; pinned: inputs "
              f"{r['pinned_inputs_rel']:.3g}, outputs "
              f"{r['pinned_outputs_rel']:.3g}; {r['own_bitwise']} of "
              f"{len(r['layers'])} layers bitwise, the largest own error "
              f"{r['own_ulps']:.3g} ulps; first code flip "
              f"{r['first_flip']}; {r['codes_differing']} of "
              f"{r['codes']} codes differ")
        print("    layer, input rel, codes differing / codes, largest step, "
              "own max |d|")
        for row in r["layers"]:
            print(f"    {row['layer']:<32} {row['input_rel']:.3g} "
                  f"{row['codes_differing']}/{row['codes']} "
                  f"{row['max_code_step']} {row['own_max_abs']:.3g}"
                  f"{'' if row['own_bitwise'] else ' (not bitwise)'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_drift: needs a CUDA card", file=sys.stderr)
        return 1
    res = run(args.seed, args.seq)
    _print(res)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
