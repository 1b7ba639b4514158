"""How far the f32 ResNet-50 training step is from the f64 one, on the card
and on the CPU, and where the distance comes from.

    python3 -m mxnet_tpu_torch.tools.f32_drift [--seed 0]

Runs the step ``chip_smoke.py``'s f32 check runs (``resnet50_v1(classes=
1000)`` with seeded weights, ``SGD(0.05, momentum 0.9)``, one batch of 2
images drawn from ``seed + 5``) three times: in f32 on the card, in f32 on
the CPU and in f64 on the CPU (f32 masters, f64 compute). Against the f64
run it reports:

- the input of every ReLU and every bottleneck in the forward: its relative
  error (norm) and the number of elements whose sign differs, i.e. ReLU
  mask flips;
- each parameter's update (w before - w after, lr x its gradient on a first
  SGD step): its distance in norm and in largest element, and the leaves
  that carry most of the distance.

Prints one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import cpu
from ..gluon.model_zoo.vision import resnet50_v1
from ..gluon.nn import Activation
from . import card, resnet_batch, resnet_train_step, seeded_resnet_weights

_RUNS = (("card", None, None), ("cpu", cpu(), None), ("f64", cpu(), "float64"))


def step_runs(named, seed: int, layers: bool = False):
    """The f32 check's step, three times: ``{"card" | "cpu" | "f64": {"loss",
    "w0", "update", "buffers", "layers"}}``, all on the CPU in float64 but
    the buffers. ``layers`` records the inputs of every ReLU and bottleneck
    (by module name)."""
    xs, ys = resnet_batch(np.random.default_rng(seed + 5), 1, 2)
    out = {}
    for tag, ctx, dtype in _RUNS:
        st = resnet_train_step(named, dtype, ctx=ctx)
        seen, handles = {}, []
        if layers:
            for name, mod in st._block.named_modules():
                if isinstance(mod, Activation) or name.endswith("body"):
                    def pre(mod, args, name=name):
                        seen[name] = args[0].detach().double().cpu()
                    handles.append(mod.register_forward_pre_hook(pre))
        w0 = {k: v.detach().cpu().clone() for k, v in st.params.items()}
        loss = st(xs[0], ys[0]).item()
        for h in handles:
            h.remove()
        out[tag] = {"loss": loss, "w0": w0,
                    "update": {k: (w0[k] - v.detach().cpu()).double()
                               for k, v in st.params.items()},
                    "buffers": {k: v.cpu() for k, v in st.buffers.items()},
                    "layers": seen}
        del st
    return out


def stage_of(jax_name: str) -> str:
    """The part of a ResNet v1 a parameter belongs to, from its JAX name
    without the net's prefix: "stage1".."stage4", "dense" or "stem"."""
    head = jax_name.split("_")[0]
    if head.startswith("stage"):
        return head
    return "dense" if head.startswith("dense") else "stem"


def leaf_distances(runs, jax_names):
    """Per parameter: the f64 update's norm and largest element, the card's
    and the CPU's f32 distance to it (``card_norm``, ``card_max``,
    ``cpu_norm``, ``cpu_max``), one f32 ulp of the weights in norm and max
    (w after is rounded to f32 in all three runs), and its ``stage``."""
    w0 = runs["card"]["w0"]
    leaves = {}
    for k, ref in runs["f64"]["update"].items():
        d_card = runs["card"]["update"][k] - ref
        d_cpu = runs["cpu"]["update"][k] - ref
        ulp = 2.0 ** -23 * w0[k].double().abs()
        leaves[k] = {
            "stage": stage_of(jax_names[k]), "size": ref.numel(),
            "update_norm": ref.norm().item(),
            "update_max": ref.abs().max().item(),
            "card_norm": d_card.norm().item(), "cpu_norm": d_cpu.norm().item(),
            "card_max": d_card.abs().max().item(),
            "cpu_max": d_cpu.abs().max().item(),
            "ulp_norm": ulp.norm().item(), "ulp_max": ulp.max().item()}
    return leaves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_drift: no CUDA device", file=sys.stderr)
        return 1
    probe = resnet50_v1(classes=1000)
    runs = step_runs(seeded_resnet_weights(probe, args.seed), args.seed,
                     layers=True)
    print(f"card: {card()}")
    print("losses: " + ", ".join(f"{t} {r['loss']:.7f}"
                                 for t, r in runs.items()))
    layers = []
    for name, ref in runs["f64"]["layers"].items():
        row = {"layer": name, "size": ref.numel()}
        for tag in ("card", "cpu"):
            got = runs[tag]["layers"][name]
            row[f"{tag}_rel"] = ((got - ref).norm() / ref.norm()).item()
            row[f"{tag}_flips"] = int(((got > 0) != (ref > 0)).sum())
        layers.append(row)
        print(f"  {name:28s} {row['size']:9d} elements: relative error "
              f"card {row['card_rel']:.3g}, CPU {row['cpu_rel']:.3g}; sign "
              f"flips card {row['card_flips']}, CPU {row['cpu_flips']}")
    leaves = leaf_distances(runs, probe.jax_names())
    total = sum(v["update_norm"] ** 2 for v in leaves.values()) ** 0.5
    share = {t: sum(v[f"{t}_norm"] ** 2 for v in leaves.values()) ** 0.5
             / total for t in ("card", "cpu")}
    cpu_sq = (share["cpu"] * total) ** 2
    print(f"update vs f64, all parameters: card {share['card']:.4g}, CPU "
          f"{share['cpu']:.4g} of its norm")
    for k in sorted(leaves, key=lambda k: -leaves[k]["cpu_norm"])[:8]:
        v = leaves[k]
        print(f"  {k:36s} {v['cpu_norm'] ** 2 / cpu_sq:6.1%} of the CPU's "
              f"distance; card {v['card_norm'] / v['update_norm']:.4g}, CPU "
              f"{v['cpu_norm'] / v['update_norm']:.4g} of the leaf's update")
    print(json.dumps({"card": card(), "seed": args.seed,
                      "losses": {t: r["loss"] for t, r in runs.items()},
                      "update_distance": share, "layers": layers,
                      "leaves": leaves}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
