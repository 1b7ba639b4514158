"""Which kernels of the BERT-base training step give bitwise the same
result from the same inputs, on the card.

    python3 -m mxnet_tpu_torch.tools.grad_determinism [--seed 0]

The step is ``chip_smoke.py`` phase 16's: ``BERTForPretraining(bert_base(
max_length=128))``, bf16 compute over f32 masters, dropout 0.1, a 64 x 128
batch with P = 19 (``pretrain_batch``), at the seeded initial weights.

1. K1, K2 and K3 (the hand-written attention kernels) at the shapes of the
   dp=2 and tp=2 ranks, (32, 12, 128, 64) and (64, 6, 128, 64) bf16: each
   called 10 times on the same inputs, every result against the first,
   bitwise.
2. ``torch.nn.functional.embedding``'s backward alone at the three
   embedding tables' shapes (2, 128 and 30522 rows of 768, 64 x 128
   lookups, the token types drawn from {0, 1} as the batch's are): 10 calls
   against the first, bitwise.
3. The one-process step's gradient of every parameter, twice from the same
   inputs and the same dropout state, on each of 3 batches: the leaves
   whose gradient differs in any bit.
4. The same gradient once under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: the operations PyTorch flags as nondeterministic.
5. A two-rank ``{"tp": 2}`` job (``shard_for_tensor_parallel``, both ranks
   on the card over gloo, started by ``tools/launch.py``): each rank's
   gradients, before any reduction over tp, twice on each of the 3
   batches; the whole (unsharded) leaves whose gradient differs between
   the ranks, and within a rank between the two runs.
6. ResNet-50's first training step as phase 16(d) takes it (``resnet50_v1
   (classes=1000)`` with seeded weights, SGD(0.05, momentum 0.9), a batch
   of 32), in bf16 compute, in f32 with cuDNN's TF32 convolutions (the
   default) and in f32 without: the update from the batch against
   the update from the same batch with its two halves swapped (the same
   sums in another order), as the distance's share of the update's norm,
   over all parameters and for the leaves that carry most of it; and the
   BatchNorm inputs' worst conditioning, the smallest per-channel
   std / sqrt(mean^2 + std^2) of a layer.

Prints one JSON line at the end. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import numpy as np
import torch

from ..gluon.model_zoo.bert import (BERTForPretraining, BERTPretrainingLoss,
                                    bert_base, load_jax_params,
                                    shard_for_tensor_parallel)
from ..gluon.model_zoo.vision import resnet50_v1
from ..gluon.nn import BatchNorm
from ..optimizer import Adam
from ..parallel import ParallelTrainStep, collectives, make_mesh
from ..parallel.train_step import _tree_map
from . import (PretrainStep, card, pretrain_batch, resnet_batch,
               resnet_train_step, seeded_bert_weights, seeded_resnet_weights)

BATCH, SEQ, P, BATCHES = 64, 128, 19, 3
UNITS, REPEATS = 768, 10
SHAPES = ((32, 12, 128, 64), (64, 6, 128, 64))
RESNET_BATCH = 32


def _model(dropout=0.1):
    return BERTForPretraining(bert_base(max_length=SEQ, dropout=dropout))


def _step(named, mesh, tp=False, seed=0):
    model = _model()
    load_jax_params(model, named, ctx=mesh.ctx)
    if tp:
        shard_for_tensor_parallel(model)
    return ParallelTrainStep(PretrainStep(model), BERTPretrainingLoss(),
                             Adam(learning_rate=1e-4), mesh,
                             compute_dtype="bfloat16",
                             extra_specs=("dp", "dp"), seed=seed)


def _batches(seed):
    return pretrain_batch(np.random.default_rng(seed + 16), BATCHES, BATCH,
                          SEQ, P)


def gradients(step, batches, i):
    """Every parameter's gradient (None where unused) of the step's loss
    on batch ``i`` of the stacked ``batches``, before any reduction across
    ranks; the dropout generator is left as it was."""
    toks, (mlm, nsp), tt, pos = batches
    x, y, extras = step._local_inputs(toks[i], (mlm[i], nsp[i]),
                                      (tt[i], pos[i]))
    x, y = step._place(x), _tree_map(step._place, y)
    extras = tuple(step._place(e) for e in extras)
    state = step.generator.get_state()
    step._block.train()
    with step._mesh, step._rows, step._tp:
        loss = step._forward_loss(x, y, extras)
        grads = torch.autograd.grad(loss, step._plist, allow_unused=True)
    step.generator.set_state(state)
    return [None if g is None else g.detach() for g in grads]


def _differ(a, b):
    return not (a is None and b is None) and (
        a is None or b is None or not torch.equal(a, b))


def kernel_repeats(dev):
    """Part 1: whether each of K1-K3 gives the same bits on every call."""
    from ..ops.cuda import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape in SHAPES:
        q, k, v, dout = (torch.randn(shape, device=dev, generator=gen,
                                     dtype=torch.bfloat16) for _ in range(4))
        scale = shape[-1] ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, False)
        runs = {"K1": [], "K2": [], "K3": []}
        for _ in range(REPEATS):
            o2, lse2 = fa.flash_attention_fwd(q, k, v, scale, False)
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, dout, lse,
                                                  scale, False)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                scale, False)
            runs["K1"].append((o2, lse2))
            runs["K2"].append((dq, delta))
            runs["K3"].append((dk, dv))
        out[str(shape)] = {
            name: all(torch.equal(a, b) for r in rs[1:]
                      for a, b in zip(rs[0], r)) for name, rs in runs.items()}
    return out


def embedding_repeats(dev):
    """Part 2: whether the embedding backward gives the same bits on every
    call, at each table's shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for rows in (2, SEQ, 30522):
        ids = torch.randint(0, rows, (BATCH, SEQ), device=dev, generator=gen)
        w = torch.randn(rows, UNITS, device=dev, generator=gen,
                        dtype=torch.bfloat16, requires_grad=True)
        gout = torch.randn(BATCH, SEQ, UNITS, device=dev, generator=gen,
                           dtype=torch.bfloat16)
        runs = [torch.autograd.grad(torch.nn.functional.embedding(ids, w), w,
                                    gout)[0] for _ in range(REPEATS)]
        out[rows] = {
            "same": all(torch.equal(runs[0], r) for r in runs[1:]),
            "max_abs_diff": max((r.float() - runs[0].float()).abs().max()
                                .item() for r in runs[1:])}
    return out


def process_repeats(named, batches):
    """Parts 3 and 4: the leaves whose gradient differs between two runs
    on the same inputs, per batch; the deterministic-mode alerts."""
    step = _step(named, make_mesh({"dp": 1}))
    differ = []
    for i in range(BATCHES):
        a, b = gradients(step, batches, i), gradients(step, batches, i)
        differ.append({
            n: (x.float() - y.float()).abs().max().item()
            for n, x, y in zip(step._names, a, b) if _differ(x, y)})
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gradients(step, batches, 0)
    torch.use_deterministic_algorithms(False)
    alerts = sorted({str(w.message).splitlines()[0][:240] for w in caught
                     if "determinis" in str(w.message)})
    return differ, alerts


def _fingerprint(tensors):
    """Each tensor's bits summed as int64 (two tensors that differ in any
    bit almost surely differ here)."""
    return torch.stack([
        torch.zeros((), dtype=torch.int64, device=collectives.device())
        if t is None else t.float().contiguous().view(torch.int32)
        .sum(dtype=torch.int64) for t in tensors])


def tp_rank(seed):
    """Part 5 on this rank: prints one JSON line."""
    named = seeded_bert_weights(_model(), seed)
    batches = _batches(seed)
    step = _step(named, make_mesh({"tp": 2}), tp=True, seed=seed)
    whole = [i for i in range(len(step._plist)) if i not in step._shards]
    across, within = [], []
    for i in range(BATCHES):
        a, b = gradients(step, batches, i), gradients(step, batches, i)
        within.append([step._names[j] for j in whole if _differ(a[j], b[j])])
        fp = collectives.world_all_gather(_fingerprint([a[j] for j in whole]))
        across.append([step._names[j] for j, bad in
                       zip(whole, (fp != fp[0]).any(0).tolist()) if bad])
    line = {"rank": collectives.rank(), "backend": collectives.backend(),
            "whole_leaves": len(whole), "differ_across_ranks": across,
            "differ_within_rank": within}
    os.write(1, (json.dumps(line) + "\n").encode())   # ranks share the pipe
    collectives.barrier()
    return 0


def tp_job(seed, timeout=600):
    """Part 5: the two ranks' lines."""
    from . import launch
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, MXNET_DIST_TIMEOUT="300",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = launch.run(2, [sys.executable, "-m",
                          f"{__package__}.grad_determinism", "--tp-rank",
                          "--seed", str(seed)], timeout, env)
    if proc.returncode != 0:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise SystemExit(f"grad_determinism: the tp job exited "
                         f"{proc.returncode}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return sorted(lines, key=lambda ln: ln["rank"])


def _bn_conditioning(block):
    """Forward hooks on every BatchNorm of ``block`` recording, per layer,
    the smallest per-channel std / sqrt(mean^2 + std^2) of its input (how
    much of E[x^2] the variance is); returns the dict and the handles."""
    worst, handles = {}, []
    for name, mod in block.named_modules():
        if isinstance(mod, BatchNorm):
            def pre(mod, args, name=name):
                x = args[0].detach().double().transpose(0, 1).flatten(1)
                mean, std = x.mean(1), x.std(1)
                worst[name] = (std / (mean.square() + std.square()).sqrt()
                               .clamp_min(1e-300)).min().item()
            handles.append(torch.nn.Module.register_forward_pre_hook(
                mod, pre))    # torch's removable hook
    return worst, handles


def resnet_order(seed, compute_dtype, tf32=True):
    """Part 6 in ``compute_dtype`` (cuDNN's TF32 convolutions on or off):
    the update's distance between the batch and its halves swapped,
    overall and for the 5 leaves that carry most of it, and the 3
    worst-conditioned BatchNorm inputs."""
    own_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    named = seeded_resnet_weights(resnet50_v1(classes=1000), seed)
    xs, ys = resnet_batch(np.random.default_rng(seed + 17), 1,
                          RESNET_BATCH)
    half = RESNET_BATCH // 2
    swap = np.r_[half:RESNET_BATCH, 0:half]
    updates, worst = [], {}
    for order in (slice(None), swap):
        st = resnet_train_step(named, compute_dtype)
        w0 = {k: v.detach().double().cpu() for k, v in st.params.items()}
        seen, handles = _bn_conditioning(st._block)
        st(xs[0][order], ys[0][order]).item()
        for h in handles:
            h.remove()
        worst = worst or seen
        updates.append({k: v.detach().double().cpu() - w0[k]
                        for k, v in st.params.items()})
        del st
    torch.backends.cudnn.allow_tf32 = own_tf32
    a, b = updates
    sq = {k: (a[k] - b[k]).square().sum().item() for k in a}
    norm = sum(v.square().sum().item() for v in a.values()) ** 0.5
    top = sorted(sq, key=lambda k: -sq[k])[:5]
    return {"update_rel": sum(sq.values()) ** 0.5 / norm,
            "leaves": {k: {"share_of_distance": sq[k] / sum(sq.values()),
                           "leaf_rel": sq[k] ** 0.5 /
                           max(a[k].norm().item(), 1e-300)} for k in top},
            "worst_bn_inputs": dict(sorted(worst.items(),
                                           key=lambda kv: kv[1])[:3])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp-rank", action="store_true",
                    help="run as one rank of part 5's job")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_determinism: no CUDA device", file=sys.stderr)
        return 1
    if args.tp_rank:
        return tp_rank(args.seed)
    dev = torch.device("cuda", 0)
    smi = card()
    kernels = kernel_repeats(dev)
    print(f"1. K1-K3, {REPEATS} calls each on the same inputs, bitwise equal "
          f"to the first: {json.dumps(kernels)} on {smi}")
    emb = embedding_repeats(dev)
    print(f"2. F.embedding backward bf16, {BATCH} x {SEQ} lookups, "
          f"{REPEATS} calls, by table rows: {json.dumps(emb)}")
    named = seeded_bert_weights(_model(), args.seed)
    batches = _batches(args.seed)
    differ, alerts = process_repeats(named, batches)
    print(f"3. one process, gradients twice on each of {BATCHES} batches: "
          f"leaves that differ (largest |difference|) {json.dumps(differ)}")
    print(f"4. deterministic-mode alerts: {json.dumps(alerts)}")
    torch.cuda.empty_cache()
    resnet = {name: resnet_order(args.seed, d, tf32) for name, d, tf32 in (
        ("bf16", "bfloat16", True), ("f32, TF32 convolutions", None, True),
        ("f32", None, False))}
    for name, r in resnet.items():
        print(f"6. ResNet-50 first step, {name} compute, halves swapped: "
              f"{json.dumps(r)}")
    torch.cuda.empty_cache()
    ranks = tp_job(args.seed)
    for r in ranks:
        print(f"5. tp=2 rank {r['rank']} ({r['backend']}), "
              f"{r['whole_leaves']} whole leaves: differ across ranks "
              f"{json.dumps(r['differ_across_ranks'])}, within the rank "
              f"{json.dumps(r['differ_within_rank'])}")
    print(json.dumps({"card": smi, "seed": args.seed, "kernels": kernels,
                      "embedding": {str(k): v for k, v in emb.items()},
                      "one_process_differ": differ, "alerts": alerts,
                      "resnet_order": resnet, "tp_ranks": ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
