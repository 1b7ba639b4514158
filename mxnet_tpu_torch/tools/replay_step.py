"""Replay an SDC repro bundle that the port's NumericsGuard wrote (the
counterpart of the repository's ``tools/replay_step.py``).

A bundle holds the ParallelTrainStep state before the screened window,
every retained batch with the generator state and lr/wd rows it consumed,
and the two digests that disagreed: the live run's and the screening
re-execution's. The step is deterministic, so a healthy machine that
re-runs the bundle lands on one of them::

    python3 -m mxnet_tpu_torch.tools.replay_step BUNDLE [--builder m:f]
        [--ctx cpu|gpu]

Verdicts (the JSON ``verdict`` field): ``live_corrupt`` (the re-run
matches the screening digest: the live pass was corrupted; rewind to a
checkpoint before the bundle's step), ``replay_corrupt`` (it matches the
live digest: the screening re-execution was hit; the state is fine),
``no_reproduction`` (neither: the environment differs). ``bitwise`` says
whether the re-run matched a recorded digest exactly. Exit code 0 when it
did.

The step is rebuilt by ``--builder module:function``, a callable
``builder(meta, ctx) -> ParallelTrainStep``, or from the bundle's
``repro`` metadata (``in_dim``, ``hidden``, ``out_dim``, ``lr``, ``seed``)
as a Dense-ReLU-Dense net trained with Adam and L2Loss.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as onp
import torch


def demo_mlp_builder(meta, ctx):
    """The Dense-ReLU-Dense step of the bundle's ``repro`` dims."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import gluon, optimizer, parallel

    r = meta.get("repro", {})
    in_dim, hidden = int(r.get("in_dim", 8)), int(r.get("hidden", 16))
    out_dim, lr = int(r.get("out_dim", 4)), float(r.get("lr", 0.05))
    mt.random.seed(int(r.get("seed", 0)))
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(hidden, activation="relu", in_units=in_dim),
            gluon.nn.Dense(out_dim, in_units=hidden))
    net.initialize(mt.init.Xavier(), ctx=ctx)
    return parallel.ParallelTrainStep(
        net, gluon.loss.L2Loss(), optimizer.Adam(learning_rate=lr),
        parallel.make_mesh({"dp": 1}, ctx=ctx))


def _load_builder(spec):
    mod, _, attr = spec.partition(":")
    if not attr:
        raise SystemExit(f"--builder must be module:function, got {spec!r}")
    return getattr(importlib.import_module(mod), attr)


def load_bundle(path):
    """(meta, state tree, records) of a bundle directory: the state is
    ``ParallelTrainStep.load_state_dict``'s, each record a dict of host
    arrays with its generator state (``key``)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("kind") != "sdc_bundle":
        raise SystemExit(f"{path} is not an SDC bundle "
                         f"(kind={meta.get('kind')!r})")
    with onp.load(os.path.join(path, "state.npz"), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    params = {k: v for k, v in arrays.items()
              if k.startswith("p") and "_" not in k}
    opt = {f"s{j}": {f"l{k}": arrays[f"s{j}_l{k}"] for k in range(arity)}
           for j, arity in enumerate(meta["opt_arities"])}
    state = {"kind": "ParallelTrainStep", "version": 1, "t": int(meta["t"]),
             "n_params": len(params), "param_names": "", "params": params,
             "opt": opt}
    if "generator" in arrays:
        state["generator"] = arrays["generator"]
    records = []
    with onp.load(os.path.join(path, "records.npz"), allow_pickle=False) as z:
        for i, rm in enumerate(meta["records"]):
            if rm.get("key_impl") != "torch":
                raise SystemExit(f"record {i} holds a {rm.get('key_impl')!r} "
                                 "key: not a bundle of the port")
            y = tuple(z[f"r{i}_y{j}"] for j in range(int(rm["n_y"])))
            records.append({
                "x": z[f"r{i}_x"],
                "y": y if rm.get("y_tuple") else y[0],
                "extras": tuple(z[f"r{i}_e{j}"]
                                for j in range(int(rm["n_extras"]))),
                "key": torch.from_numpy(onp.array(z[f"r{i}_key"], onp.uint8)),
                "lrs": z[f"r{i}_lrs"], "wds": z[f"r{i}_wds"],
                "t": int(rm["t"]), "poison": rm.get("poison")})
    return meta, state, records


def replay(path, builder=None, ctx=None):
    """Re-execute a bundle; the result dict (see the module docstring)."""
    from mxnet_tpu_torch.resilience.numerics import _digest_arrays

    meta, state, records = load_bundle(path)
    if ctx is None:
        import mxnet_tpu_torch as mt
        ctx = mt.gpu(0)
    ts = (builder or demo_mlp_builder)(meta, ctx)
    ts.load_state_dict(state)
    pre_digest = _digest_arrays(ts._ordered_tensors())
    dev = ts._device

    def put(a):
        return torch.from_numpy(onp.ascontiguousarray(a)).to(dev)

    for rec in records:
        y = tuple(put(a) for a in rec["y"]) if isinstance(rec["y"], tuple) \
            else put(rec["y"])
        ts.replay_exact(put(rec["x"]), y, tuple(put(e) for e in
                                               rec["extras"]),
                        rec["key"], rec["lrs"], rec["wds"], rec["t"],
                        poison=rec["poison"])
    digest = _digest_arrays(ts._ordered_tensors())
    live, screen = meta["digest_live"], meta["digest_replay"]
    verdict = ("live_corrupt" if digest == screen else
               "replay_corrupt" if digest == live else "no_reproduction")
    return {"bundle": path, "verdict": verdict,
            "bitwise": verdict != "no_reproduction",
            "pre_digest_ok": pre_digest == meta.get("pre_digest"),
            "replayed_digest": digest, "digest_live": live,
            "digest_replay": screen, "n_records": len(records),
            "t": int(meta["t"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", help="SDC bundle directory (sdc-tNNNNNNNN-*)")
    ap.add_argument("--builder", default=None,
                    help="module:function returning a compatible "
                         "ParallelTrainStep (default: the bundle's MLP)")
    ap.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu",
                    help="where the step runs (default: the card)")
    args = ap.parse_args(argv)
    import mxnet_tpu_torch as mt
    ctx = mt.gpu(0) if args.ctx == "gpu" else mt.cpu()
    builder = _load_builder(args.builder) if args.builder else None
    result = replay(args.bundle, builder=builder, ctx=ctx)
    print(json.dumps(result, sort_keys=True))
    return 0 if result["bitwise"] else 1


if __name__ == "__main__":
    sys.exit(main())
