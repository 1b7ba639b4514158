"""Worker of tests/test_torch_embedding.py: the port's vocab-sharded table
and DLRM step on one rank of a {"tp": n} job on the CPU (gloo).

Started by ``mxnet_tpu_torch/tools/launch.py -n N -- python3
tests/torch_embedding_worker.py DIR``. The test writes the inputs to
``DIR/inputs.npz`` (the table's initial weights ``w0``, the DLRM batches,
the lookup ids and each rank's dispatch ids); every rank writes, per
layout, its lookups, its dispatched rows and four replicated-mode steps'
losses, table and MLP; on more than one rank four sharded-mode steps with
the kvstore calls they made (every kvstore method is wrapped to count) and
the table's exchange bytes; on two ranks the cyclic table's state after
three steps (rank 0 writes it) and three more steps. Results go to
``DIR/emb_n<N>_r<rank>.npz``, then one JSON line is printed.
"""
import json
import os
import sys

import numpy as onp
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore, parallel
from mxnet_tpu_torch.embedding import DLRMTrainStep, ShardedEmbedding
from mxnet_tpu_torch.parallel import collectives

torch.set_num_threads(1)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

KV_METHODS = ("__init__", "init", "push", "pull", "pushpull", "broadcast",
              "row_sparse_pull")


def count_kvstore_calls():
    """Wrap every kvstore class's methods to count calls; the counter."""
    calls = {"n": 0}
    classes = [kvstore.base.KVStoreBase, kvstore.KVStore,
               kvstore.collective.Collective]
    for cls in classes:
        for name in KV_METHODS:
            fn = cls.__dict__.get(name)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, **kw):
                calls["n"] += 1
                return _fn(*a, **kw)
            setattr(cls, name, wrapped)
    return calls


def batches(inp, key):
    return [(inp[f"{key}_dense"][i], inp[f"{key}_idx"][i], inp[f"{key}_y"][i])
            for i in range(inp[f"{key}_dense"].shape[0])]


def step_of(inp, mesh, layout, mode="replicated"):
    table = ShardedEmbedding(int(inp["vocab"]), int(inp["dim"]), mesh,
                             axis="tp", layout=layout, weight=inp["w0"])
    cfg = [int(v) for v in inp["cfg"]]   # dense_in, fields, bot, top
    return table, DLRMTrainStep(table, cfg[0], cfg[1], bot_hidden=cfg[2],
                                top_hidden=cfg[3], lr=float(inp["lr"]),
                                seed=0, mode=mode)


def run(step, data, out, prefix):
    out[f"{prefix}_losses"] = onp.asarray([step(b) for b in data])
    out[f"{prefix}_table"] = step.table.dense_weight()
    for k, v in step.mlp.items():
        out[f"{prefix}_mlp_{k}"] = v.numpy().copy()


def main():
    path = sys.argv[1]
    inp = dict(onp.load(os.path.join(path, "inputs.npz")))
    calls = count_kvstore_calls()
    mesh = parallel.make_mesh({"tp": -1}, ctx=mt.cpu())
    n, rank = mesh.axis_size("tp"), collectives.rank()
    out = {}
    for layout in ("block", "cyclic"):
        table, step = step_of(inp, mesh, layout)
        out[f"{layout}_lookup"] = table.lookup(inp["lookup_idx"]).numpy()
        out[f"{layout}_dense"] = table.dense_weight()
        per = inp["dispatch_ids"].reshape(n, -1)[rank]
        out[f"{layout}_dispatch"] = table.dispatch_gather(
            torch.from_numpy(per)).numpy()
        run(step, batches(inp, "train"), out, f"{layout}_rep")
    res = {"rank": rank, "n": n}
    if n > 1:
        table, step = step_of(inp, mesh, "block", "sharded")
        before = calls["n"]
        run(step, batches(inp, "sharded"), out, "sharded")
        res.update(mode=step.mode, kv_calls=calls["n"] - before,
                   exchange=table.exchange_bytes)
    if n == 2:
        data = batches(inp, "elastic")
        table, step = step_of(inp, mesh, "cyclic")
        for b in data[:3]:
            step(b)
        state = step.state_dict()
        if rank == 0:
            onp.savez(os.path.join(path, "elastic_state.npz"),
                      table=state.pop("table"),
                      **{f"mlp_{k}": v for k, v in state.pop("mlp").items()},
                      meta=json.dumps(state))
        out["elastic_tail"] = onp.asarray([step(b) for b in data[3:]])
        out["elastic_table"] = table.dense_weight()
    onp.savez(os.path.join(path, f"emb_n{n}_r{rank}.npz"), **out)
    os.write(1, (json.dumps(res) + "\n").encode())  # one write: shared pipe
    collectives.barrier()


if __name__ == "__main__":
    sys.exit(main())
