"""Worker of tests/test_torch_resilience_elastic.py: sharded checkpoints of
one rank of a {"tp": 2} job on the CPU (gloo).

Started by ``mxnet_tpu_torch/tools/launch.py -n 2 -- python3
tests/torch_resilience_worker.py DIR``. The test writes the inputs to
``DIR/inputs.npz``: a small BERT's weights and batches, the DLRM table's
weights and batches. Each rank trains the tensor-parallel BERT three steps
and saves a sharded checkpoint under ``DIR/bert`` (every rank its own shard
file), then two more steps; the DLRM step in ``sharded`` mode three steps
and a sharded checkpoint under ``DIR/dlrm``. Rank 0 writes the gathered
states and the losses to ``DIR/worker.npz``; one JSON line a rank.
"""
import json
import os
import sys

import numpy as onp
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import optimizer, parallel
from mxnet_tpu_torch.embedding import DLRMTrainStep, ShardedEmbedding
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.parallel import collectives
from mxnet_tpu_torch.resilience import CheckpointManager, RetryPolicy, faults
from mxnet_tpu_torch.tools import PretrainStep

torch.set_num_threads(1)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()


def bert_step(inp, mesh, tp):
    cfg = json.loads(str(inp["bert_cfg"]))
    model = bert.BERTForPretraining(bert.BERTModel(**cfg),
                                    vocab_size=cfg["vocab_size"])
    names = [str(n) for n in inp["bert_names"]]
    bert.load_jax_params(model, {n: inp[f"bert_{n}"] for n in names},
                         ctx=CPU)
    if tp:
        bert.shard_for_tensor_parallel(model)
    return parallel.ParallelTrainStep(
        PretrainStep(model), bert.BERTPretrainingLoss(),
        optimizer.Adam(learning_rate=1e-3), mesh, extra_specs=(None, None),
        seed=3)


def bert_batch(inp, i):
    toks, tt, pos, mlm, nsp = (inp[f"bert_{k}"] for k in
                               ("toks", "tt", "pos", "mlm", "nsp"))
    return toks[i], (mlm[i], nsp[i]), tt[i], pos[i]


def flat(state, prefix):
    out = {}
    for k, v in state["params"].items():
        out[f"{prefix}_params_{k}"] = v
    for j, leaves in state["opt"].items():
        for k, v in leaves.items():
            out[f"{prefix}_opt_{j}_{k}"] = v
    return out


def main():
    path = sys.argv[1]
    inp = dict(onp.load(os.path.join(path, "inputs.npz")))
    mesh = parallel.make_mesh({"tp": 2}, ctx=CPU)
    rank = collectives.rank()
    out = {}
    with CPU:
        step = bert_step(inp, mesh, tp=True)
        losses = [float(step(*bert_batch(inp, i))) for i in range(3)]
        cm = CheckpointManager(os.path.join(path, "bert"), fsync=False)
        cm.save(3, train_step=step, sharded=True)
        out.update(flat(step.state_dict(), "bert3"))
        losses += [float(step(*bert_batch(inp, i))) for i in range(3, 5)]
        out.update(flat(step.state_dict(), "bert5"))
        out["bert_losses"] = onp.asarray(losses, onp.float64)

        table = ShardedEmbedding(int(inp["vocab"]), int(inp["dim"]), mesh,
                                 axis="tp", weight=inp["w0"])
        cfg = [int(v) for v in inp["cfg"]]
        dlrm = DLRMTrainStep(table, cfg[0], cfg[1], bot_hidden=cfg[2],
                             top_hidden=cfg[3], lr=float(inp["lr"]),
                             mode="sharded",
                             retry=RetryPolicy(max_attempts=3, base_ms=0.0))
        batches = [(inp["dense"][i], inp["idx"][i], inp["y"][i])
                   for i in range(inp["dense"].shape[0])]
        with faults.inject("emb_exchange", every_n=2) as inj:
            out["dlrm_losses"] = onp.asarray([dlrm(b) for b in batches])
        out["dlrm_fires"] = onp.asarray(inj.fires)
        CheckpointManager(os.path.join(path, "dlrm"), fsync=False).save(
            len(batches), train_step=dlrm, sharded=True)
        st = dlrm.state_dict()
        out["dlrm_table"] = st["table"]
        for k, v in st["mlp"].items():
            out[f"dlrm_mlp_{k}"] = v
    if rank == 0:
        onp.savez(os.path.join(path, "worker.npz"), **out)
    line = json.dumps({"rank": rank, "ok": True})
    os.write(1, (line + "\n").encode())   # one write: ranks share the pipe
    collectives.barrier()


if __name__ == "__main__":
    sys.exit(main())
