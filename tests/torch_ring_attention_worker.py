"""Worker of tests/test_torch_ring_attention.py: the port's ring attention
on one rank of an {"sp": n} job on the CPU (gloo).

Started by ``mxnet_tpu_torch/tools/launch.py -n N -- python3
tests/torch_ring_attention_worker.py DIR``. The test writes the cases to
``DIR/inputs.npz`` (``names`` and, per case, the global q, k, v, the
loss's weights w and ``causal``); every rank runs
``parallel.ring_self_attention`` on each case, takes the gradient of
``(out * w).sum()`` and writes the output and the gradients of q, k and v
to ``DIR/ring_r<rank>.npz``, then prints one JSON line.
"""
import json
import os
import sys

import numpy as onp
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import collectives

torch.set_num_threads(1)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))


def main():
    path = sys.argv[1]
    inp = dict(onp.load(os.path.join(path, "inputs.npz")))
    mesh = parallel.make_mesh({"sp": -1}, ctx=mt.cpu())
    out = {}
    for name in inp["names"]:
        q, k, v = (torch.tensor(inp[f"{name}_{t}"], requires_grad=True)
                   for t in "qkv")
        o = parallel.ring_self_attention(q, k, v, mesh,
                                         causal=bool(inp[f"{name}_causal"]))
        (o * torch.tensor(inp[f"{name}_w"])).sum().backward()
        out[f"{name}_out"] = o.detach().numpy()
        for t, x in zip("qkv", (q, k, v)):
            out[f"{name}_d{t}"] = x.grad.numpy()
    rank = collectives.rank()
    onp.savez(os.path.join(path, f"ring_r{rank}.npz"), **out)
    line = json.dumps({"rank": rank, "sp": mesh.axis_size("sp"),
                       "ok": True})
    os.write(1, (line + "\n").encode())   # one write: ranks share the pipe
    collectives.barrier()


if __name__ == "__main__":
    sys.exit(main())
