"""Worker of tests/test_torch_parallel.py and test_torch_sync_batchnorm.py:
the port's side of the JAX package's tests/test_parallel.py cases, run as
one rank of a job on the CPU (gloo).

Started by ``mxnet_tpu_torch/tools/launch.py -n N -- python3
tests/torch_dist_parallel_worker.py MODE DIR``. The test writes the inputs
(made with numpy from a seed, and the reference's initial weights) to
``DIR/inputs.npz``; every rank writes what it trained to
``DIR/MODE_r<rank>.npz`` and prints one JSON line at its end.

Modes: ``two`` (2 ranks: Dense on dp=2, Dense-BatchNorm-Dense on dp=2,
step_n against step on dp=2), ``four`` (4 ranks: Dense on dp=4, Dense
sharded over tp on {"dp": 2, "tp": 2} and over fsdp on {"dp": 2,
"fsdp": 2}, a 2-layer BERT with
shard_for_tensor_parallel on {"dp": 2, "tp": 2}, mesh shapes) and ``sync``
(2 ranks: the SyncBatchNorm op and layer).
"""
import json
import os
import sys

import numpy as onp
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon, nd, optimizer, parallel
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.optimizer import lr_scheduler
from mxnet_tpu_torch.parallel import collectives

torch.set_num_threads(1)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CPU = mt.cpu()


def _set(net, arrays):
    """The reference's parameter values, in ``collect_params`` order."""
    params = list(net.collect_params().values())
    assert len(params) == len(arrays)
    for p, a in zip(params, arrays):
        p.set_data(nd.array(a, ctx=CPU))


def _values(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def dense_dp(inp, axes, out):
    net = nn.Dense(1, in_units=8)
    net.initialize(mt.init.Constant(0.05), ctx=CPU)
    step = parallel.ParallelTrainStep(
        net, gloss.L2Loss(), optimizer.SGD(learning_rate=0.1),
        parallel.make_mesh(axes, ctx=CPU))
    for _ in range(3):
        step(inp["dense_x"], inp["dense_y"])
    step.sync_to_block()
    out["dense_w"] = net.weight.data().asnumpy().copy()


def bn_dp(inp, out):
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4), nn.BatchNorm(in_channels=8),
            nn.Dense(2, in_units=8))
    net.initialize(ctx=CPU)
    _set(net, [inp[f"bn_p{i}"] for i in range(int(inp["bn_n"]))])
    step = parallel.ParallelTrainStep(
        net, gloss.L2Loss(), optimizer.SGD(learning_rate=0.01),
        parallel.make_mesh({"dp": 2}, ctx=CPU))
    for _ in range(2):
        step(inp["bn_x"], inp["bn_y"])
    step.sync_to_block()
    for i, a in enumerate(_values(net)):
        out[f"bn_p{i}"] = a


def step_n_dp(inp, out):
    def build():
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu", in_units=8),
                nn.Dense(4, in_units=16))
        net.initialize(ctx=CPU)
        _set(net, [inp[f"sn_p{i}"] for i in range(4)])
        sched = lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = optimizer.Adam(learning_rate=0.05, lr_scheduler=sched)
        return net, parallel.ParallelTrainStep(
            net, gloss.SoftmaxCrossEntropyLoss(), opt,
            parallel.make_mesh({"dp": 2}, ctx=CPU))

    X, Y = inp["sn_x"], inp["sn_y"]
    net1, s1 = build()
    losses1 = [float(s1(X[i], Y[i])) for i in range(6)]
    net2, s2 = build()
    losses2 = list(s2.step_n(X[:3], Y[:3]).numpy()) + \
        list(s2.step_n(X[3:], Y[3:]).numpy())
    assert losses1 == losses2, (losses1, losses2)
    for a, b in zip(_values(net1), _values(net2)):
        assert (a == b).all()
    out["sn_losses"] = onp.asarray(losses1, onp.float32)
    for i, a in enumerate(_values(net1)):
        out[f"sn_p{i}"] = a


def sharded_dense(inp, out, axis):
    """Dense's weight split over ``axis`` of {"dp": 2, axis: 2}: "tp"
    with the batch whole along it, "fsdp" with the batch split over both
    axes."""
    net = nn.Dense(32, in_units=16)
    net.initialize(ctx=CPU)
    net.weight.set_data(nd.array(inp["tp_w"], ctx=CPU))
    net.bias.set_data(nd.zeros((32,), ctx=CPU))
    net.weight.shard(parallel.shard_spec(axis, None))
    mesh = parallel.make_mesh({"dp": 2, axis: 2}, ctx=CPU)
    spec = None if axis == "tp" else parallel.shard_spec(("dp", axis))
    step = parallel.ParallelTrainStep(
        net, gloss.L2Loss(), optimizer.SGD(learning_rate=0.05), mesh,
        data_spec=spec)
    assert tuple(step.params["weight"].shape) == (16, 16)
    for _ in range(2):
        step(inp["tp_x"], inp["tp_y"])
    step.sync_to_block()
    out[f"{axis}_w"] = net.weight.data().asnumpy().copy()


class _PretrainStep(bert.BERTForPretraining):
    """(tokens, token types, masked positions) -> both heads."""

    def forward(self, tokens, token_types, positions):
        return super().forward(tokens, token_types, None, positions)


def bert_tp(inp, out):
    cfg = json.loads(str(inp["bert_cfg"]))
    model = _PretrainStep(bert.BERTModel(**cfg),
                          vocab_size=cfg["vocab_size"])
    names = [str(n) for n in inp["bert_names"]]
    bert.load_jax_params(model, {n: inp[f"bert_{n}"] for n in names},
                         ctx=CPU)
    assert bert.shard_for_tensor_parallel(model) == 6 * cfg["num_layers"] + 1
    mesh = parallel.make_mesh({"dp": 2, "tp": 2}, ctx=CPU)
    step = parallel.ParallelTrainStep(
        model, bert.BERTPretrainingLoss(),
        optimizer.SGD(learning_rate=0.05, momentum=0.9), mesh,
        extra_specs=("dp", "dp"))
    qkv = step.params["backbone.encoder.layer0.attention.qkv.weight"]
    assert tuple(qkv.shape) == (3 * cfg["units"] // 2, cfg["units"])
    toks, tt, pos, mlm, nsp = (inp[f"bert_{k}"] for k in
                               ("toks", "tt", "pos", "mlm", "nsp"))
    losses = [float(step(toks[i], (mlm[i], nsp[i]), tt[i], pos[i]))
              for i in range(toks.shape[0])]
    step.sync_to_block()
    out["bert_losses"] = onp.asarray(losses, onp.float32)
    for n, p in model._collect_params_with_prefix().items():
        out[f"bert_{n}"] = p.data().asnumpy().copy()


def mesh_shapes(out):
    mesh = parallel.make_mesh({"dp": 2, "tp": 2}, ctx=CPU)
    assert mesh.size == 4 and mesh.shape == {"dp": 2, "tp": 2}
    r = collectives.rank()
    assert (mesh.axis_index("dp"), mesh.axis_index("tp")) == (r // 2, r % 2)
    assert parallel.make_mesh({"dp": -1, "tp": 2}, ctx=CPU).shape["dp"] == 2
    with mesh:
        t = torch.tensor([float(r)])
        assert float(parallel.all_reduce(t, "tp")) == \
            float(2 * (r // 2) * 2 + 1)
        g = parallel.all_gather(t, "dp")
        assert g.tolist() == [float(r % 2), float(2 + r % 2)]
        assert parallel.axis_size("tp") == 2
        base = 2 * (r // 2)
        rs = parallel.reduce_scatter(torch.arange(2.0) + r, "tp")
        assert rs.tolist() == [float(2 * base + 1 + 2 * (r % 2))]
        perm = parallel.ppermute(t, "tp", [(0, 1), (1, 0)])
        assert float(perm) == float(r + 1 if r % 2 == 0 else r - 1)
        a2a = parallel.all_to_all(torch.tensor([10.0 * r, 10.0 * r + 1]),
                                  "tp", 0, 0)
        assert a2a.tolist() == [10.0 * base + r % 2,
                                10.0 * (base + 1) + r % 2]
        # the backwards, under "every rank's loss is a term": rank q's
        # loss is (q + 1) * sum(output), so an input's gradient is the sum
        # of (q + 1) over the ranks its values reached
        other = base + 1 - r % 2
        for op, want in (
                (lambda x: parallel.all_gather(x, "tp"), 2 * base + 3),
                (lambda x: parallel.reduce_scatter(x, "tp"),
                 [base + 1.0, base + 2.0]),
                (lambda x: parallel.all_to_all(x, "tp", 0, 0),
                 [base + 1.0, base + 2.0]),
                (lambda x: parallel.ppermute(x, "tp", [(0, 1), (1, 0)]),
                 other + 1.0),
                (lambda x: parallel.all_reduce(x, "tp"), 2 * base + 3)):
            x = torch.ones(2, requires_grad=True)
            (op(x) * (r + 1)).sum().backward()
            want = want if isinstance(want, list) else [float(want)] * 2
            assert x.grad.tolist() == want, (x.grad, want)
    out["mesh_ok"] = onp.asarray(1)


def sync_bn(inp, out):
    mesh = parallel.make_mesh({"dp": 2}, ctx=CPU)
    r = collectives.rank()
    x = torch.tensor(inp["sbn_x"]).chunk(2)[r].clone().requires_grad_()
    w = torch.tensor(inp["sbn_w"]).chunk(2)[r]
    gamma = torch.tensor(inp["sbn_gamma"]).requires_grad_()
    beta = torch.tensor(inp["sbn_beta"]).requires_grad_()
    mm, mv = torch.tensor(inp["sbn_mm"]), torch.tensor(inp["sbn_mv"])
    from mxnet_tpu_torch.ops.contrib import sync_batch_norm
    with mesh:
        y, nm, nv = sync_batch_norm(x, gamma, beta, mm, mv, eps=1e-3,
                                    fix_gamma=False, training=True,
                                    axis_name="dp")
    (y * w).sum().backward()
    out["op_y"], out["op_dx"] = y.detach().numpy(), x.grad.numpy()
    gsum = torch.stack([gamma.grad, beta.grad])
    out["op_dgb"] = collectives.world_all_reduce(gsum.clone()).numpy()
    out["op_nm"], out["op_nv"] = nm.numpy(), nv.numpy()

    layer = nn.SyncBatchNorm(in_channels=x.shape[1], epsilon=1e-3)
    layer.initialize(ctx=CPU)
    layer.gamma.set_data(nd.array(inp["sbn_gamma"], ctx=CPU))
    layer.beta.set_data(nd.array(inp["sbn_beta"], ctx=CPU))
    layer.running_mean.set_data(nd.array(inp["sbn_mm"], ctx=CPU))
    layer.running_var.set_data(nd.array(inp["sbn_mv"], ctx=CPU))
    xa = nd.array(inp["sbn_x"], ctx=CPU)
    xa = gluon.utils.split_data(xa, 2)[r]
    xa.attach_grad()
    wa = nd.array(w.numpy(), ctx=CPU)
    with mesh, autograd.record():
        ya = layer(xa)
        loss = (ya * wa).sum()
    loss.backward()
    out["layer_y"], out["layer_dx"] = ya.asnumpy(), xa.grad.asnumpy()
    gb = torch.stack([layer.gamma.grad()._data, layer.beta.grad()._data])
    out["layer_dgb"] = collectives.world_all_reduce(gb.clone()).numpy()
    out["layer_nm"] = layer.running_mean.data().asnumpy().copy()
    out["layer_nv"] = layer.running_var.data().asnumpy().copy()


def main():
    mode, path = sys.argv[1], sys.argv[2]
    inp = dict(onp.load(os.path.join(path, "inputs.npz"), allow_pickle=False))
    out = {}
    with CPU:
        if mode == "two":
            dense_dp(inp, {"dp": 2}, out)
            bn_dp(inp, out)
            step_n_dp(inp, out)
        elif mode == "four":
            dense_dp(inp, {"dp": 4}, out)
            sharded_dense(inp, out, "tp")
            sharded_dense(inp, out, "fsdp")
            bert_tp(inp, out)
            mesh_shapes(out)
        else:
            sync_bn(inp, out)
    rank = collectives.rank()
    onp.savez(os.path.join(path, f"{mode}_r{rank}.npz"), **out)
    line = json.dumps({"rank": rank, "mode": mode, "ok": True})
    os.write(1, (line + "\n").encode())   # one write: ranks share the pipe
    collectives.barrier()


if __name__ == "__main__":
    sys.exit(main())
