"""The port's ParallelTrainStep over meshes of several ranks against the JAX
package's on its 8-device CPU mesh (the cases of tests/test_parallel.py).

The port runs one process per rank: ``mxnet_tpu_torch/tools/launch.py``
starts 2 or 4 workers (tests/torch_dist_parallel_worker.py, gloo on the
CPU, a process-group timeout and the launcher's timeout), which read the
inputs and the reference's initial weights that this test wrote, train,
and write what they trained. The reference runs here, on its own meshes:
{"dp": 8} for the data-parallel cases, {"dp": 4, "tp": 2} and {"dp": 4,
"fsdp": 2} for the sharded ones, {"dp": 1} for step_n. Tolerance 2e-5 in f32, the
reference's own (test_parallel.py:74); the ranks' results must be
bitwise equal to each other.
"""
import json
import os
import sys

import jax
import numpy as onp
import pytest
from jax.sharding import PartitionSpec as PS

import mxnet_tpu as mx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.optimizer import lr_scheduler as jsched

import torch

from mxnet_tpu_torch.parallel.train_step import shard_of, unshard
from mxnet_tpu_torch.tools import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_parallel_worker.py")
TOL = dict(rtol=2e-5, atol=2e-5)
BERT_CFG = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
                vocab_size=128, max_length=64, dropout=0.0)


def run_workers(n, mode, path, timeout=120):
    """``n`` ranks of the worker in ``mode``; their outputs by rank."""
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    proc = launch.run(n, [sys.executable, WORKER, mode, str(path)],
                      timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert sorted(ln["rank"] for ln in lines) == list(range(n)), proc.stdout
    return [dict(onp.load(os.path.join(path, f"{mode}_r{r}.npz")))
            for r in range(n)]


def _same_on_every_rank(outs):
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for k in o:
            onp.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------
def _ref_dense(dp):
    onp.random.seed(0)
    xs = onp.random.randn(16, 8).astype("float32")
    ys = onp.random.randn(16, 1).astype("float32")
    net = jnn.Dense(1, in_units=8)
    net.initialize(mx.init.Constant(0.05))
    step = jparallel.ParallelTrainStep(
        net, jloss.L2Loss(), mx.optimizer.SGD(learning_rate=0.1),
        jparallel.make_mesh({"dp": dp}, devices=jax.devices()[:dp]))
    for _ in range(3):
        step(xs, ys)
    step.sync_to_block()
    return xs, ys, net.weight.data().asnumpy()


def _values(net):
    return [p.data().asnumpy().copy() for p in net.collect_params().values()]


def _ref_bn():
    mx.random.seed(3)
    rng = onp.random.RandomState(3)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(8, in_units=4), jnn.BatchNorm(), jnn.Dense(2))
    net.initialize()
    net(mx.nd.array(onp.zeros((2, 4), "float32")))
    init = _values(net)
    xs = (rng.randn(16, 4) * 3 + 5).astype("float32")
    ys = rng.randn(16, 2).astype("float32")
    step = jparallel.ParallelTrainStep(
        net, jloss.L2Loss(), mx.optimizer.SGD(learning_rate=0.01),
        jparallel.make_mesh({"dp": 8}))
    for _ in range(2):
        step(xs, ys)
    step.sync_to_block()
    return init, xs, ys, _values(net)


def _ref_step_n():
    mx.random.seed(11)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, activation="relu"), jnn.Dense(4))
    net.initialize(mx.init.Xavier())
    net(mx.nd.array(onp.zeros((1, 8), "float32")))
    init = _values(net)
    sched = jsched.FactorScheduler(step=2, factor=0.5)
    step = jparallel.ParallelTrainStep(
        net, jloss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.Adam(learning_rate=0.05, lr_scheduler=sched),
        jparallel.make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    rng = onp.random.RandomState(5)
    X = rng.rand(6, 8, 8).astype("float32")
    Y = rng.randint(0, 4, (6, 8)).astype("float32")
    losses = [float(step(X[i], Y[i]).asscalar()) for i in range(6)]
    step.sync_to_block()
    return init, X, Y, onp.asarray(losses), _values(net)


def _ref_sharded_dense(axis):
    onp.random.seed(1)
    xs = onp.random.randn(8, 16).astype("float32")
    ys = onp.random.randn(8, 32).astype("float32")
    w = onp.linspace(-0.1, 0.1, 32 * 16).reshape(32, 16).astype("float32")
    net = jnn.Dense(32, in_units=16)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", magnitude=1))
    net.weight.set_data(mx.nd.array(w))
    net.bias.set_data(mx.nd.array(onp.zeros(32, "float32")))
    net.weight.shard(PS(axis, None))
    step = jparallel.ParallelTrainStep(
        net, jloss.L2Loss(), mx.optimizer.SGD(learning_rate=0.05),
        jparallel.make_mesh({"dp": 4, axis: 2}),
        data_spec=None if axis == "tp" else PS(("dp", axis)))
    for _ in range(2):
        step(xs, ys)
    step.sync_to_block()
    return xs, ys, w, net.weight.data().asnumpy()


class _JaxPretrainStep(jbert.BERTForPretraining):
    def forward(self, tokens, token_types, positions):
        return super().forward(tokens, token_types, None, positions)


def _ref_bert():
    model = _JaxPretrainStep(jbert.BERTModel(**BERT_CFG),
                             vocab_size=BERT_CFG["vocab_size"])
    model.initialize()
    tok = mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32")
    model(tok, tok, mx.nd.array(onp.zeros((1, 2), onp.int32), dtype="int32"))
    rng = onp.random.RandomState(0)
    named = {}
    for name, p in model._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        if name.endswith("gamma"):
            a += 1.0
        named[name] = a
        p.set_data(mx.nd.array(a))
    k, b, s, n_pos = 2, 4, 32, 5
    toks = rng.randint(0, BERT_CFG["vocab_size"], (k, b, s)).astype("int32")
    tt = rng.randint(0, 2, (k, b, s)).astype("int32")
    pos = onp.sort(rng.rand(k, b, s).argsort(-1)[..., :n_pos],
                   -1).astype("int32")
    mlm = rng.randint(0, BERT_CFG["vocab_size"], (k, b, n_pos)).astype(
        "int32")
    nsp = rng.randint(0, 2, (k, b)).astype("int32")
    assert jbert.shard_for_tensor_parallel(model) == 13
    step = jparallel.ParallelTrainStep(
        model, jbert.BERTPretrainingLoss(),
        mx.optimizer.SGD(learning_rate=0.05, momentum=0.9),
        jparallel.make_mesh({"dp": 4, "tp": 2}),
        extra_specs=(PS("dp"), PS("dp")))
    losses = [float(step(toks[i], (mlm[i], nsp[i]), tt[i],
                         pos[i]).asscalar()) for i in range(k)]
    step.sync_to_block()
    trained = {n: p.data().asnumpy() for n, p in
               model._collect_params_with_prefix().items()}
    return named, (toks, tt, pos, mlm, nsp), onp.asarray(losses), trained


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    path = tmp_path_factory.mktemp("two")
    xs, ys, w = _ref_dense(8)
    bn_init, bn_x, bn_y, bn_ref = _ref_bn()
    sn_init, sn_x, sn_y, sn_losses, sn_ref = _ref_step_n()
    inputs = {"dense_x": xs, "dense_y": ys, "bn_x": bn_x, "bn_y": bn_y,
              "bn_n": onp.asarray(len(bn_init)), "sn_x": sn_x, "sn_y": sn_y}
    inputs.update({f"bn_p{i}": a for i, a in enumerate(bn_init)})
    inputs.update({f"sn_p{i}": a for i, a in enumerate(sn_init)})
    onp.savez(path / "inputs.npz", **inputs)
    outs = run_workers(2, "two", path)
    return outs, {"dense_w": w, "bn": bn_ref, "sn_losses": sn_losses,
                  "sn": sn_ref}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    path = tmp_path_factory.mktemp("four")
    xs, ys, w = _ref_dense(8)
    tx, ty, tw, tw_ref = _ref_sharded_dense("tp")
    fw_ref = _ref_sharded_dense("fsdp")[3]
    named, batches, losses, trained = _ref_bert()
    inputs = {"dense_x": xs, "dense_y": ys, "tp_x": tx, "tp_y": ty,
              "tp_w": tw, "bert_cfg": onp.asarray(json.dumps(BERT_CFG)),
              "bert_names": onp.asarray(sorted(named))}
    inputs.update({f"bert_{n}": a for n, a in named.items()})
    inputs.update({f"bert_{k}": a for k, a in
                   zip(("toks", "tt", "pos", "mlm", "nsp"), batches)})
    onp.savez(path / "inputs.npz", **inputs)
    outs = run_workers(4, "four", path)
    return outs, {"dense_w": w, "tp_w": tw_ref, "fsdp_w": fw_ref,
                  "bert_losses": losses,
                  "bert": trained}


def test_ranks_agree_bitwise(two, four):
    _same_on_every_rank(two[0])
    _same_on_every_rank(four[0])


@pytest.mark.parametrize("job", ["two", "four"])
def test_data_parallel_dense_matches_reference(job, request):
    """dp=2 and dp=4 against the reference's {"dp": 8}
    (test_parallel.py:38)."""
    outs, ref = request.getfixturevalue(job)
    onp.testing.assert_allclose(outs[0]["dense_w"], ref["dense_w"], **TOL)


def test_batchnorm_global_moments_match_reference(two):
    """Dense-BatchNorm-Dense on dp=2: parameters and moving statistics
    against the reference's global-batch BatchNorm on {"dp": 8}
    (test_parallel.py:105)."""
    outs, ref = two
    for i, want in enumerate(ref["bn"]):
        onp.testing.assert_allclose(outs[0][f"bn_p{i}"], want, **TOL,
                                    err_msg=f"parameter {i}")


def test_step_n_equals_step_and_reference(two):
    """step_n(3) twice equals six step() calls bitwise on dp=2 (checked in
    the workers), and both the reference's dp=1 run (test_parallel.py:203)."""
    outs, ref = two
    onp.testing.assert_allclose(outs[0]["sn_losses"], ref["sn_losses"],
                                **TOL)
    for i, want in enumerate(ref["sn"]):
        onp.testing.assert_allclose(outs[0][f"sn_p{i}"], want, **TOL)


@pytest.mark.parametrize("axis", ["tp", "fsdp"])
def test_sharded_dense_matches_reference(four, axis):
    """Dense weight P(axis, None) on {"dp": 2, axis: 2} against the
    reference's {"dp": 4, axis: 2} (test_parallel.py:77): "tp" with the
    batch whole along it (the shard's gradient its slice), "fsdp" with the
    batch split over ("dp", "fsdp") (the gradient reduce-scattered)."""
    outs, ref = four
    onp.testing.assert_allclose(outs[0][f"{axis}_w"], ref[f"{axis}_w"],
                                **TOL)


def test_bert_tensor_parallel_matches_reference(four):
    """A 2-layer BERT with shard_for_tensor_parallel on {"dp": 2, "tp": 2}
    (one head a rank) against the reference's {"dp": 4, "tp": 2}: the
    losses of two SGD steps and every gathered parameter."""
    outs, ref = four
    onp.testing.assert_allclose(outs[0]["bert_losses"], ref["bert_losses"],
                                **TOL)
    for name, want in ref["bert"].items():
        onp.testing.assert_allclose(outs[0][f"bert_{name}"], want, **TOL,
                                    err_msg=name)


def test_mesh_shapes_and_collectives(four):
    """Mesh shapes, -1 inference, each rank's coordinates and the
    collectives over an axis, forward and backward (checked in the
    workers; test_parallel.py:14)."""
    assert all(int(o["mesh_ok"]) == 1 for o in four[0])


@pytest.mark.parametrize("tp", [2, 4])
def test_a_qkv_shard_holds_its_heads_rows(tp):
    """The carry-across map of a fused QKV weight (spec ("tp", None) in 3
    blocks): rank r's shard is the Q, K and V rows of heads r * H / tp ..
    (r + 1) * H / tp, and the shards map back to the reference's global
    order."""
    heads, d, units = 4, 3, 12
    w = torch.arange(3 * units * 5, dtype=torch.float32).reshape(
        3 * units, 5)
    shards = [shard_of(w, 0, tp, r, blocks=3) for r in range(tp)]
    rows = units // tp
    for r, sh in enumerate(shards):
        want = torch.cat([w[b * units + r * rows:b * units + (r + 1) * rows]
                          for b in range(3)])
        assert torch.equal(sh, want)
        assert rows % d == 0 and sh.shape == (3 * rows, 5)
    assert torch.equal(unshard(shards, 0, blocks=3), w)
    cols = [shard_of(w, 1, 5, r) for r in range(5)]
    assert torch.equal(unshard(cols, 1), w)
