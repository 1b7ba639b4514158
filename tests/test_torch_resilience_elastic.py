"""The elastic half of the port's resilience stack on the CPU: sharded
checkpoints written by each rank of a two-process gloo job and restored on
one process, the corrupt-shard fallback, and the PreemptionGuard.

- A small BERT trained over {"tp": 2} (Adam) saves a sharded checkpoint:
  one ``shard-NNNNN.npz`` a rank, which the JAX package's
  ``verify_checkpoint_dir`` accepts too. Restored on one process, the
  assembled state equals the two-rank job's gathered state bit for bit,
  and two more steps agree with the job's within 1e-5 (tensor parallelism
  sums in another order).
- DLRM vocab-sharded over the two ranks in ``sharded`` mode, under
  ``retry=`` with ``emb_exchange`` injected every 2nd dispatch:
  ``shard_state_dict`` restored on one process is the job's gathered
  state bit for bit.
- The PreemptionGuard as ``tests/test_resilience_elastic.py`` drives the
  reference's: the injected notice, SIGTERM, the deadline, and a resume
  that continues bitwise.
"""
import json
import os
import signal
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import resilience as jres
from mxnet_tpu.gluon.model_zoo import bert as jax_bert

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, gluon, optimizer, parallel
from mxnet_tpu_torch.embedding import DLRMTrainStep, ShardedEmbedding
from mxnet_tpu_torch.embedding.workload import synthetic_dlrm_batches
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.resilience import (CheckpointManager, PreemptionGuard,
                                        RetryPolicy, faults)
from mxnet_tpu_torch.resilience.faults import PreemptionNotice
from mxnet_tpu_torch.tools import PretrainStep, launch

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_resilience_worker.py")
CPU = mt.cpu()
BERT = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
            vocab_size=64, max_length=32, dropout=0.0)
VOCAB, DIM, BATCH, FIELDS, DENSE_IN, HIDDEN, LR = 64, 8, 16, 4, 6, 16, 0.1
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _bert_named():
    m = jax_bert.BERTForPretraining(jax_bert.BERTModel(**BERT),
                                    vocab_size=BERT["vocab_size"])
    m.initialize()
    tok = mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32")
    m(tok, tok)
    rng = onp.random.RandomState(0)
    out = {}
    for name, p in m._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        out[name] = a + 1.0 if name.endswith("gamma") else a
    return out


def _bert_batches(n=5):
    rng = onp.random.RandomState(1)
    v = BERT["vocab_size"]
    return {"toks": rng.randint(0, v, (n, 4, 32)).astype("int32"),
            "tt": rng.randint(0, 2, (n, 4, 32)).astype("int32"),
            "pos": onp.sort(rng.rand(n, 4, 32).argsort(-1)[..., :4],
                            -1).astype("int32"),
            "mlm": rng.randint(0, v, (n, 4, 4)).astype("int32"),
            "nsp": rng.randint(0, 2, (n, 4)).astype("int32")}


def _one_process_bert(named):
    model = bert.BERTForPretraining(bert.BERTModel(**BERT),
                                    vocab_size=BERT["vocab_size"])
    bert.load_jax_params(model, named, ctx=CPU)
    return parallel.ParallelTrainStep(
        PretrainStep(model), bert.BERTPretrainingLoss(),
        optimizer.Adam(learning_rate=1e-3),
        parallel.make_mesh({"dp": 1}, ctx=CPU), extra_specs=("dp", "dp"),
        seed=9)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two-rank job's directory and rank 0's results."""
    path = tmp_path_factory.mktemp("elastic")
    named = _bert_named()
    batches = _bert_batches()
    dlrm = synthetic_dlrm_batches(4, BATCH, DENSE_IN, FIELDS, VOCAB, seed=3)
    inp = {"bert_cfg": json.dumps(BERT),
           "bert_names": onp.asarray(sorted(named)),
           **{f"bert_{k}": v for k, v in named.items()},
           **{f"bert_{k}": v for k, v in batches.items()},
           "w0": onp.random.RandomState(4).normal(
               0, 0.1, (VOCAB, DIM)).astype("float32"),
           "vocab": VOCAB, "dim": DIM, "lr": LR,
           "cfg": onp.asarray([DENSE_IN, FIELDS, HIDDEN, HIDDEN]),
           "dense": onp.stack([b[0] for b in dlrm]),
           "idx": onp.stack([b[1] for b in dlrm]),
           "y": onp.stack([b[2] for b in dlrm])}
    onp.savez(path / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    proc = launch.run(2, [sys.executable, WORKER, str(path)], timeout=180,
                      env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert sorted(ln["rank"] for ln in lines) == [0, 1]
    return {"path": path, "named": named, "batches": batches,
            "out": dict(onp.load(path / "worker.npz"))}


def _flat(state, prefix):
    out = {}
    for k, v in state["params"].items():
        out[f"{prefix}_params_{k}"] = v
    for j, leaves in state["opt"].items():
        for k, v in leaves.items():
            out[f"{prefix}_opt_{j}_{k}"] = v
    return out


def test_sharded_save_writes_one_shard_file_a_rank(job):
    d = job["path"] / "bert" / "ckpt-00000003"
    files = sorted(os.listdir(d))
    assert files == ["MANIFEST.json", "meta.json", "shard-00000.npz",
                     "shard-00001.npz", "state.npz"]
    with open(d / "meta.json") as f:
        meta = json.load(f)
    assert meta["format"] == 1 and meta["shard_files"] == [0, 1]
    writers = {tuple(r["file"] for r in e["shards"])
               for e in meta["layout"].values()}
    assert (0, 1) in writers and (0,) in writers
    with open(d / "MANIFEST.json") as f:
        manifest = json.load(f)
    assert sorted(manifest["files"]) == files[1:]
    # the reference verifies and assembles the port's sharded layout
    ref = jres.verify_checkpoint_dir(str(d))
    assert ref["train_step"]["t"] == 3


def test_two_rank_bert_restores_on_one_process(job):
    """Assembled on one process: the job's gathered state bit for bit;
    two more steps within 1e-5 of the job's."""
    out = job["out"]
    other = {k: v * 0.5 for k, v in job["named"].items()}
    step = _one_process_bert(other)
    got = CheckpointManager(str(job["path"] / "bert")).restore_latest(
        train_step=step)
    assert got is not None and got[0] == 3 and step._t == 3
    for k, v in _flat(step.state_dict(), "bert3").items():
        onp.testing.assert_array_equal(v, out[k], err_msg=k)
    b = job["batches"]
    losses = [float(step(b["toks"][i], (b["mlm"][i], b["nsp"][i]),
                         b["tt"][i], b["pos"][i])) for i in (3, 4)]
    onp.testing.assert_allclose(losses, out["bert_losses"][3:], **TOL)
    for k, v in _flat(step.state_dict(), "bert5").items():
        onp.testing.assert_allclose(v, out[k], err_msg=k, **TOL)


def test_two_rank_dlrm_restores_on_one_process(job):
    out = job["out"]
    assert int(out["dlrm_fires"]) == 3     # calls 2, 4, 6 of 7
    d = job["path"] / "dlrm" / "ckpt-00000004"
    assert sorted(f for f in os.listdir(d) if f.startswith("shard-")) == \
        ["shard-00000.npz", "shard-00001.npz"]
    mesh = parallel.make_mesh({"tp": 1}, ctx=CPU)
    table = ShardedEmbedding(VOCAB, DIM, mesh)
    step = DLRMTrainStep(table, DENSE_IN, FIELDS, bot_hidden=HIDDEN,
                         top_hidden=HIDDEN, lr=LR, seed=5)
    got = CheckpointManager(str(job["path"] / "dlrm")).restore_latest(
        train_step=step)
    assert got is not None and step._t == 4
    stored = out["dlrm_table"]
    rps = -(-VOCAB // 2)
    ids = onp.arange(VOCAB)
    onp.testing.assert_array_equal(table.dense_weight(), stored[ids])
    assert rps * 2 == stored.shape[0]
    for k, v in step.mlp.items():
        onp.testing.assert_array_equal(v.numpy(), out[f"dlrm_mlp_{k}"])


# ---------------------------------------------------------------------------
# one process: the sharded layout and the corrupt-shard fallback
# ---------------------------------------------------------------------------
def _mlp_step(seed):
    rng = onp.random.RandomState(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=8),
            gluon.nn.Dense(8, in_units=16))
    net.initialize()
    for p in net.collect_params().values():
        p.set_data((0.3 * rng.randn(*p.shape)).astype("float32"))
    return parallel.ParallelTrainStep(
        net, gluon.loss.L2Loss(), optimizer.Adam(learning_rate=0.05),
        parallel.make_mesh({"dp": 1}, ctx=CPU), seed=seed,
        retry_policy=RetryPolicy(max_attempts=2, base_ms=0.0))


def _xy(n=8):
    rng = onp.random.RandomState(1)
    return (rng.randn(n, 16, 8).astype("float32"),
            rng.randn(n, 16, 8).astype("float32"))


def _state(step):
    return [t.detach().clone() for t in step._ordered_tensors()]


def test_one_process_sharded_save_and_corrupt_shard_fallback(tmp_path):
    X, Y = _xy()
    step = _mlp_step(11)
    cm = CheckpointManager(str(tmp_path), fsync=False, keep=3)
    step(X[0], Y[0])
    cm.save(1, train_step=step, sharded=True)
    step(X[1], Y[1])
    cm.save(2, train_step=step, sharded=True)
    assert "shard-00000.npz" in os.listdir(cm._path(2))
    with open(os.path.join(cm._path(2), "shard-00000.npz"), "r+b") as f:
        f.truncate(100)
    other = _mlp_step(12)
    got = cm.restore_latest(train_step=other)
    assert got[0] == 1 and other._t == 1
    with pytest.raises(MXNetError, match="truncated"):
        cm.restore(2, train_step=other)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------
def test_preemption_injected_notice_flushes_marks_and_resumes(tmp_path):
    X, Y = _xy()
    ref = _mlp_step(13)
    want = [float(ref(X[i], Y[i])) for i in range(8)]
    cm = CheckpointManager(str(tmp_path), fsync=False, async_save=True)
    step = _mlp_step(13)
    guard = PreemptionGuard(cm, capture=dict(train_step=step))
    got = []
    with guard, faults.inject("preempt", at=(4,)):
        for i in range(8):
            got.append(float(step(X[i], Y[i])))
            if i == 1:
                cm.save(2, train_step=step)
            if guard.should_stop(i + 1):
                break
    assert len(got) == 4 and guard.reason == "injected:preempt"
    info = PreemptionGuard.resume_info(cm)
    assert info["step"] == 4 and info["saved"] and info["within_deadline"]
    assert PreemptionGuard.resume_info(cm) is None      # consumed
    fresh = _mlp_step(77)
    step_n, _ = cm.restore_latest(train_step=fresh)
    assert step_n == 4
    got += [float(fresh(X[i], Y[i])) for i in range(4, 8)]
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(_state(ref),
                                                 _state(fresh)))


def test_preemption_sigterm_and_handler_restored(tmp_path):
    cm = CheckpointManager(str(tmp_path), fsync=False)
    step = _mlp_step(14)
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(cm, capture=dict(train_step=step))
    with guard:
        assert signal.getsignal(signal.SIGTERM) == guard._on_signal
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested and guard.reason == "signal:SIGTERM"
        assert guard.should_stop(0)
    assert signal.getsignal(signal.SIGTERM) == before
    assert cm.preemption_marker()["reason"] == "signal:SIGTERM"


def test_preemption_deadline_exceeded_recorded(tmp_path):
    cm = CheckpointManager(str(tmp_path), fsync=False)
    step = _mlp_step(15)
    guard = PreemptionGuard(cm, capture=dict(train_step=step),
                            deadline_s=0.0)
    guard.notify("test")
    assert guard.should_stop(1)
    info = cm.preemption_marker()
    assert info["saved"] and not info["within_deadline"]
    assert info["deadline_s"] == 0.0


def test_preempt_fault_kind_raises_outside_guard():
    with faults.inject("preempt", every_n=1):
        with pytest.raises(PreemptionNotice):
            faults.check("preemption")
