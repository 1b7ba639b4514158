"""The port's embedding subsystem (``mxnet_tpu_torch.embedding``: the
vocab-sharded table, the planner, the device feed, the DLRM step) and its
zoo ``DLRM`` against the JAX package's (the cases of tests/test_embedding.py).

The port runs one process per rank: ``mxnet_tpu_torch/tools/launch.py``
starts 1, 2 or 4 workers (tests/torch_embedding_worker.py, gloo on the
CPU) over the same seeded numpy inputs. The reference runs here on one
device: its ``DLRMTrainStep`` over a one-shard table is the dense oracle of
tests/test_embedding.py. Tolerances: lookups and dedup exact; four DLRM
steps' losses within rtol 1e-6 and table and MLP within rtol 1e-5 / atol
1e-6 of the reference (f32, XLA's and PyTorch's products sum in other
orders); among the port's own ranks the ``replicated`` mode is bitwise
the one-rank run, and the ``sharded`` mode within the reference's own
allclose (rtol 1e-5, atol 1e-6: it averages per-rank gradients).
"""
import json
import os
import sys
import time

import jax
import numpy as onp
import pytest

from mxnet_tpu import parallel as jparallel
from mxnet_tpu.embedding import (DLRMTrainStep as JStep,
                                 HotnessTracker as JTracker,
                                 ShardedEmbedding as JTable,
                                 TableSpec as JSpec, dedup_ids as jdedup,
                                 plan_tables as jplan)

import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, parallel
from mxnet_tpu_torch.embedding import (DeviceFeed, DLRMTrainStep,
                                       HotnessTracker, ShardedEmbedding,
                                       TableSpec, dedup_ids, dlrm_forward,
                                       init_mlp_params, plan_tables,
                                       synthetic_dlrm_batches)
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.tools import launch

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))      # prime the intra-op pool (SKILL.md)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_embedding_worker.py")
VOCAB, DIM, BATCH, FIELDS, DENSE_IN, HIDDEN = 64, 8, 16, 4, 6, 16
LR = 0.1
SIZES = (1, 2, 4)
LAYOUTS = ("block", "cyclic")
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-6
MLP_KEYS = ("w_bot1", "b_bot1", "w_bot2", "b_bot2", "w_top1", "b_top1",
            "w_top2", "b_top2")
CPU = mt.cpu()


def _w0(seed=0):
    return onp.random.RandomState(seed).normal(
        0, 0.1, (VOCAB, DIM)).astype("float32")


def _batches(k, seed):
    return synthetic_dlrm_batches(k, BATCH, DENSE_IN, FIELDS, VOCAB,
                                  seed=seed)


def _stacked(data, key):
    return {f"{key}_{name}": onp.stack([b[i] for b in data])
            for i, name in enumerate(("dense", "idx", "y"))}


def _reference_run(data):
    """The reference's DLRM step on one device over ``data`` (its table
    replicated: the plain gather and scatter-add of the dense oracle,
    tests/test_embedding.py:_dense_reference): losses, the logical table
    and the MLP. (The reference's partitioned table passes ``check_rep``
    to ``jax.shard_map``, which this JAX refuses: ROADMAP, faults in the
    reference.)"""
    mesh = jparallel.make_mesh({"tp": 1}, devices=jax.devices()[:1])
    table = JTable(VOCAB, DIM, mesh, axis="tp", weight=_w0(),
                   placement="replicate")
    step = JStep(table, DENSE_IN, FIELDS, bot_hidden=HIDDEN,
                 top_hidden=HIDDEN, lr=LR, seed=0)
    losses = [step(b) for b in data]
    return (onp.asarray(losses), table.dense_weight(),
            {k: onp.asarray(jax.device_get(v)) for k, v in step.mlp.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results by ring size (a list by rank), the inputs and
    the reference's runs."""
    path = tmp_path_factory.mktemp("emb")
    train, sharded, elastic = _batches(4, 3), _batches(4, 9), _batches(6, 5)
    rng = onp.random.RandomState(1)
    inp = {"w0": _w0(), "vocab": VOCAB, "dim": DIM, "lr": LR,
           "cfg": onp.asarray([DENSE_IN, FIELDS, HIDDEN, HIDDEN]),
           "lookup_idx": rng.randint(0, VOCAB, (5, 7)).astype(onp.int32),
           "dispatch_ids": rng.randint(0, VOCAB, (24,)).astype(onp.int32),
           **_stacked(train, "train"), **_stacked(sharded, "sharded"),
           **_stacked(elastic, "elastic")}
    onp.savez(path / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    out = {"inp": inp, "path": path, "elastic": elastic,
           "ref": _reference_run(train),
           "ref_sharded": _reference_run(sharded)}
    for n in SIZES:
        proc = launch.run(n, [sys.executable, WORKER, str(path)],
                          timeout=120, env=env)
        assert proc.returncode == 0, proc.stdout[-4000:] + \
            proc.stderr[-8000:]
        lines = sorted((json.loads(ln) for ln in proc.stdout.splitlines()
                        if ln.startswith("{")), key=lambda ln: ln["rank"])
        assert [ln["rank"] for ln in lines] == list(range(n))
        out[n] = ([dict(onp.load(path / f"emb_n{n}_r{r}.npz"))
                   for r in range(n)], lines)
    return out


# ---------------------------------------------------------------------------
# dedup and the lookups
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,vocab", [((2, 3), 100), ((16, 4), 64),
                                         ((7, 26), 1 << 20)])
def test_dedup_equals_the_references(shape, vocab):
    rng = onp.random.RandomState(shape[0])
    idx = rng.randint(0, min(vocab, 50), shape).astype(onp.int32)
    uniq, inv = dedup_ids(idx, vocab)
    ruq, rinv = jdedup(idx, vocab)
    onp.testing.assert_array_equal(uniq.numpy(), onp.asarray(ruq))
    onp.testing.assert_array_equal(inv.numpy(), onp.asarray(rinv))
    assert uniq.dtype == torch.int32 and inv.shape == idx.shape
    onp.testing.assert_array_equal(uniq.numpy()[inv.numpy()], idx)


def test_dedup_sorted_unique_with_sentinel():
    uniq, inv = dedup_ids(onp.array([[5, 2, 5], [0, 2, 5]], onp.int32), 100)
    assert uniq.tolist() == [0, 2, 5, 100, 100, 100]
    assert inv.tolist() == [[2, 1, 2], [0, 1, 2]]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_lookup_bitwise_equals_dense_gather(runs, n, layout):
    w0, idx = runs["inp"]["w0"], runs["inp"]["lookup_idx"]
    for r in runs[n][0]:
        onp.testing.assert_array_equal(r[f"{layout}_lookup"], w0[idx])
        onp.testing.assert_array_equal(r[f"{layout}_dense"], w0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_dispatch_gather_matches_dense_rows(runs, n, layout):
    w0 = runs["inp"]["w0"]
    ids = runs["inp"]["dispatch_ids"].reshape(n, -1)
    for rank, r in enumerate(runs[n][0]):
        onp.testing.assert_array_equal(r[f"{layout}_dispatch"],
                                       w0[ids[rank]])


# ---------------------------------------------------------------------------
# the DLRM step
# ---------------------------------------------------------------------------
def _assert_run(r, prefix, ref):
    losses, table, mlp = ref
    onp.testing.assert_allclose(r[f"{prefix}_losses"], losses,
                                rtol=LOSS_RTOL)
    onp.testing.assert_allclose(r[f"{prefix}_table"], table, **STEP_TOL)
    for k in MLP_KEYS:
        onp.testing.assert_allclose(r[f"{prefix}_mlp_{k}"], mlp[k],
                                    **STEP_TOL, err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_replicated_step_matches_the_reference(runs, n, layout):
    for r in runs[n][0]:
        _assert_run(r, f"{layout}_rep", runs["ref"])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES[1:])
def test_replicated_step_is_bitwise_the_one_rank_step(runs, n, layout):
    one = runs[1][0][0]
    keys = [k for k in one if k.startswith(f"{layout}_rep")]
    for r in runs[n][0]:
        for k in keys:
            onp.testing.assert_array_equal(r[k], one[k], err_msg=k)


@pytest.mark.parametrize("n", SIZES[1:])
def test_sharded_step_tracks_the_reference(runs, n):
    ranks, lines = runs[n]
    assert all(ln["mode"] == "sharded" for ln in lines)
    for r in ranks:
        _assert_run(r, "sharded", runs["ref_sharded"])


@pytest.mark.parametrize("n", SIZES[1:])
def test_sharded_step_keeps_the_kvstore_cold(runs, n):
    """No kvstore method is called during the sharded steps, while the
    table's exchange counter moves by the reference's cost model."""
    for ln in runs[n][1]:
        assert ln["kv_calls"] == 0
        n_ids = 4 * BATCH * FIELDS
        want = {"dispatch": n * n_ids * 4, "return": n * n_ids * DIM * 4}
        assert ln["exchange"] == want


def test_elastic_restore_two_ranks_to_one_bitwise(runs):
    """A 2-rank cyclic table's state after three steps, restored onto one
    rank (block layout, other initial weights): three more steps equal the
    2-rank run's, losses and table bit for bit."""
    with onp.load(runs["path"] / "elastic_state.npz") as f:
        state = json.loads(str(f["meta"]))
        state["table"] = f["table"]
        state["mlp"] = {k: f[f"mlp_{k}"] for k in MLP_KEYS}
    assert state["table_shards"] == 2 and state["table_layout"] == "cyclic"
    mesh = parallel.make_mesh({"tp": 1}, ctx=CPU)
    table = ShardedEmbedding(VOCAB, DIM, mesh, axis="tp", weight=_w0(77))
    step = DLRMTrainStep(table, DENSE_IN, FIELDS, bot_hidden=HIDDEN,
                         top_hidden=HIDDEN, lr=LR, seed=77)
    step.load_state_dict(state)
    assert step._t == 3
    torch.set_num_threads(1)          # as the workers compute
    try:
        tail = [step(b) for b in runs["elastic"][3:]]
    finally:
        torch.set_num_threads(2)
    two = runs[2][0][0]
    assert tail == two["elastic_tail"].tolist()
    onp.testing.assert_array_equal(table.dense_weight(), two["elastic_table"])


def test_stored_layout_round_trips_on_one_rank():
    """set_stored takes the stored layout back (the restore path), and
    set_weight takes a tensor as it takes an array."""
    mesh = parallel.make_mesh({"tp": 1}, ctx=CPU)
    for layout in LAYOUTS:
        table = ShardedEmbedding(VOCAB, DIM, mesh, layout=layout,
                                 weight=torch.from_numpy(_w0()))
        onp.testing.assert_array_equal(table.dense_weight(), _w0())
        table.set_stored(table.stored_weight() * 2)
        onp.testing.assert_array_equal(table.dense_weight(), _w0() * 2)
        with pytest.raises(mt.MXNetError, match="stored shape"):
            table.set_stored(onp.zeros((VOCAB + 1, DIM), "float32"))
        with pytest.raises(mt.MXNetError, match="weight shape"):
            table.set_weight(onp.zeros((VOCAB, DIM + 1), "float32"))


def test_retry_waits_for_resilience():
    """``retry=`` takes the port's RetryPolicy (it waited for the
    resilience slice): with ``emb_exchange`` injected at every 2nd
    dispatch, the steps' losses and table equal the run without faults,
    bit for bit."""
    from mxnet_tpu_torch.resilience import RetryPolicy, faults
    mesh = parallel.make_mesh({"tp": 1}, ctx=CPU)

    def run(retry):
        table = ShardedEmbedding(VOCAB, DIM, mesh,
                                 weight=torch.from_numpy(_w0()))
        step = DLRMTrainStep(table, DENSE_IN, FIELDS, bot_hidden=HIDDEN,
                             top_hidden=HIDDEN, lr=LR, retry=retry)
        return [step(b) for b in _batches(4, 3)], table.dense_weight()

    want, want_table = run(None)
    with faults.inject("emb_exchange", every_n=2) as inj:
        got, got_table = run(RetryPolicy(max_attempts=3, base_ms=0.0))
    assert inj.fires == 3 and got == want
    onp.testing.assert_array_equal(got_table, want_table)


def test_init_mlp_params_equals_the_references():
    from mxnet_tpu.embedding.workload import init_mlp_params as jinit
    got, want = init_mlp_params(13, 26, 128, 512, 1024, seed=3), \
        jinit(13, 26, 128, 512, 1024, seed=3)
    assert got.keys() == want.keys()
    for k in got:
        onp.testing.assert_array_equal(got[k], want[k])


def test_synthetic_batches_equal_the_references():
    from mxnet_tpu.embedding.workload import synthetic_dlrm_batches as jsyn
    for a, b in zip(synthetic_dlrm_batches(3, 32, 13, 26, 4096, seed=2),
                    jsyn(3, 32, 13, 26, 4096, seed=2)):
        for x, y in zip(a, b):
            onp.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
class _Axes:
    """A mesh as the planner reads it (its axes' sizes)."""

    def __init__(self, n):
        self.n = n

    def axis_size(self, axis):
        return self.n


def _hot(cls):
    hot = cls("hot", 1 << 16, cap=1024, topk=8)
    hot.observe(onp.concatenate([onp.zeros(700, onp.int64),
                                 onp.arange(300) * 37 % (1 << 16)]))
    return hot


def test_planner_rules_equal_the_references():
    specs = [("tiny", 256, 16), ("narrow", 2, 1 << 18), ("cold", 1 << 16, 16),
             ("hot", 1 << 16, 16)]
    plans = {p.name: p for p in plan_tables(
        [TableSpec(*s) for s in specs], _Axes(4),
        hotness={"hot": _hot(HotnessTracker)})}
    jmesh = jparallel.make_mesh({"tp": 4}, devices=jax.devices()[:4])
    want = jplan([JSpec(*s) for s in specs], jmesh,
                 hotness={"hot": _hot(JTracker)})
    for w in want:
        got = plans[w.name]
        assert (got.placement, got.layout, got.reason) == \
            (w.placement, w.layout, w.reason)
    assert plans["tiny"].placement == "replicate"
    assert plans["narrow"].placement == "replicate"
    assert (plans["cold"].placement, plans["cold"].layout) == \
        ("partition", "block")
    assert plans["hot"].rowwise and "row-wise" in plans["hot"].reason


def test_planner_single_shard_always_replicates():
    plans = plan_tables([TableSpec("big", vocab=1 << 16, dim=64)],
                        parallel.make_mesh({"tp": 1}, ctx=CPU))
    assert plans[0].placement == "replicate"


def test_hotness_tracker_rate_equals_the_references():
    t, j = HotnessTracker("t", 1000, cap=100, topk=2), \
        JTracker("t", 1000, cap=100, topk=2)
    assert t.hot_hit_rate() == 0.0
    for x in (t, j):
        x.observe([7, 7, 7, 500, 3])                 # 500 is beyond the cap
    assert t.total == 5
    assert t.hot_hit_rate() == pytest.approx(4 / 5) == j.hot_hit_rate()


# ---------------------------------------------------------------------------
# the device feed
# ---------------------------------------------------------------------------
def _feed_loader(n=40, batch=4, shuffle=True):
    X = onp.arange(n * 3, dtype=onp.float32).reshape(n, 3)
    y = onp.arange(n, dtype=onp.float32)
    return DataLoader(ArrayDataset(X, y), batch_size=batch, shuffle=shuffle)


def _epoch(it):
    return [(b[0].asnumpy().copy(), b[1].asnumpy().copy()) for b in it]


def _same(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert onp.array_equal(xa, xb) and onp.array_equal(ya, yb)


def test_device_feed_yields_identical_batches():
    mt.random.seed(5)
    bare = _epoch(_feed_loader())
    mt.random.seed(5)
    feed = DeviceFeed(_feed_loader())
    _same(bare, _epoch(feed))
    assert feed.staged == len(bare) and len(feed.wait_us) == len(bare) + 1


def test_device_feed_exact_midepoch_resume():
    mt.random.seed(6)
    full = _epoch(_feed_loader())
    mt.random.seed(6)
    feed = DeviceFeed(_feed_loader())
    it = iter(feed)
    head = [(b[0].asnumpy().copy(), b[1].asnumpy().copy())
            for b in (next(it) for _ in range(4))]
    st = feed.state_dict()
    assert st["kind"] == "DeviceFeed" and st["pos"] == 4
    del it                                          # abandon mid-epoch
    mt.random.seed(999)                             # resume must not care
    feed2 = DeviceFeed(_feed_loader())
    feed2.load_state_dict(st)
    _same(full, head + _epoch(feed2))


def test_device_feed_stage_error_propagates_promptly():
    class Boom(RuntimeError):
        pass

    calls = {"n": 0}

    def stage(batch):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Boom("stager died")
        return batch

    feed = DeviceFeed(_feed_loader(shuffle=False), stage=stage)
    t0 = time.monotonic()
    with pytest.raises(Boom):
        for _ in feed:
            pass
    assert time.monotonic() - t0 < 30.0


def test_device_feed_depth_bounds_the_lead():
    feed = DeviceFeed(_feed_loader(n=24, shuffle=False), depth=2)
    leads = []
    for _ in feed:
        time.sleep(0.01)                            # let the stager run ahead
        leads.append(feed.lead)
    assert max(leads) <= 2 and feed.staged == 6


def test_dlrm_step_through_the_feed_equals_direct_steps():
    """DLRMTrainStep.stage as the feed's stage hook: the same losses as
    stepping the raw batches."""
    data = _batches(4, 13)
    ds = ArrayDataset(*(onp.stack([b[i] for b in data]) for i in range(3)))
    mesh = parallel.make_mesh({"tp": 1}, ctx=CPU)

    def step():
        return DLRMTrainStep(ShardedEmbedding(VOCAB, DIM, mesh, weight=_w0()),
                             DENSE_IN, FIELDS, HIDDEN, HIDDEN, lr=LR)
    direct = step()
    want = [direct(b) for b in data]
    fed = step()
    loader = DataLoader(ds, batch_size=1, shuffle=False)
    feed = DeviceFeed(loader, stage=lambda b: fed.stage(
        tuple(a.asnumpy()[0] for a in b)))
    assert [fed(s) for s in feed] == want


# ---------------------------------------------------------------------------
# the zoo's DLRM agrees with the step's math
# ---------------------------------------------------------------------------
def test_model_zoo_dlrm_matches_workload_forward():
    import jax.numpy as jnp
    from mxnet_tpu.embedding import dlrm_forward as jforward
    from mxnet_tpu_torch.gluon.model_zoo import DLRM

    rng = onp.random.RandomState(4)
    w0 = rng.normal(0, 0.1, (VOCAB, DIM)).astype("float32")
    mlp = init_mlp_params(DENSE_IN, FIELDS, DIM, 16, 16, seed=1)
    dense = rng.normal(0, 1, (5, DENSE_IN)).astype("float32")
    idx = rng.randint(0, VOCAB, (5, FIELDS)).astype(onp.int32)
    with CPU:
        net = DLRM(VOCAB, FIELDS, DENSE_IN, embed_dim=DIM, bot_hidden=16,
                   top_hidden=16, sparse_grad=True)
        net.initialize()
        net(nd.array(dense), nd.array(idx, dtype="int32"))  # shapes
        net.embedding.weight.set_data(nd.array(w0))
        for layer, wk, bk in [(net.bot1, "w_bot1", "b_bot1"),
                              (net.bot2, "w_bot2", "b_bot2"),
                              (net.top1, "w_top1", "b_top1"),
                              (net.top2, "w_top2", "b_top2")]:
            layer.weight.set_data(nd.array(mlp[wk].T))  # (units, in_units)
            layer.bias.set_data(nd.array(mlp[bk]))
        got = net(nd.array(dense), nd.array(idx, dtype="int32")).asnumpy()
    mine = dlrm_forward({k: torch.from_numpy(v) for k, v in mlp.items()},
                        torch.from_numpy(dense), torch.from_numpy(w0[idx]))
    want = onp.asarray(jforward(jnp, mlp, jnp.asarray(dense), w0[idx]))
    onp.testing.assert_allclose(got[:, 0], mine.numpy(), rtol=1e-5,
                                atol=1e-6)
    onp.testing.assert_allclose(got[:, 0], want, rtol=1e-5, atol=1e-6)


def test_model_zoo_registers_dlrm():
    from mxnet_tpu_torch.gluon import model_zoo
    net = model_zoo.dlrm_tiny()
    assert isinstance(net, model_zoo.DLRM)
    assert model_zoo.dlrm_zoo.dlrm_tiny is model_zoo.dlrm_tiny
