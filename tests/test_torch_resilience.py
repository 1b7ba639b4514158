"""The port's resilience stack (mxnet_tpu_torch.resilience) against the JAX
package's on the CPU: fault injection, retry, checkpoints read across the
two packages, the random module's state, the watchdog and circuit breaker,
the train step's retry and the decode path's fault points.

The acceptance bar is the reference's (``tests/test_resilience.py``): a
20-step run with an injected device OOM every 3rd attempt, a crash and a
``restore_latest`` ends bitwise equal to the uninterrupted run. Weights and
batches come from numpy seeds. Tolerances: bitwise within a package; a
step taken by each package from the same restored state within 1e-5 (both
are true f32 and differ in their sums' order).
"""
import json
import os
import threading
import time

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import resilience as jres
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, gluon, optimizer, parallel
from mxnet_tpu_torch import resilience as res
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.gluon.model_zoo.bert import TransformerLM, load_jax_params
from mxnet_tpu_torch.resilience import (CheckpointManager, CircuitBreaker,
                                        RetryPolicy, Watchdog, faults)
from mxnet_tpu_torch.resilience.faults import FaultInjected, SimulatedCrash
from mxnet_tpu_torch.serving import KVPoolExhausted
from mxnet_tpu_torch.serving.generate import DecodeEndpoint, DecodeScheduler

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _weights(seed, shapes):
    rng = onp.random.RandomState(seed)
    return [(0.3 * rng.randn(*s)).astype("float32") for s in shapes]


BN_SHAPES = ((16, 8), (16,), (16,), (16,), (16,), (4, 16), (4,))


def _bn_net(pkg, seed):
    """Dense-BatchNorm-ReLU-Dense with seeded weights (running var > 0).
    The first Dense has no bias: BatchNorm takes the mean out, so its
    gradient would be rounding noise, which Adam scales up to lr."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, use_bias=False),
            nn.BatchNorm(in_channels=16),
            nn.Activation("relu"), nn.Dense(4, in_units=16))
    net.initialize()
    for p, w in zip(net.collect_params().values(), _weights(seed, BN_SHAPES)):
        p.set_data(pkg.nd.array(abs(w) + 1 if p.name.endswith("running_var")
                                else w))
    return net


def _port_step(net, seed=0, lr=0.05, **kw):
    kw.setdefault("retry_policy", RetryPolicy(max_attempts=4, base_ms=0.0,
                                              seed=seed))
    return parallel.ParallelTrainStep(
        net, gluon.loss.L2Loss(), optimizer.Adam(learning_rate=lr),
        parallel.make_mesh({"dp": 1}, ctx=CPU), seed=seed, **kw)


def _ref_step(net, lr=0.05):
    mesh = jparallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return jparallel.ParallelTrainStep(
        net, jloss.L2Loss(), mx.optimizer.Adam(learning_rate=lr), mesh)


def _data(seed, steps, out=4):
    rng = onp.random.RandomState(seed)
    return (rng.randn(steps, 16, 8).astype("float32"),
            rng.randn(steps, 16, out).astype("float32"))


def _state(step):
    return [t.detach().clone() for t in step._ordered_tensors()]


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# fault injection and retry: the same sequences as the reference
# ---------------------------------------------------------------------------
def _firing(pkg_faults, **kw):
    hits = []
    with pkg_faults.inject("device_oom", site="train_step", **kw) as inj:
        for i in range(1, 41):
            try:
                pkg_faults.check("train_step")
            except pkg_faults.FaultInjected:
                hits.append(i)
    return hits, inj.calls, inj.fires


@pytest.mark.parametrize("kw", [dict(every_n=3), dict(at=(2, 5, 11)),
                                dict(p=0.3, seed=7), dict(p=0.5, seed=123),
                                dict(every_n=1, times=4)],
                         ids=["every_n", "at", "p_seed7", "p_seed123",
                              "times"])
def test_fault_firing_sequence_matches_reference(kw):
    got = _firing(faults, **kw)
    assert got == _firing(jres.faults, **kw)
    assert got[2] > 0


def test_fault_harness_refuses_unknown_kind_and_site():
    for pkg_faults in (faults, jres.faults):
        with pytest.raises(Exception, match="unknown fault kind"):
            with pkg_faults.inject("nope"):
                pass
        with pytest.raises(Exception, match="unknown fault site"):
            with pkg_faults.inject("device_oom", site="nowhere"):
                pass
    assert faults.SITES == jres.faults.SITES
    assert sorted(faults._KINDS) == sorted(jres.faults._KINDS)
    for kind, (sites, retry, _) in faults._KINDS.items():
        assert (sites, retry) == jres.faults._KINDS[kind][:2], kind
    assert not faults._ACTIVE


def test_fault_classes_keep_the_reference_bases():
    assert issubclass(faults.FaultInjected, MXNetError)
    assert issubclass(faults.SimulatedCrash, faults.FaultInjected)
    assert issubclass(faults.PreemptionNotice, faults.FaultInjected)
    assert not issubclass(faults.WorkerKilled, Exception)
    with faults.inject("device_oom", every_n=1, times=1):
        with pytest.raises(FaultInjected) as ei:
            faults.check("train_step")
    msg = str(ei.value)
    assert "RESOURCE_EXHAUSTED" in msg and "CUDA out of memory" in msg
    assert ei.value.retryable and res.retry.is_oom_error(ei.value)
    assert jres.retry.is_oom_error(RuntimeError(msg))
    with faults.inject("worker_kill", site="serving_dispatch", every_n=1):
        with pytest.raises(faults.WorkerKilled):
            faults.check("serving_dispatch")


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=5, jitter=0.3),
                                dict(seed=9, base_ms=7.0, multiplier=3.0,
                                     max_ms=100.0, jitter=0.0)])
def test_retry_delays_match_reference(kw):
    a = RetryPolicy(**kw)
    b = jres.RetryPolicy(**kw)
    assert [a.delay_ms(i) for i in range(12)] == \
        [b.delay_ms(i) for i in range(12)]
    assert repr(a) == repr(b)


CLASSIFY = [
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while allocating"),
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("INVALID_ARGUMENT: shape mismatch in dot"),
    RuntimeError("INVALID_ARGUMENT: Failed to allocate"),
    ValueError("dtype mismatch"),
    RuntimeError("something transient happened"),
    KeyError("plain bug"),
    RuntimeError("ABORTED: collective cancelled"),
]


@pytest.mark.parametrize("i", range(len(CLASSIFY)))
def test_retry_classification_matches_reference(i):
    e = CLASSIFY[i]
    assert res.classify_error(e) == jres.classify_error(e)
    assert res.retry.is_oom_error(e) == jres.retry.is_oom_error(e)


def test_retry_classification_of_torch_and_cuda_errors():
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB")
    assert res.classify_error(oom) and res.retry.is_oom_error(oom)
    assert res.classify_error(torch.cuda.OutOfMemoryError("x"))
    for sticky in ("CUDA error: an illegal memory access was encountered",
                   "CUDA error: device-side assert triggered",
                   "CUDA error: unspecified launch failure"):
        assert not res.classify_error(RuntimeError(sticky))
    assert not res.classify_error(res.NumericsError("nan"))
    with faults.inject("shape_mismatch", every_n=1):
        with pytest.raises(FaultInjected) as ei:
            faults.check("train_step")
    assert not res.classify_error(ei.value)


def test_retry_policy_run_paths():
    slept = []
    pol = RetryPolicy(max_attempts=3, base_ms=10.0, jitter=0.0,
                      sleep=slept.append)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise RuntimeError("UNAVAILABLE: try again")
        return "ok"

    assert pol.run(flaky) == "ok" and slept == [0.01, 0.02]
    with pytest.raises(KeyError):
        pol.run(lambda: (_ for _ in ()).throw(KeyError("fatal")))

    def always():
        raise RuntimeError("RESOURCE_EXHAUSTED")

    with pytest.raises(RuntimeError):
        pol.run(always)
    from mxnet_tpu_torch.serving import DeadlineExceeded
    with pytest.raises(DeadlineExceeded):
        pol.run(always, deadline_us=res.retry._now_us() - 1)
    seen = []
    with pytest.raises(MXNetError, match="stop"):
        pol.run(always, on_retry=lambda e, a, d: (seen.append(a),
                                                  (_ for _ in ()).throw(
                                                      MXNetError("stop"))))
    assert seen == [0]


# ---------------------------------------------------------------------------
# the train step: retry, the compile site, the refusal once a write began
# ---------------------------------------------------------------------------
def test_train_step_retries_through_injected_oom_bitwise():
    X, Y = _data(0, 6)

    def run(with_faults):
        step = _port_step(_bn_net(mt, 3), seed=3)
        if with_faults:
            with faults.inject("device_oom", every_n=3) as inj:
                losses = [float(step(X[i], Y[i])) for i in range(6)]
            assert inj.fires >= 2
        else:
            losses = [float(step(X[i], Y[i])) for i in range(6)]
        return losses, _state(step)

    ref_l, ref_w = run(False)
    got_l, got_w = run(True)
    assert got_l == ref_l and _bitwise(got_w, ref_w)


def test_train_step_fatal_fault_and_compile_retry():
    X, Y = _data(1, 3)
    step = _port_step(_bn_net(mt, 4), seed=4)
    with faults.inject("compile_error", every_n=1, times=1) as inj:
        step(X[0], Y[0])                 # the first run fails once
    assert inj.fires == 1 and step._t == 1
    before = _state(step)
    gen = step.generator.get_state()
    with faults.inject("shape_mismatch", every_n=1, times=1):
        with pytest.raises(FaultInjected):
            step(X[1], Y[1])
    assert step._t == 1 and _bitwise(_state(step), before)
    assert torch.equal(step.generator.get_state(), gen)
    assert onp.isfinite(float(step(X[1], Y[1])))


def test_retry_refused_once_the_update_began(monkeypatch):
    """An OOM inside the optimizer's in-place update cannot be retried:
    the reference's message, restore from the latest checkpoint. One in
    the backward of a net without BatchNorm (no write yet) is retried
    and the step equals a clean one bit for bit."""
    X, Y = _data(2, 1)
    step = _port_step(_bn_net(mt, 5), seed=5)
    real = step._optimizer._rule
    calls = [0]

    def failing_rule(*a):
        calls[0] += 1
        if calls[0] == 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 1.00 GiB")
        return real(*a)

    monkeypatch.setattr(step._optimizer, "_rule", failing_rule)
    with pytest.raises(MXNetError, match="restore from the latest "
                                         "checkpoint"):
        step(X[0], Y[0])

    def plain(seed):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, in_units=8, activation="relu"),
                gluon.nn.Dense(4, in_units=16))
        net.initialize()
        for p, w in zip(net.collect_params().values(),
                        _weights(seed, ((16, 8), (16,), (4, 16), (4,)))):
            p.set_data(w)
        return _port_step(net, seed=seed)

    want = plain(6)
    want(X[0], Y[0])
    got = plain(6)
    real_loss = got._loss
    fired = [0]

    def oom_once(*a):
        out = real_loss(*a)
        if not fired[0]:
            fired[0] = 1
            raise torch.OutOfMemoryError("CUDA out of memory.")
        return out

    got._loss = oom_once
    got(X[0], Y[0])
    assert fired[0] == 1 and _bitwise(_state(got), _state(want))


def test_dropout_generator_rides_retry_and_restore(tmp_path):
    """Small BERT with dropout 0.1: an OOM every 3rd attempt, a crash and a
    restore into a step of other weights and another seed give the
    uninterrupted run's losses and state bit for bit (the generator's
    state is part of the checkpoint)."""
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.tools import PretrainStep
    cfg = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
               vocab_size=64, max_length=32, dropout=0.1)
    rng = onp.random.RandomState(3)
    toks = rng.randint(0, 64, (6, 2, 32)).astype("int32")
    tt = rng.randint(0, 2, (6, 2, 32)).astype("int32")
    pos = onp.sort(rng.rand(6, 2, 32).argsort(-1)[..., :4], -1).astype(
        "int32")
    mlm = rng.randint(0, 64, (6, 2, 4)).astype("int32")
    nsp = rng.randint(0, 2, (6, 2)).astype("int32")

    def build(seed):
        mt.random.seed(seed)
        m = bert.BERTForPretraining(bert.BERTModel(**cfg), vocab_size=64)
        m.initialize(mt.init.Normal(0.02), ctx=CPU)
        return parallel.ParallelTrainStep(
            PretrainStep(m), bert.BERTPretrainingLoss(),
            optimizer.Adam(learning_rate=1e-3),
            parallel.make_mesh({"dp": 1}, ctx=CPU),
            extra_specs=("dp", "dp"), seed=seed,
            retry_policy=RetryPolicy(max_attempts=3, base_ms=0.0))

    def run(step, i):
        return float(step(toks[i], (mlm[i], nsp[i]), tt[i], pos[i]))

    ref = build(1)
    want = [run(ref, i) for i in range(6)]
    cm = CheckpointManager(str(tmp_path), keep=2, fsync=False)
    step = build(1)
    with faults.inject("device_oom", every_n=3) as inj:
        got = [run(step, i) for i in range(3)]
        cm.save(3, train_step=step)
        step = build(77)
        assert cm.restore_latest(train_step=step)[0] == 3
        got += [run(step, i) for i in range(3, 6)]
    assert inj.fires >= 2
    assert got == want and _bitwise(_state(step), _state(ref))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_and_rotation(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2, fsync=False)
    state = {"arrs": {"w": onp.arange(6, dtype="float32").reshape(2, 3)},
             "scalar": 7, "name": "x"}
    for s in (1, 2, 3):
        cm.save(s, state)
    assert cm.steps() == [2, 3]
    step, got = cm.restore_latest()
    assert step == 3 and got["scalar"] == 7 and got["name"] == "x"
    onp.testing.assert_array_equal(got["arrs"]["w"], state["arrs"]["w"])
    assert sorted(os.listdir(cm._path(3))) == ["MANIFEST.json", "meta.json",
                                               "state.npz"]
    with pytest.raises(MXNetError, match="either"):
        cm.save(4, state, train_step=None)
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() is None


def test_checkpoint_async_overlaps_and_waits(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=True, fsync=False)
    big = {"w": onp.ones((256, 256), "float32")}
    for s in range(1, 4):
        cm.save(s, big)
    cm.wait()
    assert cm.steps()[-1] == 3 and cm.saves["ok"] == 3


def test_checkpoint_torn_write_and_bit_rot_fall_back(tmp_path, caplog):
    cm = CheckpointManager(str(tmp_path), keep=3, fsync=False)
    cm.save(1, {"w": onp.full(4, 1.0, "float32")})
    with faults.inject("crash", every_n=1, times=1):
        with pytest.raises(SimulatedCrash):
            cm.save(2, {"w": onp.full(4, 2.0, "float32")})
    assert cm.steps() == [1]             # the torn save never landed
    cm.save(3, {"w": onp.full(4, 3.0, "float32")})
    data = os.path.join(cm._path(3), "state.npz")
    with open(data, "r+b") as f:
        f.seek(os.path.getsize(data) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(MXNetError, match="checksum"):
        res.verify_checkpoint_dir(cm._path(3))
    step, st = cm.restore_latest()
    assert step == 1 and st["w"][0] == 1.0
    assert cm.restores["corrupt_skipped"] == 1
    assert any("failed verification" in r.message for r in caplog.records)


def test_async_writer_error_wait_timeout_and_rotation(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=True, fsync=False,
                           keep=1)
    with faults.inject("crash", every_n=1, times=1):
        cm.save(1, {"w": onp.zeros(3, "float32")})
        with pytest.raises(SimulatedCrash):
            cm.wait()
    release = threading.Event()
    real = cm._save_sync

    def wedged(step, state):
        release.wait(10)
        real(step, state)

    cm._save_sync = wedged
    cm.save(2, {"w": onp.zeros(3, "float32")})
    with pytest.raises(MXNetError, match="still running"):
        cm.wait(timeout=0.05)
    release.set()
    cm.wait()
    cm._save_sync = real
    cm.save(3, {"w": onp.zeros(3, "float32")})
    cm.wait()
    assert cm.steps() == [3]


def test_dataloader_and_feed_position_through_the_manager(tmp_path):
    from mxnet_tpu_torch.embedding import DeviceFeed
    X = onp.arange(40, dtype="float32").reshape(20, 2)
    mt.random.seed(4)
    loader = DataLoader(ArrayDataset(X), batch_size=4, shuffle=True)
    want = [b.asnumpy() for b in loader]
    mt.random.seed(4)
    loader = DataLoader(ArrayDataset(X), batch_size=4, shuffle=True)
    feed = DeviceFeed(DataLoader(ArrayDataset(X), batch_size=4,
                                 shuffle=False))
    it, fit = iter(loader), iter(feed)
    got = [next(it).asnumpy() for _ in range(2)]
    fed = [next(fit).asnumpy() for _ in range(3)]
    cm = CheckpointManager(str(tmp_path), fsync=False)
    cm.save(2, dataloader=loader, extra={"feed": feed.state_dict()})
    mt.random.seed(99)
    loader2 = DataLoader(ArrayDataset(X), batch_size=4, shuffle=True)
    feed2 = DeviceFeed(DataLoader(ArrayDataset(X), batch_size=4,
                                  shuffle=False))
    _, st = cm.restore_latest(dataloader=loader2)
    feed2.load_state_dict(st["extra"]["feed"])
    got += [b.asnumpy() for b in loader2]
    fed += [b.asnumpy() for b in feed2]
    assert len(got) == len(want)
    assert all(onp.array_equal(a, b) for a, b in zip(got, want))
    onp.testing.assert_array_equal(onp.concatenate(fed), X)


# ---------------------------------------------------------------------------
# the acceptance bar, inside the port
# ---------------------------------------------------------------------------
def test_training_chaos_crash_restore_bitwise(tmp_path):
    """Device OOM every 3rd attempt plus a crash and restore at step 10 of
    20: the losses and every parameter and state equal the uninterrupted
    run bit for bit (BatchNorm's running statistics included)."""
    STEPS, CRASH_AT = 20, 10
    X, Y = _data(1, STEPS)
    ref = _port_step(_bn_net(mt, 11), seed=11)
    want = [float(ref(X[i], Y[i])) for i in range(STEPS)]
    cm = CheckpointManager(str(tmp_path), keep=2, fsync=False)
    step = _port_step(_bn_net(mt, 11), seed=11)
    losses = []
    with faults.inject("device_oom", every_n=3) as inj:
        for i in range(CRASH_AT):
            losses.append(float(step(X[i], Y[i])))
            if i % 4 == 3:
                cm.save(i + 1, train_step=step)
        cm.save(CRASH_AT, train_step=step)
        del step
        step = _port_step(_bn_net(mt, 999), seed=999)
        restored = cm.restore_latest(train_step=step)
        assert restored is not None and restored[0] == CRASH_AT
        for i in range(CRASH_AT, STEPS):
            losses.append(float(step(X[i], Y[i])))
    assert inj.fires >= 5
    assert losses == want
    assert _bitwise(_state(step), _state(ref))
    assert cm.steps() == [8, 10]


def test_state_dict_keys_and_shape_guard():
    step = _port_step(_bn_net(mt, 6), seed=6)
    X, Y = _data(6, 1)
    step(X[0], Y[0])
    st = step.state_dict()
    assert st["kind"] == "ParallelTrainStep" and st["t"] == 1
    assert st["n_params"] == 7 and sorted(st["params"]) == \
        [f"p{i}" for i in range(7)]
    assert sorted(st["opt"]) == [f"s{j}" for j in range(5)]
    assert sorted(st["opt"]["s0"]) == ["l0", "l1"]
    assert st["generator"].dtype == onp.uint8
    ref = _ref_step(_bn_net(mx, 6))
    rst = ref.state_dict()
    assert [n.rsplit("_", 1)[-1] for n in st["param_names"].split(",")] == \
        [n.rsplit("_", 1)[-1] for n in rst["param_names"].split(",")]
    for k in rst["params"]:
        assert st["params"][k].shape == rst["params"][k].shape, k
    other = parallel.ParallelTrainStep(
        _bn_net(mt, 7), gluon.loss.L2Loss(), optimizer.Adam(),
        parallel.make_mesh({"dp": 1}, ctx=CPU))
    bad = dict(st, params=dict(st["params"],
                               p0=onp.zeros((3, 3), "float32")))
    with pytest.raises(MXNetError, match="shape mismatch"):
        other.load_state_dict(bad)
    with pytest.raises(MXNetError, match="expected 7 params"):
        other.load_state_dict(dict(st, n_params=3))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """A port checkpoint passes the reference's verify_checkpoint_dir, and
    its params (BatchNorm's statistics included), Adam state and t restore
    into the reference's step: the next step of each package from it agree
    within 1e-5."""
    X, Y = _data(3, 4)
    step = _port_step(_bn_net(mt, 12), seed=12)
    for i in range(3):
        step(X[i], Y[i])
    cm = CheckpointManager(str(tmp_path), fsync=False)
    cm.save(3, train_step=step)
    st = jres.verify_checkpoint_dir(cm._path(3))
    ref = _ref_step(_bn_net(mx, 50))
    jres.apply_state(st, train_step=ref, restore_rng=False)
    assert ref._t == 3
    for a, b in zip(ref.state_dict()["params"].values(),
                    step.state_dict()["params"].values()):
        onp.testing.assert_array_equal(a, b)
    want = float(ref(X[3], Y[3]).asscalar())
    got = float(step(X[3], Y[3]))
    onp.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(ref.state_dict()["params"].values(),
                    step.state_dict()["params"].values()):
        onp.testing.assert_allclose(b, a, **TOL)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A reference checkpoint (dense) restores into the port's step; its
    threefry random state refuses restore_rng=True by name."""
    X, Y = _data(4, 4)
    ref = _ref_step(_bn_net(mx, 13))
    for i in range(3):
        ref(X[i], Y[i])
    cm = jres.CheckpointManager(str(tmp_path), fsync=False)
    cm.save(3, train_step=ref)
    port = _port_step(_bn_net(mt, 51), seed=51)
    mine = CheckpointManager(str(tmp_path), fsync=False)
    with pytest.raises(MXNetError, match="restore_rng=False"):
        mine.restore_latest(train_step=port)
    step, _ = mine.restore_latest(train_step=port, restore_rng=False)
    assert step == 3 and port._t == 3
    want = float(ref(X[3], Y[3]).asscalar())
    got = float(port(X[3], Y[3]))
    onp.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(ref.state_dict()["params"].values(),
                    port.state_dict()["params"].values()):
        onp.testing.assert_allclose(b, a, **TOL)


def test_reference_four_device_sharded_checkpoint_restores(tmp_path):
    """The reference's sharded save on a 4-device fsdp mesh (four shard
    files) assembles into the port's one-process step; one further step
    agrees with the reference's within 1e-5."""
    X, Y = _data(5, 4, out=8)
    mx.random.seed(11)
    net = jnn.HybridSequential()
    with net.name_scope():
        net.add(jnn.Dense(16, activation="relu"), jnn.Dense(8))
    net.initialize()
    net(mx.nd.array(onp.zeros((2, 8), "float32")))
    for p, w in zip(net.collect_params().values(),
                    _weights(14, ((16, 8), (16,), (8, 16), (8,)))):
        p.set_data(mx.nd.array(w))
        p.shard(("fsdp",))
    ref = jparallel.ParallelTrainStep(
        net, jloss.L2Loss(), mx.optimizer.Adam(learning_rate=0.05),
        jparallel.make_mesh({"fsdp": 4}, devices=jax.devices()[:4]),
        data_spec=(), label_spec=())
    for i in range(3):
        ref(X[i], Y[i])
    cm = jres.CheckpointManager(str(tmp_path), fsync=False)
    cm.save(3, train_step=ref, sharded=True)
    files = sorted(os.listdir(cm._path(3)))
    assert [f for f in files if f.startswith("shard-")] == \
        [f"shard-{i:05d}.npz" for i in range(4)]
    pnet = gluon.nn.HybridSequential()
    pnet.add(gluon.nn.Dense(16, activation="relu", in_units=8),
             gluon.nn.Dense(8, in_units=16))
    pnet.initialize()
    port = _port_step(pnet, seed=0)
    step, _ = CheckpointManager(str(tmp_path)).restore_latest(
        train_step=port, restore_rng=False)
    assert step == 3
    for a, b in zip(ref.state_dict()["params"].values(),
                    port.state_dict()["params"].values()):
        onp.testing.assert_array_equal(a, b)
    want = float(ref(X[3], Y[3]).asscalar())
    got = float(port(X[3], Y[3]))
    onp.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(ref.state_dict()["params"].values(),
                    port.state_dict()["params"].values()):
        onp.testing.assert_allclose(b, a, **TOL)


# ---------------------------------------------------------------------------
# the random module's state
# ---------------------------------------------------------------------------
def test_random_state_round_trips():
    mt.random.seed(5)
    torch.rand(3, generator=mt.random.generator(CPU))
    mt.random.python_rng().random()
    st = mt.random.get_state()
    assert st["impl"] == "torch" and st["typed"] == 0
    assert st["data"].dtype == onp.uint8

    def draws():
        return (torch.rand(4, generator=mt.random.generator(CPU)).tolist(),
                torch.rand(2, generator=mt.random.generator(mt.cpu(1))
                           ).tolist(),
                mt.random.python_rng().random(),
                mt.random.numpy_rng().rand(2).tolist())

    want = draws()
    mt.random.seed(1234)
    draws()
    mt.random.set_state(st)
    assert draws() == want


def test_random_state_refuses_threefry():
    mx.random.seed(3)
    with pytest.raises(MXNetError, match="restore_rng=False"):
        mt.random.set_state(mx.random.get_state())
    with pytest.raises(MXNetError, match="restore_rng=False"):
        res.apply_state({"rng": mx.random.get_state()})


# ---------------------------------------------------------------------------
# watchdog and circuit breaker
# ---------------------------------------------------------------------------
def test_watchdog_fires_on_stall_once():
    fired = []
    wd = Watchdog(stall_s=0.05, poll_s=0.01,
                  on_stall=lambda name, dt: fired.append(name))
    try:
        with wd.watch("slow"):
            time.sleep(0.5)
        with wd.watch("fast"):
            pass
    finally:
        wd.stop()
    assert fired == ["slow"] and wd.stalls == 1
    assert mt.telemetry.REGISTRY.get("mxtpu_watchdog_stalls_total").labels(
        "slow").value >= 1


def test_circuit_breaker_walks_the_reference_states():
    """The same feed of outcomes walks both packages' breakers through the
    same states."""
    seq = ["f", "f", "f", "f", "ok", "f", "f", "f", "f", "f", "f",
           "wait", "allow", "f", "wait", "allow", "ok"]

    def walk(cls):
        cb = cls("s", degraded_after=2, open_after=4, cooldown_s=0.5)
        states = []
        for ev in seq:
            if ev == "f":
                cb.record_failure()
            elif ev == "ok":
                cb.record_success()
            elif ev == "wait":
                time.sleep(0.55)
            else:
                states.append(cb.allow())
            states.append(cb.state())
        return states, [t[1] for t in cb.transitions]

    got = walk(CircuitBreaker)
    assert got == walk(jres.CircuitBreaker)
    assert {"degraded", "open", "half_open", "healthy"} <= set(got[1])
    cb = CircuitBreaker("x")
    cb.force_degraded()
    assert cb.code == 1 and cb.snapshot()["state"] == "degraded"


# ---------------------------------------------------------------------------
# the decode path's fault points
# ---------------------------------------------------------------------------
LM_CFG = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
              vocab_size=50, max_length=64)


@pytest.fixture(scope="module")
def engine():
    rng = onp.random.RandomState(0)
    named = {}
    for k, v in TransformerLM(**LM_CFG)._collect_params_with_prefix().items():
        named[k] = (onp.ones(v.shape, "float32") if k.endswith("gamma")
                    else rng.normal(0, 0.5, v.shape).astype("float32"))
    lm = TransformerLM(**LM_CFG)
    load_jax_params(lm, named, ctx=CPU)
    eng = DecodeEndpoint("rlm", lm, max_seq_len=64, max_batch_size=4,
                         page_size=8, num_pages=64, ctx=CPU)
    eng.warmup()
    return eng


def _decode_one(eng, prompt, budget):
    sched = DecodeScheduler(eng, poll_s=0.02).start()
    try:
        return sched.submit(prompt, max_new_tokens=budget).result(
            timeout=60), sched
    finally:
        sched.stop()


def test_decode_fault_points(engine, monkeypatch):
    """One sequence a run, so the ``decode`` site's calls are in a fixed
    order: its reservation (call 1), then one a decode step."""
    prompt, budget = [1, 2, 3], 6
    want, _ = _decode_one(engine, prompt, budget)
    base = engine.pool.pages_in_use
    with faults.inject("kv_exhausted", every_n=1, times=1):
        with pytest.raises(KVPoolExhausted, match="RESOURCE_EXHAUSTED"):
            engine.pool.reserve(777, 10)
    assert engine.pool.pages_in_use == base
    # out of pages at admission: the sequence stays queued, then runs
    with faults.inject("kv_exhausted", at=(1,)) as kv:
        got, _ = _decode_one(engine, prompt, budget)
    assert kv.fires == 1 and got == want
    # a transient fault at the step boundary is absorbed, the batch
    # re-formed
    with faults.inject("unavailable", site="decode", at=(3, 4)) as inj:
        got, _ = _decode_one(engine, prompt, budget)
    assert inj.fires == 2 and got == want
    # decode_stall kills the worker: failover requeues, no dup or drop
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    with faults.inject("decode_stall", at=(4,)) as st:
        got, sched = _decode_one(engine, prompt, budget)
    assert st.fires == 1 and got == want and sched.failovers == 1
    assert engine.pool.pages_in_use == base
    # the compile site at a bucket's first run
    engine._warm_decode.discard(engine.decode_buckets[-1])
    with faults.inject("compile_error", every_n=1, times=1):
        with pytest.raises(FaultInjected, match="compilation"):
            engine.warmup()
    assert engine.warmup() == 1
