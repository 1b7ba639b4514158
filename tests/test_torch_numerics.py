"""The port's NumericsGuard (mxnet_tpu_torch.resilience.numerics) against
the JAX package's on the CPU.

Both packages train a Dense-ReLU-Dense net from the same seeded numpy
weights on the same batches under the same injection schedule: the step
each guard flags, its kind and the action taken must be equal, and the
EWMA detectors must flag the same readings of the same series. Inside the
port the acceptance bar is the reference's: a guarded run under injected
``nan_grad``/``bad_batch``/``loss_spike`` ends bitwise equal to a clean run
fed the same batches minus the skipped ones; an injected ``sdc`` mismatch
writes a bundle that ``mxnet_tpu_torch/tools/replay_step.py`` replays to
the same verdict, bit for bit. A small BERT (integer token batches, which
carry no NaN: the step's loss is poisoned instead) is held to the same
bar.
"""
import json
import math
import os

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import resilience as jres
from mxnet_tpu.gluon import loss as jloss

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, gluon, optimizer, parallel
from mxnet_tpu_torch.amp import LossScaler
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.resilience import (BadBatchError, CheckpointManager,
                                        EWMADetector, NumericsError,
                                        NumericsGuard, PreemptionGuard,
                                        RetryPolicy, SDCSuspectError,
                                        classify_error, faults)
from mxnet_tpu_torch.tools import replay_step

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

IN, HID, OUT, BS = 8, 16, 4, 16
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _w(seed):
    rng = onp.random.RandomState(seed)
    return [(0.4 * rng.randn(*s)).astype("float32")
            for s in ((HID, IN), (HID,), (OUT, HID), (OUT,))]


def _build(seed=0, lr=0.05):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(HID, activation="relu", in_units=IN),
            gluon.nn.Dense(OUT, in_units=HID))
    net.initialize()
    for p, w in zip(net.collect_params().values(), _w(seed)):
        p.set_data(w)
    return net, parallel.ParallelTrainStep(
        net, gluon.loss.L2Loss(), optimizer.Adam(learning_rate=lr),
        parallel.make_mesh({"dp": 1}, ctx=CPU), seed=seed,
        retry_policy=RetryPolicy(max_attempts=3, base_ms=0.0, seed=seed))


def _ref_build(seed=0, lr=0.05):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(HID, activation="relu", in_units=IN),
            mx.gluon.nn.Dense(OUT, in_units=HID))
    net.initialize()
    for p, w in zip(net.collect_params().values(), _w(seed)):
        p.set_data(mx.nd.array(w))
    mesh = jparallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return net, jparallel.ParallelTrainStep(
        net, jloss.L2Loss(), mx.optimizer.Adam(learning_rate=lr), mesh,
        retry_policy=jres.RetryPolicy(max_attempts=3, base_ms=0.0))


def _data(seed, steps):
    rng = onp.random.RandomState(seed)
    return (rng.randn(steps, BS, IN).astype("float32"),
            rng.randn(steps, BS, OUT).astype("float32"))


def _params(step):
    return [t.detach().clone() for t in step._ordered_tensors()]


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _decision(guard):
    a = guard.last_anomaly
    return (None if a is None else (a["kind"], a["action"], a["t"],
                                    a["window_index"], a["injected"]),
            guard.skipped_steps, guard.recoveries)


def _guarded(pkg_build, pkg_guard, pkg_faults, X, Y, injections, **kw):
    """Train every batch under a guard and the injections; the guard."""
    _, step = pkg_build
    guard = pkg_guard(**kw)
    guard.attach(step)
    with _scoped(pkg_faults, injections):
        for i in range(len(X)):
            step(X[i], Y[i])
    guard.finalize()
    return guard, step


class _scoped:
    def __init__(self, pkg_faults, injections):
        self._cms = [pkg_faults.inject(kind, **kw) for kind, kw in
                     injections]

    def __enter__(self):
        for cm in self._cms:
            cm.__enter__()

    def __exit__(self, *exc):
        for cm in reversed(self._cms):
            cm.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ewma_detector_flags_the_reference_steps(seed):
    rng = onp.random.RandomState(seed)
    series = list(1.0 + 0.05 * rng.randn(80))
    for i in rng.choice(range(25, 80), 6, replace=False):
        series[i] *= float(rng.choice([1.5, 3.0, 12.0]))
    series[40] = float("nan")

    def run(cls):
        det = cls(alpha=0.1, zscore=4.0, warmup=10, rel_floor=0.1)
        flags = []
        for v in series:
            spike = det.is_spike(v)
            flags.append(spike)
            if not spike:
                det.update(v)
        return flags, det.state_dict()

    got = run(EWMADetector)
    assert got == run(jres.EWMADetector)
    assert sum(got[0]) >= 2
    det = EWMADetector(0.1, 4.0, 10)
    det.load_state_dict(got[1])
    assert det.state_dict() == got[1]


# ---------------------------------------------------------------------------
# the hot path
# ---------------------------------------------------------------------------
def test_guarded_run_bitwise_equal_to_unguarded():
    X, Y = _data(0, 9)
    _, a = _build(0)
    for i in range(9):
        a(X[i], Y[i])
    g, b = _guarded(_build(0), NumericsGuard, faults, X, Y, [],
                    check_every_n=4, policy="skip")
    assert _bitwise(_params(a), _params(b))
    assert g.checks["clean"] >= 2 and g.last_grad_norm > 0


def test_health_read_once_a_window():
    X, Y = _data(1, 12)
    _, step = _build(1)
    guard = NumericsGuard(check_every_n=4, policy="skip")
    guard.attach(step)
    for i in range(3):
        step(X[i], Y[i])
    assert len(guard._window) == 3 and guard.host_reads == 0
    assert all(r.finite_v is None for r in guard._window)
    assert all(isinstance(r.grad_norm, torch.Tensor) for r in guard._window)
    for i in range(3, 12):
        step(X[i], Y[i])
    # boundaries at 4, 8, 12: the first only ages its window
    assert guard.host_reads == 2
    guard.finalize()
    assert guard._window == [] and guard._prev == []
    assert guard.snapshot_bytes() > 0


def test_step_n_rejected_with_guard_attached():
    X, Y = _data(3, 4)
    _, step = _build(3)
    NumericsGuard(check_every_n=4).attach(step)
    with pytest.raises(MXNetError, match="step_n"):
        step.step_n(X, Y)


# ---------------------------------------------------------------------------
# skip: bitwise, and the reference's decisions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,bad_step", [("nan_grad", 5),
                                           ("nan_grad", 7),
                                           ("loss_spike", 6),
                                           ("bad_batch", 2)])
def test_skip_recovery_bitwise_and_decisions(kind, bad_step):
    steps = 12
    X, Y = _data(10, steps)
    _, clean = _build(10)
    for i in range(steps):
        if i != bad_step:
            clean(X[i], Y[i])
    kw = dict(check_every_n=4, policy="skip", warmup_steps=4,
              spike_zscore=6.0)
    inj = [(kind, dict(at=(bad_step + 1,)))]
    guard, step = _guarded(_build(10), NumericsGuard, faults, X, Y, inj,
                           **kw)
    ref, _ = _guarded(_ref_build(10), jres.NumericsGuard, jres.faults, X, Y,
                      inj, **kw)
    assert guard.skipped_steps == 1
    assert _bitwise(_params(clean), _params(step))
    assert _decision(guard) == _decision(ref)


def test_two_bad_steps_in_one_window():
    steps, bad = 10, (4, 6)
    X, Y = _data(11, steps)
    _, clean = _build(11)
    for i in range(steps):
        if i not in bad:
            clean(X[i], Y[i])
    inj = [("nan_grad", dict(at=tuple(i + 1 for i in bad)))]
    guard, step = _guarded(_build(11), NumericsGuard, faults, X, Y, inj,
                           check_every_n=5, policy="skip")
    ref, _ = _guarded(_ref_build(11), jres.NumericsGuard, jres.faults, X, Y,
                      inj, check_every_n=5, policy="skip")
    assert guard.skipped_steps == 2
    assert _bitwise(_params(clean), _params(step))
    assert _decision(guard) == _decision(ref)


def test_unrecoverable_window_raises_fatal_numerics_error():
    X, Y = _data(12, 6)
    _, step = _build(12)
    guard = NumericsGuard(check_every_n=3, policy="skip", max_recoveries=2)
    guard.attach(step)
    with faults.inject("nan_grad", every_n=1):
        with pytest.raises(NumericsError) as ei:
            for i in range(6):
                step(X[i], Y[i])
    assert not classify_error(ei.value)
    assert not classify_error(BadBatchError("x"))
    assert not classify_error(SDCSuspectError("x"))


def test_auto_policy_quarantines_second_offense():
    steps = 12
    X, Y = _data(26, steps)
    X[7], Y[7] = X[1], Y[1]               # the same batch offends again
    inj = [("nan_grad", dict(at=(2, 8)))]
    guard, _ = _guarded(_build(26), NumericsGuard, faults, X, Y, inj,
                        check_every_n=3, policy="auto")
    ref, _ = _guarded(_ref_build(26), jres.NumericsGuard, jres.faults, X, Y,
                      inj, check_every_n=3, policy="auto")
    assert guard.skipped_steps == 2
    assert guard.last_anomaly["action"] == "quarantine"
    assert guard.quarantined == 1
    assert _decision(guard) == _decision(ref)


# ---------------------------------------------------------------------------
# quarantine and rewind through the port's DataLoader
# ---------------------------------------------------------------------------
def test_quarantine_dumps_fingerprint_and_excludes_position(tmp_path):
    steps, bad = 8, 5
    rng = onp.random.RandomState(20)
    X = rng.randn(steps * BS, IN).astype("float32")
    Y = rng.randn(steps * BS, OUT).astype("float32")
    qdir = str(tmp_path / "quarantine")
    _, step = _build(20)
    mt.random.seed(21)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=BS, shuffle=True)
    guard = NumericsGuard(check_every_n=4, policy="quarantine",
                          quarantine_dir=qdir, dataloader=loader)
    guard.attach(step)
    with faults.inject("bad_batch", at=(bad + 1,)):
        for x, y in loader:
            step(x._data, y._data)
    guard.finalize()
    assert loader.quarantined == [(0, bad)]
    files = sorted(os.listdir(qdir))
    metas = [f for f in files if f.endswith(".json")]
    assert len(metas) == 1 and len(files) == 2
    with open(os.path.join(qdir, metas[0])) as f:
        meta = json.load(f)
    assert meta["batch_pos"] == [0, bad] and len(meta["fingerprint"]) == 64
    assert meta["injected"] == "bad_batch"
    with onp.load(os.path.join(qdir, metas[0][:-5] + ".npz")) as z:
        assert not onp.isfinite(z["x"]).all()


def test_rewind_restores_checkpoint_and_quarantines_window(tmp_path):
    steps = 10
    rng = onp.random.RandomState(30)
    X = rng.randn(steps * BS, IN).astype("float32")
    Y = rng.randn(steps * BS, OUT).astype("float32")
    cm = CheckpointManager(str(tmp_path), fsync=False)
    _, step = _build(30)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=BS, shuffle=False)
    guard = NumericsGuard(check_every_n=3, policy="rewind",
                          checkpoint_manager=cm, dataloader=loader)
    guard.attach(step)
    with faults.inject("nan_grad", at=(5,)):
        for i, (x, y) in enumerate(loader):
            step(x._data, y._data)
            if i == 2:
                guard.finalize()
                cm.save(3, train_step=step, dataloader=loader)
            if i >= steps - 1:
                break
    guard.finalize()
    assert guard.recoveries == 1
    assert guard.last_anomaly["action"] == "rewind"
    assert step._t >= 3 and (0, 4) in loader._quarantined
    assert all(math.isfinite(float(t.sum())) for t in _params(step))

    _, other = _build(32)
    g2 = NumericsGuard(check_every_n=2, policy="rewind")
    g2.attach(other)
    with faults.inject("nan_grad", at=(1,)):
        with pytest.raises(NumericsError, match="checkpoint_manager"):
            for i in range(4):
                other(X[i * BS:(i + 1) * BS], Y[i * BS:(i + 1) * BS])


# ---------------------------------------------------------------------------
# SDC screening and the replay tool
# ---------------------------------------------------------------------------
def test_sdc_clean_screen_is_invisible():
    steps = 8
    X, Y = _data(40, steps)
    _, clean = _build(40)
    for i in range(steps):
        clean(X[i], Y[i])
    guard, step = _guarded(_build(40), NumericsGuard, faults, X, Y, [],
                           check_every_n=4, policy="skip",
                           sdc_check_every_n=8)
    assert guard.sdc_checks == {"match": 1, "mismatch": 0}
    assert guard.last_sdc["match"]
    assert _bitwise(_params(clean), _params(step))


def test_sdc_mismatch_writes_a_bundle_the_tool_replays(tmp_path):
    steps = 8
    X, Y = _data(41, steps)
    _, step = _build(41)
    guard = NumericsGuard(check_every_n=4, policy="skip",
                          sdc_check_every_n=8, sdc_bundle_dir=str(tmp_path),
                          repro_meta=dict(seed=41, in_dim=IN, hidden=HID,
                                          out_dim=OUT, lr=0.05))
    guard.attach(step)
    with faults.inject("sdc", at=(1,)):
        for i in range(steps):
            step(X[i], Y[i])
        guard.finalize()
    assert guard.sdc_suspects == 1 and len(guard.sdc_bundles) == 1
    bundle = guard.sdc_bundles[0]
    assert sorted(os.listdir(bundle)) == ["meta.json", "records.npz",
                                          "state.npz"]

    def builder(meta, ctx):
        return _build(meta["repro"]["seed"])[1]

    r1 = replay_step.replay(bundle, builder=builder, ctx=CPU)
    r2 = replay_step.replay(bundle, builder=builder, ctx=CPU)
    assert r1["verdict"] == "replay_corrupt" and r1["bitwise"]
    assert r1 == r2 and r1["pre_digest_ok"]
    _, strict = _build(42)
    NumericsGuard(check_every_n=4, policy="skip", sdc_check_every_n=8,
                  sdc_raise=True).attach(strict)
    with faults.inject("sdc", at=(1,)):
        with pytest.raises(SDCSuspectError) as ei:
            for i in range(steps):
                strict(X[i], Y[i])
            strict._guard.finalize()
    assert not classify_error(ei.value)


# ---------------------------------------------------------------------------
# checkpoints, preemption, the loss scaler
# ---------------------------------------------------------------------------
def test_guard_state_roundtrips_and_crash_restore_stays_bitwise(tmp_path):
    steps, crash_at = 10, 5
    X, Y = _data(52, steps)
    _, clean = _build(52)
    for i in range(steps):
        clean(X[i], Y[i])
    cm = CheckpointManager(str(tmp_path), fsync=False)
    _, step = _build(52)
    guard = NumericsGuard(check_every_n=5, policy="skip")
    guard.attach(step)
    for i in range(crash_at):
        step(X[i], Y[i])
    guard.finalize()
    cm.save(crash_at, train_step=step, numerics=guard)
    _, step = _build(999)
    guard2 = NumericsGuard(check_every_n=5, policy="skip")
    guard2.attach(step)
    assert cm.restore_latest(train_step=step, numerics=guard2) is not None
    assert guard2.loss_detector.state_dict() == \
        guard.loss_detector.state_dict()
    assert guard2._window == [] and guard2._snapshot["t"] == step._t
    for i in range(crash_at, steps):
        step(X[i], Y[i])
    guard2.finalize()
    assert _bitwise(_params(clean), _params(step))


def test_preemption_flush_finalizes_guard_first(tmp_path):
    """A notice arriving with an unread NaN in the retained window flushes
    the recovered state, never the NaN."""
    steps, bad, preempt_at = 8, 4, 6
    X, Y = _data(53, steps)
    _, clean = _build(53)
    for i in range(preempt_at):
        if i != bad:
            clean(X[i], Y[i])
    cm = CheckpointManager(str(tmp_path), fsync=False)
    _, step = _build(53)
    guard = NumericsGuard(check_every_n=10, policy="skip")
    guard.attach(step)
    pguard = PreemptionGuard(cm, capture=dict(train_step=step),
                             numerics_guard=guard, deadline_s=30.0)
    with pguard, faults.inject("nan_grad", at=(bad + 1,)), \
            faults.inject("preempt", at=(preempt_at,)):
        for i in range(steps):
            step(X[i], Y[i])
            if pguard.should_stop(i + 1):
                break
    assert pguard.last_flush["saved"]
    _, fresh = _build(54)
    assert cm.restore_latest(train_step=fresh) is not None
    assert _bitwise(_params(clean), _params(fresh))


def test_loss_scaler_adopts_the_guard_flag_and_rides_the_manager(tmp_path):
    X, Y = _data(60, 4)
    _, step = _build(60)
    ls = LossScaler(init_scale=2.0 ** 8, scale_window=7)
    guard = NumericsGuard(check_every_n=10, policy="skip", loss_scaler=ls)
    guard.attach(step)
    step(X[0], Y[0])
    assert ls._pending is not None and not ls.wait_and_update()
    with faults.inject("nan_grad", every_n=1, times=1):
        step(X[1], Y[1])
    assert ls.wait_and_update() and ls.loss_scale == 2.0 ** 7
    ls._unskipped = 3
    cm = CheckpointManager(str(tmp_path), fsync=False)
    cm.save(1, train_step=step, loss_scaler=ls, numerics=guard)
    ls2 = LossScaler()
    _, step2 = _build(61)
    assert cm.restore_latest(train_step=step2, loss_scaler=ls2) is not None
    assert ls2.loss_scale == 2.0 ** 7 and ls2._unskipped == 3


def test_injected_numerics_kinds_are_fatal_if_unconsumed():
    with faults.inject("nan_grad", every_n=1):
        with pytest.raises(faults.FaultInjected) as ei:
            faults.check("numerics")
    assert not ei.value.retryable and not classify_error(ei.value)
    calls = [0]

    def nan_step():
        calls[0] += 1
        raise NumericsError("non-finite gradient")

    with pytest.raises(NumericsError):
        RetryPolicy(max_attempts=5, base_ms=0.0).run(nan_step)
    assert calls[0] == 1


# ---------------------------------------------------------------------------
# BERT: integer batches, the poisoned loss
# ---------------------------------------------------------------------------
def test_bert_token_batches_skip_bitwise():
    """Token ids cannot carry a NaN: ``nan_grad`` poisons the step's loss,
    and the skip path equals a clean run without that batch, dropout and
    all."""
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.tools import PretrainStep
    cfg = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
               vocab_size=64, max_length=32, dropout=0.1)
    rng = onp.random.RandomState(5)
    n = 6
    toks = rng.randint(0, 64, (n, 2, 32)).astype("int32")
    tt = rng.randint(0, 2, (n, 2, 32)).astype("int32")
    pos = onp.sort(rng.rand(n, 2, 32).argsort(-1)[..., :4], -1).astype(
        "int32")
    mlm = rng.randint(0, 64, (n, 2, 4)).astype("int32")
    nsp = rng.randint(0, 2, (n, 2)).astype("int32")

    def build():
        mt.random.seed(2)
        m = bert.BERTForPretraining(bert.BERTModel(**cfg), vocab_size=64)
        m.initialize(mt.init.Normal(0.02), ctx=CPU)
        return parallel.ParallelTrainStep(
            PretrainStep(m), bert.BERTPretrainingLoss(),
            optimizer.Adam(learning_rate=1e-3),
            parallel.make_mesh({"dp": 1}, ctx=CPU),
            extra_specs=("dp", "dp"), seed=2)

    def run(step, i):
        return step(toks[i], (mlm[i], nsp[i]), tt[i], pos[i])

    clean = build()
    for i in range(n):
        if i != 2:
            run(clean, i)
    step = build()
    guard = NumericsGuard(check_every_n=2, policy="skip")
    guard.attach(step)
    with faults.inject("nan_grad", at=(3,)):
        losses = [float(run(step, i)) for i in range(n)]
    guard.finalize()
    assert not math.isfinite(losses[2]) and guard.skipped_steps == 1
    assert guard.last_anomaly["kind"] == "nan_grad"
    assert _bitwise(_params(clean), _params(step))
