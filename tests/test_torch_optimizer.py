"""The port's optimizers, ``Updater`` and learning-rate schedulers against
the JAX package on the CPU.

Weights, gradients and noise are made with numpy from a seed and handed to
both packages. Tolerances:

- every optimizer, five updates through each package's ``Updater`` with
  the same lr/wd multipliers, ``rescale_grad`` and ``clip_gradient``:
  weights and states within rtol 1e-5, atol 1e-7. Both sides compute in
  f32 and hand the rule the update count as an f32 scalar; they differ in
  the order of a few operations. Where the reference cannot run a rule
  through its ``Updater`` (DCASGD's state shares the weight's buffer, which
  its donating update refuses; SGLD has no ``update_multi_precision``), its
  side starts from a copied state or calls ``update`` directly.
- ``multi_precision`` with a bf16 weight: the f32 masters as above, and
  each package's bf16 weight is its master rounded (exactly).
- schedulers: the same float arithmetic, so within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, optimizer

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SHAPE = (7, 9)
STEPS = 5
COMMON = dict(rescale_grad=0.5, clip_gradient=0.3, wd=0.01,
              param_idx2name={0: "w"})

# (name, constructor keywords): the fifteen rules
CASES = [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("nag", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01)),
    ("adamw", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("adagrad", dict(learning_rate=0.1)),
    ("adadelta", dict()),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.01)),
    ("ftml", dict(learning_rate=0.01)),
    ("lamb", dict(learning_rate=0.01)),
    ("lars", dict(learning_rate=0.1)),
    ("signum", dict(learning_rate=0.01)),
    ("sgld", dict(learning_rate=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
]
MULTI_PRECISION = [("sgd", dict(learning_rate=0.1, momentum=0.9)),
                   ("adam", dict(learning_rate=0.01)),
                   ("lamb", dict(learning_rate=0.01))]


def _ids(cases):
    return [f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items()
                           if k != 'learning_rate') or 'plain'}"
            for n, kw in cases]


def _data(seed=0, dtype=onp.float32):
    rng = onp.random.RandomState(seed)
    w = rng.randn(*SHAPE).astype(onp.float32)
    grads = [rng.randn(*SHAPE).astype(onp.float32) for _ in range(STEPS)]
    noise = [rng.randn(*SHAPE).astype(onp.float32) for _ in range(STEPS)]
    return w, grads, noise


def _flat(state):
    """The tensors of a state tree, in order."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat(s)]
    return [state]


def _multipliers(opt):
    opt.set_lr_mult({"w": 0.5})
    opt.set_wd_mult({"w": 2.0})
    return opt


def _run_jax(name, kw, w, grads, noise, monkeypatch, dtype=None):
    opt = _multipliers(mx.optimizer.create(name, **COMMON, **kw))
    upd = mx.optimizer.get_updater(opt)
    jdt = dtype and jnp.bfloat16
    weight = mx.nd.array(w)
    if jdt is not None:
        weight = weight.astype("bfloat16")
    draws = iter(noise)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(next(draws), dtype))
    if name == "dcasgd":
        # the reference's create_state shares the weight's buffer, which
        # its donating update then refuses: start from a copy
        upd.states[0] = (mx.nd.zeros(SHAPE), mx.nd.array(w))
    for g in grads:
        grad = mx.nd.array(g)
        if jdt is not None:
            grad = grad.astype("bfloat16")
        if name == "sgld":
            # the reference's SGLD overrides update() only; its Updater
            # path (update_multi_precision) reaches the missing _rule
            upd.states[0] = None
            opt.update(0, weight, grad, None)
        else:
            upd(0, grad, weight)
    return weight, upd.states[0]


def _run_port(name, kw, w, grads, noise, monkeypatch, dtype=None):
    opt = _multipliers(optimizer.create(name, **COMMON, **kw))
    upd = optimizer.get_updater(opt)
    draws = iter(noise)
    monkeypatch.setattr(optimizer.SGLD, "_noise",
                        lambda self, t: torch.from_numpy(next(draws)))
    weight = mt.nd.array(w, ctx=mt.cpu())
    if dtype is not None:
        weight = weight.astype(dtype)
    for g in grads:
        grad = mt.nd.array(g, ctx=mt.cpu())
        if dtype is not None:
            grad = grad.astype(dtype)
        upd(0, grad, weight)
    return weight, upd.states[0]


def _close(got, want):
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,kw", CASES, ids=_ids(CASES))
def test_five_updates_match_jax(name, kw, monkeypatch):
    w, grads, noise = _data()
    jw, jstate = _run_jax(name, kw, w, grads, noise, monkeypatch)
    tw, tstate = _run_port(name, kw, w, grads, noise, monkeypatch)
    assert not onp.allclose(tw.asnumpy(), w)          # it moved
    _close(tw.asnumpy(), jw.asnumpy())
    jflat = [onp.asarray(s.asnumpy() if hasattr(s, "asnumpy") else s)
             for s in _flat(jstate)]
    tflat = [s.float().numpy() for s in _flat(tstate)]
    assert len(jflat) == len(tflat)
    for a, b in zip(tflat, jflat):
        _close(a, b)


@pytest.mark.parametrize("name,kw", MULTI_PRECISION,
                         ids=_ids(MULTI_PRECISION))
def test_multi_precision_bf16_matches_jax(name, kw, monkeypatch):
    w, grads, noise = _data(1)
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()  # bf16-exact
    kw = dict(kw, multi_precision=True)
    jw, jstate = _run_jax(name, kw, w, grads, noise, monkeypatch,
                          dtype="bfloat16")
    tw, tstate = _run_port(name, kw, w, grads, noise, monkeypatch,
                           dtype="bfloat16")
    jmaster, tmaster = jstate[0].asnumpy(), tstate[0]
    assert tmaster.dtype == torch.float32 and tw.dtype == "bfloat16"
    _close(tmaster.numpy(), jmaster)
    assert torch.equal(tw.data, tmaster.to(torch.bfloat16))
    onp.testing.assert_array_equal(
        jw.asnumpy().astype(onp.float32),
        onp.asarray(jnp.asarray(jmaster).astype(jnp.bfloat16)
                    .astype(jnp.float32)))
    for a, b in zip(_flat(tstate[1]), _flat(jstate[1])):
        _close(a.float().numpy(), b.asnumpy())


def test_sgld_noise_comes_from_the_context_generator():
    w = mt.nd.zeros((200, 200), ctx=mt.cpu())
    g = mt.nd.zeros((200, 200), ctx=mt.cpu())
    draws = []
    for _ in range(2):
        mt.random.seed(11)
        upd = optimizer.get_updater(optimizer.SGLD(learning_rate=0.04))
        w = mt.nd.zeros((200, 200), ctx=mt.cpu())
        upd(0, g, w)
        draws.append(w.asnumpy())
    onp.testing.assert_array_equal(draws[0], draws[1])
    assert abs(draws[0].std() - 0.2) < 0.01 and abs(draws[0].mean()) < 0.01


def test_updater_states_round_trip():
    w, grads, _ = _data(2)
    opt = optimizer.Adam(learning_rate=0.01)
    upd = optimizer.get_updater(opt)
    weight = mt.nd.array(w, ctx=mt.cpu())
    upd(0, mt.nd.array(grads[0], ctx=mt.cpu()), weight)
    upd2 = optimizer.get_updater(optimizer.Adam(learning_rate=0.01))
    upd2.set_states(upd.get_states(dump_optimizer=True))
    for a, b in zip(_flat(upd.states[0]), _flat(upd2.states[0])):
        assert torch.equal(a, b)


def test_registry_and_hyper_parameters():
    opt = optimizer.create("Adam", learning_rate=0.5)
    assert isinstance(opt, optimizer.Adam) and opt.learning_rate == 0.5
    opt.set_learning_rate(0.25)
    assert opt.learning_rate == 0.25
    with pytest.raises(MXNetError, match="unknown entry"):
        optimizer.create("nosuch")
    sched = optimizer.FactorScheduler(step=2, factor=0.5)
    opt = optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    with pytest.raises(MXNetError, match="LRScheduler"):
        opt.set_learning_rate(0.1)


def test_adam_rule_stays_what_the_train_step_runs():
    """``Adam._rule`` is what ``ParallelTrainStep`` calls: the update
    through ``Updater`` (no rescale, no clip, no multipliers) is bitwise the
    rule applied to the same tensors, with the count as the f32 scalar the
    reference's ``update`` passes."""
    w, grads, _ = _data(3)
    a = torch.from_numpy(w.copy())
    opt = optimizer.Adam(learning_rate=0.01, wd=0.1)
    state = opt.create_state(0, a)
    for t, g in enumerate(grads, 1):
        opt._rule(a, torch.from_numpy(g), state, 0.01, 0.1, onp.float32(t))
    upd = optimizer.get_updater(optimizer.Adam(learning_rate=0.01, wd=0.1))
    b = mt.nd.array(w, ctx=mt.cpu())
    for g in grads:
        upd(0, mt.nd.array(g, ctx=mt.cpu()), b)
    assert torch.equal(a, b.data)


# ---------------------------------------------------------------------------
# learning-rate schedulers
# ---------------------------------------------------------------------------
SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=2, factor=0.9, base_lr=0.1,
                             warmup_steps=4, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[3, 7, 12], factor=0.3, base_lr=1.0)),
    ("MultiFactorScheduler", dict(step=[5], factor=0.1, base_lr=0.5,
                                  warmup_steps=3, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=20, base_lr=0.2, pwr=2,
                           final_lr=0.01)),
    ("PolyScheduler", dict(max_update=20, base_lr=0.2, pwr=1, warmup_steps=5,
                           warmup_begin_lr=0.0)),
    ("CosineScheduler", dict(max_update=20, base_lr=0.2, final_lr=0.002)),
    ("CosineScheduler", dict(max_update=20, base_lr=0.2, warmup_steps=6,
                             warmup_begin_lr=0.02)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(SCHEDULERS)])
def test_scheduler_matches_jax(name, kw):
    from mxnet_tpu.optimizer import lr_scheduler as jax_sched
    jax_s = getattr(jax_sched, name)(**kw)
    port_s = getattr(mt.lr_scheduler, name)(**kw)
    for n in range(0, 26):
        assert abs(port_s(n) - jax_s(n)) <= 1e-12, n


def test_scheduler_drives_the_optimizer_by_update_count():
    sched = mt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    upd = optimizer.get_updater(opt)
    w = mt.nd.zeros((3,), ctx=mt.cpu())
    g = mt.nd.ones((3,), ctx=mt.cpu())
    moved = []
    for _ in range(5):
        before = w.asnumpy().copy()
        upd(0, g, w)
        moved.append(float((before - w.asnumpy())[0]))
    onp.testing.assert_allclose(moved, [1.0, 1.0, 0.5, 0.5, 0.25])


def test_adam_on_a_bf16_weight_without_a_master():
    """Without ``multi_precision`` a bf16 weight keeps f32 moments and is
    updated in f32 and rounded (the reference misreads such a state as a
    master and raises)."""
    w, grads, _ = _data(4)
    opt = optimizer.Adam(learning_rate=0.01)
    upd = optimizer.get_updater(opt)
    weight = mt.nd.array(w, ctx=mt.cpu()).astype("bfloat16")
    ref = weight.data.float().clone()
    state = optimizer.Adam(learning_rate=0.01).create_state(0, ref)
    for t, g in enumerate(grads, 1):
        grad = mt.nd.array(g, ctx=mt.cpu()).astype("bfloat16")
        upd(0, grad, weight)
        opt2 = optimizer.Adam(learning_rate=0.01)
        opt2._rule(ref, grad.data.float(), state, 0.01, 0.0, onp.float32(t))
        ref = ref.to(torch.bfloat16).float()       # the weight's rounding
    m, v = upd.states[0]
    assert m.dtype == torch.float32 and weight.dtype == "bfloat16"
    assert torch.equal(weight.data.float(), ref)
