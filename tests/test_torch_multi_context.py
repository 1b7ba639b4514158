"""Parameters on several contexts, split_and_load and the Trainer's
allreduce (the reference's multi-device data parallelism in one process)
against the JAX package on four of its CPU devices.

In the reference ``cpu(0)``...``cpu(3)`` are four XLA devices; in the port
every ``cpu(i)`` is the host, so a Parameter keys its copies by the
``Context`` and a Block computes with the copies of its input's context.
Weights and batches are made with numpy from a seed. Tolerance 1e-5.
"""
import contextlib

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch import optimizer as opt_mod

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CTXS = [mt.cpu(i) for i in range(4)]
JCTXS = [mx.cpu(i) for i in range(4)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _forget_ledger_executors():
    """Drop the executors the reference's eager jit cache
    (``mxnet_tpu/ops/registry.py`` ``_JIT_CACHE``) instrumented while a
    compile ledger was on. Such an executor (``compile_ledger.
    instrument_eager_jit``) AOT-compiles per (shape, dtype) with no device
    in its key, and the cache keeps it after the ledger is turned off: a
    Dense forward on ``cpu(0)`` compiles it for device 0, and the same
    layer on ``cpu(1)`` is refused ("Computation was compiled for input
    shardings that disagree", F8). ``tests/test_hlolint.py`` leaves such an
    executor for FullyConnected(num_hidden=16) whenever it runs earlier in
    the same xdist worker. The next dispatch makes a plain ``jax.jit``."""
    from mxnet_tpu.ops import registry as jreg
    with jreg._JIT_LOCK:
        for key in [k for k, fn in jreg._JIT_CACHE.items()
                    if getattr(fn, "_ledger_instrumented", False)]:
            del jreg._JIT_CACHE[key]


@contextlib.contextmanager
def _process_state_scope():
    """The process-wide state these comparisons read, set for a test and
    restored after it: the files an xdist worker runs share one process,
    and under ``--dist loadfile`` any of them may have run before this
    one. PyTorch's intra-op thread count (a change rebuilds the pool,
    whose fresh threads are primed as at import), gradient mode, default
    dtype, denormal flushing and deterministic-algorithm flag; AMP off in
    both packages (the reference's cast policy also rides a thread-local
    stack); the reference's f32 matmul precision and x64 flag; the
    reference's compile ledger off and its eager jit cache free of the
    executors a ledger instrumented (F8)."""
    import jax
    from mxnet_tpu import amp as jamp
    from mxnet_tpu import config as jcfg
    saved = (torch.get_num_threads(), torch.is_grad_enabled(),
             torch.get_default_dtype(),
             torch.are_deterministic_algorithms_enabled(),
             jax.config.jax_default_matmul_precision,
             jax.config.jax_enable_x64, mt.amp._AMP_STATE["on"],
             jamp._AMP_STATE["on"], getattr(jamp._CFG_TLS, "stack", None),
             jcfg.get("MXNET_COMPILE_LEDGER_DIR"),
             jcfg.get("MXNET_COMPILE_LEDGER_EAGER"))
    if saved[0] != 2:
        torch.set_num_threads(2)
        torch.exp(torch.zeros(1 << 18))
    torch.set_grad_enabled(True)
    torch.set_default_dtype(torch.float32)
    torch.set_flush_denormal(False)
    torch.use_deterministic_algorithms(False)
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.config.update("jax_enable_x64", False)
    mt.amp._AMP_STATE["on"] = jamp._AMP_STATE["on"] = False
    jamp._CFG_TLS.stack = []
    jcfg.set("MXNET_COMPILE_LEDGER_DIR", "")
    jcfg.set("MXNET_COMPILE_LEDGER_EAGER", "auto")
    _forget_ledger_executors()
    try:
        yield
    finally:
        if saved[0] != 2:
            torch.set_num_threads(saved[0])
        torch.set_grad_enabled(saved[1])
        torch.set_default_dtype(saved[2])
        torch.use_deterministic_algorithms(saved[3])
        jax.config.update("jax_default_matmul_precision", saved[4])
        jax.config.update("jax_enable_x64", saved[5])
        mt.amp._AMP_STATE["on"], jamp._AMP_STATE["on"] = saved[6:8]
        jamp._CFG_TLS.stack = saved[8] if saved[8] is not None else []
        jcfg.set("MXNET_COMPILE_LEDGER_DIR", saved[9])
        jcfg.set("MXNET_COMPILE_LEDGER_EAGER", saved[10])


@pytest.fixture(autouse=True)
def _process_state():
    with _process_state_scope():
        yield


def test_parameter_on_four_contexts():
    p = gluon.Parameter("w", shape=(3, 2))
    p.initialize(init=mt.init.Constant(0.5), ctx=CTXS)
    assert p.list_ctx() == CTXS
    assert [d.context for d in p.list_data()] == CTXS
    assert [g.context for g in p.list_grad()] == CTXS
    assert len({id(d._data) for d in p.list_data()}) == 4
    assert p.data(mt.cpu(2)) is p.list_data()[2]
    assert p.grad(mt.cpu(3)) is p.list_grad()[3]
    p.set_data(nd.array(onp.arange(6.0).reshape(3, 2)))
    for d in p.list_data():
        onp.testing.assert_array_equal(d.asnumpy(),
                                       onp.arange(6.0).reshape(3, 2))
    for g in p.list_grad():
        g._set_data(torch.ones(3, 2))
    p.zero_grad()
    assert all((g.asnumpy() == 0).all() for g in p.list_grad())
    with pytest.raises(MXNetError, match="not initialized on"):
        p.data(mt.cpu(5))
    p.reset_ctx(CTXS[:2])
    assert p.list_ctx() == CTXS[:2]
    onp.testing.assert_array_equal(p.data(mt.cpu(1)).asnumpy(),
                                   onp.arange(6.0).reshape(3, 2))


def test_split_and_load_matches_reference():
    x = onp.arange(24.0, dtype="float32").reshape(8, 3)
    port = gluon.utils.split_and_load(nd.array(x, ctx=mt.cpu()), CTXS)
    ref = mx.gluon.utils.split_and_load(mx.nd.array(x), JCTXS)
    assert [a.context for a in port] == CTXS
    for a, b in zip(port, ref):
        onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    with pytest.raises(MXNetError, match="evenly"):
        gluon.utils.split_and_load(nd.array(x[:7], ctx=mt.cpu()), CTXS)


def _weights():
    rng = onp.random.RandomState(0)
    return [(0.3 * rng.randn(*s)).astype("float32") for s in
            ((16, 8), (16,), (16,), (16,), (16,), (16,), (4, 16), (4,))]


def _data():
    rng = onp.random.RandomState(1)
    return [(rng.randn(16, 8).astype("float32"),
             rng.randint(0, 4, 16).astype("float32")) for _ in range(3)]


def _train(pkg, ctxs, weights, data):
    """Three steps of the Gluon loop over ``ctxs``: split, a forward and
    backward per context, Trainer.step(batch) with kvstore="device"."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8), nn.BatchNorm(in_channels=16),
            nn.Activation("relu"), nn.Dense(4, in_units=16))
    net.initialize(ctx=ctxs)
    params = list(net.collect_params().values())
    for p, w in zip(params, weights):
        w = w if not p.name.endswith("running_var") else abs(w) + 1
        p.set_data(pkg.nd.array(w))
    # plain SGD: the reference's momentum state, made on the first
    # context, cannot update the other contexts' copies (ROADMAP Queue 3)
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore="device")
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in data:
        xs = pkg.gluon.utils.split_and_load(pkg.nd.array(x), ctxs)
        ys = pkg.gluon.utils.split_and_load(pkg.nd.array(y), ctxs)
        with pkg.autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        pkg.autograd.backward(losses)
        trainer.step(x.shape[0])
    return [[d.asnumpy() for d in p.list_data()] for p in params]


def test_trainer_over_four_contexts_matches_reference():
    """A Dense-BatchNorm-Dense net trained three steps over four contexts
    with Trainer(kvstore="device") (each step pushpulls every gradient,
    then updates every copy): every copy of every parameter, BatchNorm's
    per-context moving statistics included, against the reference."""
    weights, data = _weights(), _data()
    port = _train(mt, CTXS, weights, data)
    ref = _train(mx, JCTXS, weights, data)
    for i, (ps, rs) in enumerate(zip(port, ref)):
        assert len(ps) == len(rs) == 4
        for c, (a, b) in enumerate(zip(ps, rs)):
            onp.testing.assert_allclose(a, b, **TOL,
                                        err_msg=f"param {i} ctx {c}")


def _reference_ledger_step(tmp_path):
    """What ``tests/test_hlolint.py`` does before its serving check, in a
    worker whose eager jit cache holds no Dense executor yet (as when it
    runs first): the reference's compile ledger on, a Dense(16) net's
    eager forward (its FullyConnected executor instrumented and cached),
    the ledger off."""
    from mxnet_tpu import config as jcfg
    from mxnet_tpu.ops import registry as jreg
    with jreg._JIT_LOCK:
        jreg._JIT_CACHE.clear()
    jcfg.set("MXNET_COMPILE_LEDGER_DIR", str(tmp_path / "ledger"))
    try:
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16, activation="relu"),
                    mx.gluon.nn.Dense(4))
        net.initialize()
        net(mx.nd.array(onp.zeros((2, 8), "float32")))
    finally:
        jcfg.set("MXNET_COMPILE_LEDGER_DIR", "")


def test_f8_trainer_over_four_contexts_after_the_reference_ledger(tmp_path):
    """F8: the four-context comparison after another file ran the
    reference's compile ledger in the same process (pytest-xdist's
    workers share one process across files). Without dropping the
    executors the ledger instrumented, the reference's first Dense on
    ``cpu(1)`` raises ("compiled for input shardings that disagree")."""
    _reference_ledger_step(tmp_path)
    from mxnet_tpu.ops import registry as jreg
    assert any(getattr(fn, "_ledger_instrumented", False)
               for fn in jreg._JIT_CACHE.values())
    with _process_state_scope():
        weights, data = _weights(), _data()
        port = _train(mt, CTXS, weights, data)
        ref = _train(mx, JCTXS, weights, data)
    for i, (ps, rs) in enumerate(zip(port, ref)):
        for c, (a, b) in enumerate(zip(ps, rs)):
            onp.testing.assert_allclose(a, b, **TOL,
                                        err_msg=f"param {i} ctx {c}")


def test_one_context_step_is_the_local_loop():
    """One context and one worker: Trainer.step is the updater applied to
    each parameter (no kvstore traffic), bitwise."""
    weights, data = _weights(), _data()
    x, y = data[0]
    got = _train(mt, [mt.cpu()], weights, [data[0]])
    nn = gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8), nn.BatchNorm(in_channels=16),
            nn.Activation("relu"), nn.Dense(4, in_units=16))
    net.initialize()
    params = list(net.collect_params().values())
    for p, w in zip(params, weights):
        p.set_data(nd.array(w if not p.name.endswith("running_var")
                            else abs(w) + 1))
    opt = opt_mod.create("sgd", learning_rate=0.1,
                         param_dict=dict(enumerate(params)))
    opt.rescale_grad = 1.0 / x.shape[0]
    upd = opt_mod.get_updater(opt)
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            net(nd.array(x)), nd.array(y))
    loss.backward()
    for i, p in enumerate(params):
        if p.grad_req != "null":
            upd(i, p.grad(), p.data())
    for a, p in zip(got, params):
        onp.testing.assert_array_equal(a[0], p.data().asnumpy())


def _mlp_train(ctxs, optimizer, opt_params, steps=3, **trainer_kw):
    """``steps`` Trainer steps of a Dense-ReLU-Dense net over ``ctxs``
    (the batch of 16 split evenly); the net and the Trainer."""
    rng = onp.random.RandomState(2)
    w = [(0.3 * rng.randn(*s)).astype("float32")
         for s in ((16, 8), (16,), (4, 16), (4,))]
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, in_units=8), gluon.nn.Activation("relu"),
            gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=ctxs)
    for p, a in zip(net.collect_params().values(), w):
        p.set_data(nd.array(a))
    trainer = gluon.Trainer(net.collect_params(), optimizer, opt_params,
                            kvstore="device", **trainer_kw)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in _data()[:steps]:
        xs = gluon.utils.split_and_load(nd.array(x), ctxs)
        ys = gluon.utils.split_and_load(nd.array(y), ctxs)
        with autograd.record():
            losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
        autograd.backward(losses)
        trainer.step(x.shape[0])
    return net, trainer


STATEFUL = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
            ("adam", {"learning_rate": 0.01}),
            ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                     "lr_scheduler": mt.lr_scheduler.FactorScheduler(
                         step=1, factor=0.5)})]


@pytest.mark.parametrize("optimizer, opt_params", STATEFUL,
                         ids=["momentum", "adam", "lr_schedule"])
def test_stateful_optimizer_over_four_contexts(optimizer, opt_params):
    """With momentum, Adam or an lr schedule each context's copy steps
    through its own updater: the four copies stay bitwise equal, the step
    count is the number of steps, and the net equals the one-context run
    on the whole batch (the gradient summed over contexts) at 1e-5."""
    net, trainer = _mlp_train(CTXS, optimizer, dict(opt_params))
    assert trainer.optimizer.num_update == 3
    for p in net.collect_params().values():
        first = p.list_data()[0].asnumpy()
        for c, d in enumerate(p.list_data()[1:], 1):
            onp.testing.assert_array_equal(d.asnumpy(), first,
                                           err_msg=f"{p.name} ctx {c}")
    if "lr_scheduler" in opt_params:    # a scheduler keeps its own count
        opt_params = dict(opt_params, lr_scheduler=mt.lr_scheduler
                          .FactorScheduler(step=1, factor=0.5))
    one, _ = _mlp_train([mt.cpu()], optimizer, dict(opt_params))
    for p, q in zip(net.collect_params().values(),
                    one.collect_params().values()):
        onp.testing.assert_allclose(p.data().asnumpy(), q.data().asnumpy(),
                                    **TOL, err_msg=p.name)


def test_update_on_kvstore_over_four_contexts():
    """update_on_kvstore over four contexts: the store sums the contexts'
    gradients once and updates its weight, pulled into every copy; equal
    to the local update of every copy after the pushpull."""
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    local, _ = _mlp_train(CTXS, "sgd", dict(opt))
    store, trainer = _mlp_train(CTXS, "sgd", dict(opt),
                                update_on_kvstore=True)
    assert trainer._update_on_kvstore
    for p, q in zip(store.collect_params().values(),
                    local.collect_params().values()):
        for a, b in zip(p.list_data(), q.list_data()):
            onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                        atol=1e-7, err_msg=p.name)
    with pytest.raises(MXNetError, match="update_on_kvstore"):
        trainer.allreduce_grads()


def test_trainer_state_over_four_contexts():
    """A state_dict taken after two steps over four contexts and loaded
    into a fresh Trainer: its third step equals the uninterrupted run's,
    bitwise, on every copy (each context's updater restarts from the
    loaded states)."""
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    whole, _ = _mlp_train(CTXS, "sgd", dict(opt))
    net, trainer = _mlp_train(CTXS, "sgd", dict(opt), steps=2)
    state = trainer.state_dict()
    resumed = gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                            kvstore="device")
    resumed.load_state_dict(state)
    x, y = _data()[2]
    xs = gluon.utils.split_and_load(nd.array(x), CTXS)
    ys = gluon.utils.split_and_load(nd.array(y), CTXS)
    with autograd.record():
        losses = [gluon.loss.SoftmaxCrossEntropyLoss()(net(a), b)
                  for a, b in zip(xs, ys)]
    autograd.backward(losses)
    resumed.step(x.shape[0])
    for p, q in zip(net.collect_params().values(),
                    whole.collect_params().values()):
        for a, b in zip(p.list_data(), q.list_data()):
            onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy(),
                                           err_msg=p.name)
