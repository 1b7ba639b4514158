"""The port's training slice (mxnet_tpu_torch.parallel.ParallelTrainStep over
BERTForPretraining with Adam) against the JAX package on the CPU, at a small
size, and the pieces it is built from.

Weights and batches are made with numpy from a seed and handed to both
packages; dropout is 0 wherever the two are compared (their random streams
differ). Tolerances:

- f32 losses within 1e-5 relative and parameters within 0.05 lr after three
  Adam steps: both sides are true fp32 and differ only in the order of sums
  (measured: 2.4e-7 and 0.006 lr).
- bf16 compute over f32 masters: losses within 2e-3 relative; parameters
  within 0.1 lr on average and 0.5 lr at the 99th percentile. One Adam step
  moves a weight by about lr in the direction of its gradient's sign, and
  bf16 rounding flips the sign of near-zero gradients, so a maximum over all
  weights says nothing (measured: 4.5e-4, mean 0.02 lr, p99 0.11 lr).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch
from jax.sharding import PartitionSpec as PS

import mxnet_tpu as mx
from mxnet_tpu import parallel as jax_parallel
from mxnet_tpu.gluon.block import HybridBlock
from mxnet_tpu.gluon.model_zoo import bert as jax_bert
from mxnet_tpu.ops.registry import get_op

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, optimizer, parallel
from mxnet_tpu_torch.gluon.model_zoo import bert
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.tools import PretrainStep

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=2,
             vocab_size=128, max_length=64, dropout=0.0)
B, S, P, K = 4, 64, 9, 3
LR, WD = 1e-3, 0.01


class _JaxPretrainStep(HybridBlock):
    """bench.py's wrapper: (tokens, token_types, positions) -> heads."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, tokens, token_types, positions):
        return self.inner(tokens, token_types, None, positions)


def _jax_model(named):
    m = jax_bert.BERTForPretraining(jax_bert.BERTModel(**SMALL),
                                    vocab_size=SMALL["vocab_size"])
    m.initialize()
    tok = mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32")
    m(tok, tok)                        # materialize deferred shapes
    for name, p in m._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(named[name]))
    return m


def _port_model(named, dropout=0.0):
    m = bert.BERTForPretraining(bert.BERTModel(**{**SMALL,
                                                  "dropout": dropout}),
                                vocab_size=SMALL["vocab_size"])
    bert.load_jax_params(m, named, ctx=mt.cpu())
    return m


@pytest.fixture(scope="module")
def named():
    """Seeded weights under the JAX package's parameter names."""
    m = jax_bert.BERTForPretraining(jax_bert.BERTModel(**SMALL),
                                    vocab_size=SMALL["vocab_size"])
    m.initialize()
    tok = mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32")
    m(tok, tok)
    rng = onp.random.RandomState(0)
    out = {}
    for name, p in m._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        if name.endswith("gamma"):
            a += 1.0
        out[name] = a
    return out


@pytest.fixture(scope="module")
def batches():
    """K stacked batches: tokens, token types, P sorted masked positions,
    MLM labels (one -1) and NSP labels."""
    rng = onp.random.RandomState(1)
    toks = rng.randint(0, SMALL["vocab_size"], (K, B, S)).astype("int32")
    tt = rng.randint(0, 2, (K, B, S)).astype("int32")
    pos = onp.sort(rng.rand(K, B, S).argsort(-1)[..., :P], -1).astype("int32")
    mlm = rng.randint(0, SMALL["vocab_size"], (K, B, P)).astype("int32")
    mlm[:, 0, 0] = -1
    nsp = rng.randint(0, 2, (K, B)).astype("int32")
    return toks, tt, pos, mlm, nsp


def _jax_train(named, batches, compute_dtype=None, use_step_n=False):
    toks, tt, pos, mlm, nsp = batches
    model = _jax_model(named)
    mesh = jax_parallel.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jax_parallel.ParallelTrainStep(
        _JaxPretrainStep(model), jax_bert.BERTPretrainingLoss(),
        mx.optimizer.Adam(learning_rate=LR, wd=WD), mesh,
        compute_dtype=compute_dtype, extra_specs=(PS("dp"), PS("dp")))
    if use_step_n:
        losses = list(step.step_n(toks, (mlm, nsp), tt, pos).asnumpy())
    else:
        losses = [float(step(toks[i], (mlm[i], nsp[i]), tt[i],
                             pos[i]).asscalar()) for i in range(K)]
    step.sync_to_block()
    return onp.asarray(losses), {k: p.data().asnumpy() for k, p in
                                 model._collect_params_with_prefix().items()}


def _port_train(named, batches, compute_dtype=None, use_step_n=False,
                dropout=0.0):
    toks, tt, pos, mlm, nsp = batches
    step = parallel.ParallelTrainStep(
        PretrainStep(_port_model(named, dropout)),
        bert.BERTPretrainingLoss(),
        optimizer.Adam(learning_rate=LR, wd=WD),
        parallel.make_mesh({"dp": 1}, ctx=mt.cpu()),
        compute_dtype=compute_dtype, extra_specs=("dp", "dp"), seed=7)
    if use_step_n:
        losses = step.step_n(toks, (mlm, nsp), tt, pos)
    else:
        losses = torch.stack([step(toks[i], (mlm[i], nsp[i]), tt[i], pos[i])
                              for i in range(K)])
    params = {k[len("inner."):]: v.detach().clone()
              for k, v in step.params.items()}
    return losses, params


@pytest.fixture(scope="module")
def jax_f32(named, batches):
    return _jax_train(named, batches)


@pytest.fixture(scope="module")
def port_f32(named, batches):
    return _port_train(named, batches)


def test_pretraining_steps_match_jax_f32(named, jax_f32, port_f32):
    j_losses, j_params = jax_f32
    t_losses, t_params = port_f32
    assert t_losses.dtype == torch.float32 and t_losses.shape == (K,)
    onp.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=1e-5,
                                atol=0)
    assert set(t_params) == set(j_params) == set(named)
    for k in j_params:
        assert t_params[k].dtype == torch.float32, k
        onp.testing.assert_allclose(t_params[k].numpy(), j_params[k], rtol=0,
                                    atol=0.05 * LR, err_msg=k)
    # the steps moved every parameter
    assert all(not onp.array_equal(j_params[k], named[k]) for k in named)


def test_port_step_n_equals_steps(named, batches, port_f32):
    t_losses, t_params = port_f32
    n_losses, n_params = _port_train(named, batches, use_step_n=True)
    assert torch.equal(n_losses, t_losses)
    for k in t_params:
        assert torch.equal(n_params[k], t_params[k]), k


def test_port_step_n_equals_steps_with_dropout(named, batches):
    """One generator feeds every Dropout in the same order either way."""
    a_losses, a_params = _port_train(named, batches, dropout=0.1)
    b_losses, b_params = _port_train(named, batches, dropout=0.1,
                                     use_step_n=True)
    assert torch.equal(a_losses, b_losses)
    for k in a_params:
        assert torch.equal(a_params[k], b_params[k]), k
    no_drop, _ = _port_train(named, batches)
    assert not torch.equal(a_losses, no_drop)     # dropout did run


def test_jax_step_n_equals_steps(named, batches, jax_f32):
    j_losses, j_params = jax_f32
    n_losses, n_params = _jax_train(named, batches, use_step_n=True)
    onp.testing.assert_allclose(n_losses, j_losses, rtol=1e-5, atol=0)
    for k in j_params:
        onp.testing.assert_allclose(n_params[k], j_params[k], rtol=0,
                                    atol=0.05 * LR, err_msg=k)


def test_pretraining_steps_bf16_within_band(named, batches):
    j_losses, j_params = _jax_train(named, batches, compute_dtype="bfloat16")
    t_losses, t_params = _port_train(named, batches,
                                     compute_dtype="bfloat16")
    onp.testing.assert_allclose(t_losses.numpy(), j_losses, rtol=2e-3,
                                atol=0)
    keys = sorted(j_params)
    for k in keys:                      # f32 masters under bf16 compute
        assert t_params[k].dtype == torch.float32, k
    diff = onp.abs(onp.concatenate([t_params[k].numpy().ravel()
                                    for k in keys])
                   - onp.concatenate([j_params[k].ravel() for k in keys]))
    assert diff.mean() <= 0.1 * LR, diff.mean() / LR
    assert onp.percentile(diff, 99) <= 0.5 * LR, \
        onp.percentile(diff, 99) / LR


def test_train_step_adam_equals_the_trainer_bitwise_in_bf16(named, batches):
    """ParallelTrainStep hands Adam its update count as an f32 scalar, as
    the reference's step and the port's Trainer do (ROADMAP F3: with the
    int count the bias correction rounds in f64, and three bf16 steps
    drift lr apart). Three bf16 steps through ParallelTrainStep
    (compute_dtype) and through gluon.Trainer (a bf16 net with
    multi_precision), from the same bf16-exact weights and batches, give
    bitwise-equal f32 masters."""
    from mxnet_tpu_torch import autograd, gluon
    toks, tt, pos, mlm, nsp = batches
    exact = {k: torch.from_numpy(v).bfloat16().float().numpy()
             for k, v in named.items()}
    step = parallel.ParallelTrainStep(
        PretrainStep(_port_model(exact)), bert.BERTPretrainingLoss(),
        optimizer.Adam(learning_rate=LR, wd=WD),
        parallel.make_mesh({"dp": 1}, ctx=mt.cpu()),
        compute_dtype="bfloat16", extra_specs=("dp", "dp"))
    p_losses = [step(toks[i], (mlm[i], nsp[i]), tt[i], pos[i]).item()
                for i in range(K)]
    p_masters = {k[len("inner."):]: v for k, v in step.params.items()}

    net = _port_model(exact)
    net.cast("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": LR, "wd": WD,
                             "multi_precision": True})
    loss_fn = bert.BERTPretrainingLoss()
    g_losses = []
    for i in range(K):
        a = [mt.nd.array(v[i], ctx=mt.cpu(), dtype="int32")
             for v in (toks, tt, pos, mlm, nsp)]
        with autograd.record():
            loss = loss_fn(*net(a[0], a[1], None, a[2]), a[3], a[4])
        loss.backward()
        trainer.step(1)
        g_losses.append(float(loss.asscalar()))
    keys = {id(p): k for k, p in net._collect_params_with_prefix().items()}
    g_masters = {keys[id(p)]: trainer._updaters.states[i][0]
                 for i, p in enumerate(trainer._params)}
    assert g_losses == p_losses
    assert set(g_masters) == set(p_masters) == set(named)
    for k, v in p_masters.items():
        assert g_masters[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(g_masters[k], v), k
    assert all(not torch.equal(v, torch.from_numpy(exact[k]))
               for k, v in p_masters.items())


def test_pretraining_forward_and_loss_match_jax(named, batches):
    toks, tt, pos, mlm, nsp = (a[0] for a in batches)
    jm = _jax_model(named)
    j_mlm, j_nsp = jm(mx.nd.array(toks, dtype="int32"),
                      mx.nd.array(tt, dtype="int32"), None,
                      mx.nd.array(pos, dtype="int32"))
    j_loss = jax_bert.BERTPretrainingLoss()(
        j_mlm, j_nsp, mx.nd.array(mlm, dtype="int32"),
        mx.nd.array(nsp, dtype="int32"))
    tm = _port_model(named).eval()
    with torch.no_grad():
        t_mlm, t_nsp = tm(torch.from_numpy(toks), torch.from_numpy(tt), None,
                          torch.from_numpy(pos))
        t_loss = bert.BERTPretrainingLoss()(t_mlm, t_nsp,
                                            torch.from_numpy(mlm),
                                            torch.from_numpy(nsp))
    assert tuple(t_mlm.shape) == (B, P, SMALL["vocab_size"])
    assert tuple(t_nsp.shape) == (B, 2)
    onp.testing.assert_allclose(t_mlm.numpy(), j_mlm.asnumpy(), rtol=0,
                                atol=1e-4)
    onp.testing.assert_allclose(t_nsp.numpy(), j_nsp.asnumpy(), rtol=0,
                                atol=1e-4)
    onp.testing.assert_allclose(float(t_loss), float(j_loss.asscalar()),
                                rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretraining_loss_matches_jax(dtype):
    rng = onp.random.RandomState(2)
    mlm_logits = (3 * rng.randn(3, 5, 40)).astype(onp.float32)
    nsp_logits = rng.randn(3, 2).astype(onp.float32)
    labels = rng.randint(0, 40, (3, 5)).astype(onp.int32)
    labels[0, :] = -1
    labels[2, 3] = -1
    nsp = rng.randint(0, 2, (3,)).astype(onp.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_bert.BERTPretrainingLoss()(
        mx.nd.array(jnp.asarray(mlm_logits, dtype=jdt)),
        mx.nd.array(jnp.asarray(nsp_logits, dtype=jdt)),
        mx.nd.array(labels, dtype="int32"), mx.nd.array(nsp, dtype="int32"))
    tdt = getattr(torch, dtype)
    got = bert.BERTPretrainingLoss()(
        torch.from_numpy(mlm_logits).to(tdt),
        torch.from_numpy(nsp_logits).to(tdt), torch.from_numpy(labels),
        torch.from_numpy(nsp))
    assert got.dtype == torch.float32
    onp.testing.assert_allclose(float(got), float(want.asnumpy()),
                                rtol=1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log_softmax_pick_gelu_match_jax(dtype):
    rng = onp.random.RandomState(3)
    x = (4 * rng.randn(6, 33)).astype(onp.float32)
    idx = rng.randint(0, 33, (6,)).astype(onp.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, tx = jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)
    tol = 1e-6 if dtype == "float32" else 0.0
    for name, j, t in (
            ("log_softmax", get_op("log_softmax").fn(jx, axis=-1),
             ops.log_softmax(tx, axis=-1)),
            ("gelu", get_op("gelu").fn(jx), ops.gelu(tx)),
            ("pick", get_op("pick").fn(jx, jnp.asarray(idx), axis=-1),
             ops.pick(tx, torch.from_numpy(idx), axis=-1))):
        assert t.dtype == tdt, name
        # bf16: one rounding of the same f32 value (gelu: to within an ulp)
        atol = tol if name != "gelu" or dtype == "float32" else 3e-2
        onp.testing.assert_allclose(t.float().numpy(),
                                    onp.asarray(j.astype(jnp.float32)),
                                    rtol=1e-6 if dtype == "float32" else 0,
                                    atol=atol, err_msg=name)


@pytest.mark.parametrize("bf16_moments", [False, True])
@pytest.mark.parametrize("t", [1, 5])
def test_adam_rule_matches_jax(t, bf16_moments, monkeypatch):
    monkeypatch.setenv("MXNET_OPT_BF16_MOMENTS", "1" if bf16_moments else "0")
    rng = onp.random.RandomState(4)
    w, g = (rng.randn(7, 9).astype(onp.float32) for _ in range(2))
    m0 = 0.1 * rng.randn(7, 9).astype(onp.float32)
    v0 = onp.abs(0.1 * rng.randn(7, 9)).astype(onp.float32)
    jopt = mx.optimizer.Adam(learning_rate=0.01, wd=0.1)
    mdt = jnp.bfloat16 if bf16_moments else jnp.float32
    jw, (jm, jv) = jopt._rule(jnp.asarray(w), jnp.asarray(g),
                              (jnp.asarray(m0, mdt), jnp.asarray(v0, mdt)),
                              jnp.float32(0.01), jnp.float32(0.1),
                              jnp.float32(t))
    topt = optimizer.Adam(learning_rate=0.01, wd=0.1)
    tw = torch.from_numpy(w.copy())
    m, v = topt.create_state(0, tw)
    assert m.dtype == (torch.bfloat16 if bf16_moments else torch.float32)
    m.copy_(torch.from_numpy(m0))
    v.copy_(torch.from_numpy(v0))
    topt._rule(tw, torch.from_numpy(g), (m, v), 0.01, 0.1, t)
    onp.testing.assert_allclose(tw.numpy(), onp.asarray(jw), rtol=1e-6,
                                atol=1e-7)
    for a, b in ((m, jm), (v, jv)):
        onp.testing.assert_allclose(a.float().numpy(),
                                    onp.asarray(b.astype(jnp.float32)),
                                    rtol=1e-6, atol=1e-7)


def test_lr_schedule_and_multipliers_reach_every_step():
    """The optimizer's hooks as the reference wires them: the scheduler
    sees the step count (so step_n(K) == K steps), and a per-name lr_mult
    of 0 freezes that parameter (wd 0)."""
    def schedule(n):
        return 0.1 * 0.5 ** (n // 2)

    def run(use_step_n):
        torch.manual_seed(0)
        block = torch.nn.Linear(4, 3)
        opt = optimizer.Adam(learning_rate=0.1, lr_scheduler=schedule,
                             param_idx2name={0: "weight", 1: "bias"})
        opt.lr_mult = {"bias": 0.0}
        bias0 = block.bias.detach().clone()
        step = parallel.ParallelTrainStep(
            block, lambda out, y: (out - y).square(), opt,
            parallel.make_mesh({"dp": 1}, ctx=mt.cpu()))
        rng = onp.random.RandomState(6)          # one batch, five times
        xs = onp.repeat(rng.randn(1, 8, 4).astype(onp.float32), 5, axis=0)
        ys = onp.repeat(rng.randn(1, 8, 3).astype(onp.float32), 5, axis=0)
        if use_step_n:
            losses = step.step_n(xs, ys)
        else:
            losses = torch.stack([step(xs[i], ys[i]) for i in range(5)])
        assert opt.num_update == 5
        assert torch.equal(block.bias.detach(), bias0)
        return losses, block.weight.detach().clone()

    (a_loss, a_w), (b_loss, b_w) = run(False), run(True)
    assert torch.equal(a_loss, b_loss) and torch.equal(a_w, b_w)
    assert a_loss[-1] < a_loss[0]


def test_dropout_draws_from_its_generator_only():
    x = torch.ones(64, 64)
    d = Dropout(0.25)
    with pytest.raises(MXNetError, match="Generator"):
        d(x)                               # training mode, no generator
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(Dropout(0.0)(x), x)
    d.train()
    state = torch.random.get_rng_state()
    d.generator = torch.Generator().manual_seed(3)
    a = d(x)
    d.generator = torch.Generator().manual_seed(3)
    b = d(x)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.6 < kept.float().mean() < 0.9
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))


def test_train_step_gives_its_generator_to_every_dropout(named):
    step = parallel.ParallelTrainStep(
        PretrainStep(_port_model(named, dropout=0.1)),
        bert.BERTPretrainingLoss(), optimizer.Adam(),
        parallel.make_mesh({"dp": 1}, ctx=mt.cpu()),
        extra_specs=("dp", "dp"))
    drops = [m for m in step._block.modules() if isinstance(m, Dropout)]
    assert len(drops) == 1 + 2 * SMALL["num_layers"]
    assert all(d.generator is step.generator for d in drops)


def test_train_step_needs_one_extra_per_spec(named, batches):
    toks, tt, pos, mlm, nsp = (a[0] for a in batches)
    step = parallel.ParallelTrainStep(
        PretrainStep(_port_model(named)), bert.BERTPretrainingLoss(),
        optimizer.Adam(), parallel.make_mesh({"dp": 1}, ctx=mt.cpu()),
        extra_specs=("dp",))
    with pytest.raises(MXNetError, match="extra"):
        step(toks, (mlm, nsp), tt, pos)


def test_train_step_on_cpu_launches_no_kernel(named, batches):
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    _port_train(named, tuple(a[:1] for a in batches), use_step_n=True)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before


def test_entry_point_defaults_to_the_card():
    """Without ctx=cpu() the step is placed on gpu(0): on a host without
    CUDA that raises instead of running on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        parallel.ParallelTrainStep(
            bert.BERTForPretraining(bert.BERTModel(**SMALL), 128),
            bert.BERTPretrainingLoss(), optimizer.Adam(),
            parallel.make_mesh({"dp": 1}))


@pytest.mark.parametrize("axes", [{"dp": 2}, {"dp": 1, "tp": 4}])
def test_multi_device_mesh_is_refused(axes):
    """In a one-rank job a mesh of several ranks raises: there is no one
    to hold the other positions."""
    with pytest.raises(MXNetError, match="ranks, the job has 1"):
        parallel.make_mesh(axes, ctx=mt.cpu())


def test_weight_carrier_round_trips_pretraining_params(named):
    model = bert.BERTForPretraining(bert.BERTModel(**SMALL), 128)
    assert set(model._collect_params_with_prefix()) == set(named)
    assert {"backbone.word_embed.weight", "mlm_transform.weight",
            "mlm_ln.gamma", "nsp.bias"} <= set(named)
    sd = bert.params_from_jax(named)
    model.load_state_dict(sd)
    assert set(model.state_dict()) == set(named)
    for k, v in model.state_dict().items():
        assert torch.equal(v, torch.from_numpy(named[k])), k


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "backbone"])
def test_weight_carrier_refuses_pretraining_mismatch(named, fault):
    bad = dict(named)
    if fault == "missing":
        del bad["mlm_ln.beta"]
    elif fault == "extra":
        bad["mlm_decoder.bias"] = onp.zeros((128,), onp.float32)
    elif fault == "shape":
        bad["nsp.weight"] = onp.zeros((3, 64), onp.float32)
    else:                                  # a bare BERTModel's names
        bad = {k[len("backbone."):]: v for k, v in named.items()
               if k.startswith("backbone.")}
    if fault != "backbone":            # a bare BERTModel set is valid here
        with pytest.raises(MXNetError, match=fault):
            bert.params_from_jax(bad)
    model = bert.BERTForPretraining(bert.BERTModel(**SMALL), 128)
    model.initialize(ctx=mt.cpu())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(MXNetError):
        bert.load_jax_params(model, bad)
    for k, v in model.state_dict().items():     # nothing was copied
        assert torch.equal(v, before[k]), k
