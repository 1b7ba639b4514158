"""The port's TransformerLM and the decode step's attention
(mxnet_tpu_torch.gluon.model_zoo.bert.TransformerLM,
mxnet_tpu_torch.ops.nn.single_query_attention) against the JAX package on
the CPU, at a small size.

Weights are made with numpy from a seed and cross into the port through the
weight carrier. f32 throughout: the three entry points agree within 1e-5
(both sides true fp32, sums in another order), single_query_attention within
1e-6. At units 32 with 2 heads (D = 16) the prefill's causal attention is
the dense path on both sides; at units 64 with 2 heads (D = 32) the port's
causal prefill goes through ``FlashAttention`` (its plain version on the
CPU), which is also held against the JAX package's Pallas flash-attention
kernel run in interpret mode."""
import numpy as onp
import pytest

import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import TransformerLM as JaxLM
from mxnet_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash, single_query_attention as jax_sqa)

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.bert import (
    TransformerLM, load_jax_params, params_from_jax)
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

# the reference test's config (D = 16) and a D = 32 twin
CONFIGS = {"units32": dict(num_layers=2, units=32, hidden_size=64,
                           num_heads=2, vocab_size=50, max_length=64),
           "units64": dict(num_layers=2, units=64, hidden_size=128,
                           num_heads=2, vocab_size=50, max_length=64)}


def _pair(cfg, seed=0):
    """The JAX TransformerLM and the port's, with the same seeded weights
    (0.1 * N(0, 1), LayerNorm gamma 1 + that)."""
    jlm = JaxLM(**cfg)
    jlm.initialize()
    jlm(mx.nd.array(onp.zeros((1, 4), onp.int32), dtype="int32"))
    rng = onp.random.RandomState(seed)
    named = {}
    for name, p in jlm._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        if name.endswith("gamma"):
            a += 1.0
        p.set_data(mx.nd.array(a))
        named[name] = a
    tlm = TransformerLM(**cfg)
    load_jax_params(tlm, named)
    return jlm, tlm.eval(), named


def _close(got, want, atol):
    onp.testing.assert_allclose(got.detach().numpy(), want.asnumpy(),
                                rtol=0, atol=atol)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_forward_and_prefill_collect_match_jax(cfg):
    jlm, tlm, _ = _pair(CONFIGS[cfg])
    tok = onp.random.RandomState(1).randint(0, 50, (2, 40)).astype(onp.int32)
    jt = mx.nd.array(tok, dtype="int32")
    with torch.inference_mode():
        t_logits = tlm(torch.from_numpy(tok))
        t_outs = tlm.prefill_collect(torch.from_numpy(tok))
    assert tuple(t_logits.shape) == (2, 40, 50)
    _close(t_logits, jlm(jt), 1e-5)
    j_outs = jlm.prefill_collect(jt)
    assert len(t_outs) == len(j_outs) == 1 + 2 * CONFIGS[cfg]["num_layers"]
    for got, want in zip(t_outs, j_outs):
        _close(got, want, 1e-5)
    assert torch.equal(t_outs[0], t_logits)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_decode_step_matches_jax(cfg):
    """One decode step per row against a context the JAX prefill filled:
    lanes past each row's length hold large finite garbage, which must get
    an exactly-zero weight on both sides."""
    jlm, tlm, _ = _pair(CONFIGS[cfg])
    rng = onp.random.RandomState(2)
    B, L, U = 3, 24, CONFIGS[cfg]["units"]
    tok = rng.randint(0, 50, (B, L)).astype(onp.int32)
    j_outs = jlm.prefill_collect(mx.nd.array(tok, dtype="int32"))
    lengths = onp.array([0, 9, L - 1], onp.int32)
    ctx = []
    for a in j_outs[1:]:
        a = a.asnumpy().copy()
        for b, n in enumerate(lengths):
            a[b, n:] = rng.uniform(-1e4, 1e4, (L - n, U))
        ctx.append(a)
    ids = rng.randint(0, 50, (B,)).astype(onp.int32)
    j_step = jlm.decode_step(mx.nd.array(ids, dtype="int32"),
                             mx.nd.array(lengths, dtype="int32"),
                             *[mx.nd.array(a) for a in ctx])
    with torch.inference_mode():
        t_step = tlm.decode_step(torch.from_numpy(ids),
                                 torch.from_numpy(lengths),
                                 *[torch.from_numpy(a) for a in ctx])
    assert tuple(t_step[0].shape) == (B, 50)
    for got, want in zip(t_step, j_step):
        _close(got, want, 1e-5)


def test_decode_step_rows_past_the_context_pad_the_products():
    """``decode_step`` with more id rows (R) than context rows (B): the
    first B rows equal the unpadded step, and at a fixed R a row's logits
    are bitwise the same whatever B and whatever the other rows hold (the
    engine's batched-equals-serial construction)."""
    _, tlm, _ = _pair(CONFIGS["units32"])
    rng = onp.random.RandomState(3)
    R, L, U = 4, 16, 32
    ctx = [torch.from_numpy(rng.randn(R, L, U).astype(onp.float32))
           for _ in range(4)]
    ids = torch.from_numpy(rng.randint(0, 50, (R,)).astype(onp.int64))
    pos = torch.tensor([5, 11, 2, 15])
    with torch.inference_mode():
        full = tlm.decode_step(ids, pos, *ctx)
        one = tlm.decode_step(ids[:1], pos[:1], *[c[:1] for c in ctx])
        padded = tlm.decode_step(ids, pos, *[c[:1] for c in ctx])
        other = tlm.decode_step(torch.cat([ids[:1], ids[1:].flip(0)]),
                                torch.cat([pos[:1], pos[1:].flip(0)]),
                                *[c[:2] for c in ctx])
    assert tuple(padded[0].shape) == (R, 50)
    onp.testing.assert_allclose(padded[0][:1].numpy(), one[0].numpy(),
                                rtol=0, atol=1e-5)
    for a, b, c in zip(full, padded, other):
        assert torch.equal(a[:1], b[:1]) and torch.equal(a[:1], c[:1])


@pytest.mark.parametrize("lengths", [[0, 0], [7, 20], [31, 31], [0, 31]])
@pytest.mark.parametrize("heads", [1, 2])
def test_single_query_attention_matches_jax(lengths, heads):
    """Lengths 0, mid and L - 1, with the stale lanes (past each length)
    filled with large finite values."""
    rng = onp.random.RandomState(4)
    B, L, U = 2, 32, 32
    q, k_new, v_new = (rng.randn(B, U).astype(onp.float32) for _ in range(3))
    k_ctx, v_ctx = (rng.randn(B, L, U).astype(onp.float32) for _ in range(2))
    for b, n in enumerate(lengths):
        k_ctx[b, n:] = rng.uniform(-1e6, 1e6, (L - n, U))
        v_ctx[b, n:] = rng.uniform(-1e6, 1e6, (L - n, U))
    lens = onp.asarray(lengths, onp.int32)
    want = jax_sqa(*(jnp.asarray(a) for a in (q, k_ctx, v_ctx, k_new, v_new,
                                              lens)), heads=heads)
    got = ops.single_query_attention(
        *(torch.from_numpy(a) for a in (q, k_ctx, v_ctx, k_new, v_new, lens)),
        heads=heads)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-6)


def test_single_query_attention_masks_stale_lanes_exactly():
    """Changing lanes past ``lengths`` (to other finite values) changes
    nothing, bitwise: their softmax weight is exactly zero."""
    rng = onp.random.RandomState(5)
    B, L, U = 2, 16, 16
    args = [torch.from_numpy(rng.randn(*s).astype(onp.float32))
            for s in ((B, U), (B, L, U), (B, L, U), (B, U), (B, U))]
    lens = torch.tensor([3, 9])
    a = ops.single_query_attention(*args, lens, heads=2)
    k2, v2 = args[1].clone(), args[2].clone()
    k2[0, 4:], v2[0, 4:] = 1e30, -1e30
    k2[1, 10:], v2[1, 10:] = -7.0, 3.0e20
    b = ops.single_query_attention(args[0], k2, v2, args[3], args[4], lens,
                                   heads=2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("S", [16, 48])
def test_causal_attention_d32_matches_jax_flash_interpret(S):
    """The prefill's attention at D = 32: the port's ``FlashAttention``
    (plain version on the CPU) against the JAX Pallas kernel in interpret
    mode, causal, on the split views of one QKV buffer."""
    rng = onp.random.RandomState(6)
    N, H, D = 1, 2, 32
    qkv = rng.randn(N, S, 3 * H * D).astype(onp.float32)
    q, k, v = (torch.from_numpy(qkv).split(H * D, dim=-1))
    before = fa.launches
    got = ops.multi_head_attention(q, k, v, None, heads=H, causal=True)
    assert fa.launches == before          # the plain version does not count
    qh, kh, vh = (jnp.asarray(x.numpy().reshape(N, S, H, D)
                              .transpose(0, 2, 1, 3)) for x in (q, k, v))
    want = jax_flash(qh, kh, vh, causal=True, interpret=True)
    want = onp.asarray(want).transpose(0, 2, 1, 3).reshape(N, S, H * D)
    onp.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_carrier_takes_a_transformer_lm_parameter_set():
    _, tlm, named = _pair(CONFIGS["units32"])
    assert set(named) == set(tlm.state_dict())
    assert "word_embed.weight" in named and "embed_ln.gamma" in named
    assert not any(k.startswith(("token_type_embed", "pooler"))
                   for k in named)
    state = params_from_jax(named)
    assert set(state) == set(named)
    for k, v in state.items():
        assert torch.equal(v, torch.from_numpy(named[k]))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_carrier_refuses_a_bad_transformer_lm_set(fault):
    _, tlm, named = _pair(CONFIGS["units32"])
    named = dict(named)
    if fault == "missing":
        del named["encoder.layer1.ffn.ffn2.bias"]
    elif fault == "extra":
        named["encoder.layer0.attention.extra"] = onp.zeros(3, onp.float32)
    else:
        named["embed_ln.beta"] = onp.zeros(31, onp.float32)
    with pytest.raises(MXNetError, match="TransformerLM"):
        load_jax_params(tlm, named)
    with pytest.raises(MXNetError):
        params_from_jax(named)
