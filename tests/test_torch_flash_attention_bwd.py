"""The port's flash-attention backward (mxnet_tpu_torch.ops.cuda, K2 + K3)
against the JAX package's Pallas backward kernels run in interpret mode on
the CPU, and the autograd function around both directions.

On the CPU the port takes the plain PyTorch versions; the CUDA kernels
themselves are checked against them on the card by chip_smoke.py. f32
compares within 1e-4 (both sides are true fp32, only the order of sums
differs); bf16 within 2e-2 (P and dS are rounded to bf16 on both sides, so
an ulp of bf16, 7.8e-3 near 1, can flip where the f32 sums differ); fp16
within that times 2^-11 / 2^-8, 2.5e-3 (the same roundings in fp16)."""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops.nn import multi_head_attention as jax_mha
from mxnet_tpu.ops.pallas.flash_attention import (
    _flash_fwd as jax_flash_fwd, _pallas_bwd as jax_pallas_bwd)
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))


def _inputs(seed, shape, n=4):
    rng = onp.random.RandomState(seed)
    return [rng.randn(*shape).astype(onp.float32) for _ in range(n)]


def _pallas_and_plain(shape, causal, jdt, tdt, seed=0):
    """(Pallas dq/dk/dv, plain dq/dk/dv) for the same inputs; the plain
    backward is given the Pallas forward's out and lse."""
    q, k, v, g = _inputs(seed, shape)
    scale = 1.0 / onp.sqrt(shape[-1])
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jdt) for x in (q, k, v, g))
    out, lse = jax_flash_fwd(jq, jk, jv, scale, causal, 128, 128, True)
    want = jax_pallas_bwd(jq, jk, jv, out, lse, jg, scale, causal, 128, 128,
                          True)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    t_out = torch.from_numpy(onp.array(out.astype(jnp.float32))).to(tdt)
    t_lse = torch.from_numpy(onp.array(lse))
    got = fa.flash_attention_bwd_reference(tq, tk, tv, t_out, t_lse, tg,
                                           scale, causal)
    return [onp.asarray(w.astype(jnp.float32)) for w in want], got


# S=300 is no multiple of the 128-row blocks: the Pallas side pads, the
# plain side masks nothing but the causal triangle
@pytest.mark.parametrize("S", [256, 300])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret_f32(S, D, causal):
    want, got = _pallas_and_plain((1, 2, S, D), causal, jnp.float32,
                                  torch.float32)
    for w, t, name in zip(want, got, ("dq", "dk", "dv")):
        assert t.dtype == torch.float32 and tuple(t.shape) == w.shape, name
        onp.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-4,
                                    err_msg=name)


@pytest.mark.parametrize("S,D,causal", [(300, 64, False), (256, 32, True)])
def test_plain_backward_matches_pallas_interpret_bf16(S, D, causal):
    want, got = _pallas_and_plain((1, 2, S, D), causal, jnp.bfloat16,
                                  torch.bfloat16, seed=1)
    for w, t, name in zip(want, got, ("dq", "dk", "dv")):
        assert t.dtype == torch.bfloat16, name
        onp.testing.assert_allclose(t.float().numpy(), w, rtol=0, atol=2e-2,
                                    err_msg=name)


@pytest.mark.parametrize("S", [70, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_dense_autograd(S, causal):
    """FlashAttention on CPU tensors (plain forward and backward) against
    autograd through the dense composite, in f32."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, (2, 2, S, 32)))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.FlashAttention.apply(q, k, v, 0.2, causal)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = fa._dense_attention(q, k, v, 0.2, causal)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_function_bf16_gradients_keep_dtype_and_count_nothing():
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(3, (1, 2, 96, 64)))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out = fa.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == before
    for x in (dq, dk, dv):
        assert x.dtype == torch.bfloat16 and x.shape == q.shape
        assert torch.isfinite(x.float()).all()


@pytest.mark.parametrize("wrapper", ["bwd_dq", "bwd_dkv", "bwd"])
def test_backward_wrappers_refuse_cpu_tensors_without_counting(wrapper):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, (1, 1, 64, 64)))
    lse = torch.zeros(1, 1, 64)
    before = (fa.launches_dq, fa.launches_dkv)
    with pytest.raises(MXNetError, match="CUDA tensor"):
        if wrapper == "bwd":
            fa.flash_attention_bwd(q, k, v, q, lse, g, 0.125, False)
        elif wrapper == "bwd_dq":
            fa.flash_attention_bwd_dq(q, k, v, q, g, lse, 0.125, False)
        else:
            fa.flash_attention_bwd_dkv(q, k, v, g, lse, lse, 0.125, False)
    assert (fa.launches_dq, fa.launches_dkv) == before


def _pallas_and_kernel_plains(shape, causal, jdt, tdt, seed):
    """The Pallas backward's (dq, dk, dv) and the reference's delta (the
    ``jnp.sum`` in ``_pallas_bwd``), beside the two plain kernel versions'
    (dq, delta) and (dk, dv), K3's given K2's delta, on the same inputs and
    the Pallas forward's out and lse."""
    q, k, v, g = _inputs(seed, shape)
    scale = 1.0 / onp.sqrt(shape[-1])
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jdt) for x in (q, k, v, g))
    out, lse = jax_flash_fwd(jq, jk, jv, scale, causal, 128, 128, True)
    want = jax_pallas_bwd(jq, jk, jv, out, lse, jg, scale, causal, 128, 128,
                          True)
    want_delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32),
                         axis=-1)
    tq, tk, tv, tg = (torch.from_numpy(x).to(tdt) for x in (q, k, v, g))
    t_out = torch.from_numpy(onp.array(out.astype(jnp.float32))).to(tdt)
    t_lse = torch.from_numpy(onp.array(lse))
    dq, delta = fa.flash_attention_bwd_dq_reference(tq, tk, tv, t_out, tg,
                                                    t_lse, scale, causal)
    dk, dv = fa.flash_attention_bwd_dkv_reference(tq, tk, tv, tg, t_lse,
                                                  delta, scale, causal)
    want = [onp.asarray(w.astype(jnp.float32)) for w in want]
    return want + [onp.asarray(want_delta)], [dq, dk, dv, delta]


# each plain kernel version against Pallas in interpret mode: f32 within
# 1e-4 (sum order only), bf16 within 2e-2 (P and dS rounded to bf16 on both
# sides); delta is f32 on both sides, within 1e-4 (f32) or 1e-3 (sums of up
# to 64 bf16 products of unit-variance values: sum order only)
@pytest.mark.parametrize("S", [256, 300])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernel_versions_match_pallas_interpret(S, D, causal, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    want, got = _pallas_and_kernel_plains((1, 2, S, D), causal, jdt, tdt,
                                          seed=S + D + causal)
    for w, t, name in zip(want, got, ("dq", "dk", "dv", "delta")):
        out_dtype = torch.float32 if name == "delta" else tdt
        assert t.dtype == out_dtype and tuple(t.shape) == w.shape, name
        atol = (1e-4 if dtype == "float32" else 1e-3) if name == "delta" \
            else tol
        onp.testing.assert_allclose(t.float().numpy(), w, rtol=0, atol=atol,
                                    err_msg=name)


def test_composed_plain_backward_is_the_two_kernel_versions():
    """flash_attention_bwd_reference is K2's plain version then K3's, on
    K2's delta: bitwise the same tensors."""
    q, k, v, g, o = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _inputs(6, (1, 2, 96, 32), n=5))
    lse = torch.from_numpy(_inputs(7, (1, 2, 96), n=1)[0]).abs() + 3.0
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, o, lse, g, 0.2,
                                                  True)
    dq2, delta = fa.flash_attention_bwd_dq_reference(q, k, v, o, g, lse, 0.2,
                                                     True)
    dk2, dv2 = fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                    0.2, True)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_gradients_match_jax(causal):
    """Gradients of ops.nn.multi_head_attention (the module that reaches
    the kernels) against jax.vjp of the JAX package's, same inputs."""
    rng = onp.random.RandomState(5)
    N, L, H, D = 2, 48, 4, 16
    q, k, v, g = (rng.randn(N, L, H * D).astype(onp.float32)
                  for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, None, heads=H,
                                              causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.multi_head_attention(tq, tk, tv, None, heads=H, causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), rtol=0,
                                    atol=1e-5)


FP16_TOL = 2e-2 * 2.0 ** -11 / 2.0 ** -8


@pytest.mark.parametrize("D,causal", [(32, False), (64, False), (64, True)])
def test_plain_kernel_versions_match_pallas_interpret_fp16(D, causal):
    """K2's and K3's plain versions in fp16 (P and dS rounded to fp16, as
    the card's fp16 instances round them) against the Pallas backward
    kernels in interpret mode; delta is f32 on both sides."""
    want, got = _pallas_and_kernel_plains((1, 2, 128, D), causal,
                                          jnp.float16, torch.float16,
                                          seed=7 + D + causal)
    for w, t, name in zip(want, got, ("dq", "dk", "dv", "delta")):
        assert t.dtype == (torch.float32 if name == "delta"
                           else torch.float16), name
        onp.testing.assert_allclose(t.float().numpy(), w, rtol=0,
                                    atol=FP16_TOL, err_msg=name)


def test_fp16_function_matches_the_references_vjp():
    """The autograd function in fp16 on the CPU (K1's, K2's and K3's plain
    versions) against ``jax.vjp`` of the reference's ``flash_attention``
    (its Pallas forward in interpret mode; at this length its backward is
    the dense recompute), causal."""
    from mxnet_tpu.ops.pallas.flash_attention import flash_attention
    shape = (1, 2, 128, 64)
    q, k, v, g = _inputs(11, shape)
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jnp.float16) for x in (q, k, v, g))
    j_out, pullback = jax.vjp(
        lambda a, b, c: flash_attention(a, b, c, causal=True, interpret=True),
        jq, jk, jv)
    j_grads = pullback(jg)
    tq, tk, tv = (torch.from_numpy(x).to(torch.float16).requires_grad_()
                  for x in (q, k, v))
    out = fa.FlashAttention.apply(tq, tk, tv, 0.125, True)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(g).to(torch.float16))
    onp.testing.assert_allclose(out.detach().float().numpy(),
                                onp.asarray(j_out.astype(jnp.float32)),
                                rtol=0, atol=FP16_TOL)
    for t, w, name in zip(grads, j_grads, ("dq", "dk", "dv")):
        assert t.dtype == torch.float16, name
        onp.testing.assert_allclose(t.float().numpy(),
                                    onp.asarray(w.astype(jnp.float32)),
                                    rtol=0, atol=FP16_TOL, err_msg=name)
