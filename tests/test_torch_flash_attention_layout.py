"""K1's layouts: the flash-attention forward reads q, k and v in place as
the split views of one QKV projection and writes its output as (B, S, H, D)
memory, so ``multi_head_attention`` makes no layout copy around it.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself, on strided and contiguous inputs, is checked on the card by
chip_smoke.py. Against the JAX package's Pallas kernel in interpret mode:
f32 within 1e-5 (true fp32 on both sides, only the order of sums differs),
bf16 within 2e-2 (P is rounded to bf16, and bf16 outputs differ by an
ulp), as in test_torch_flash_attention.py."""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops.nn import multi_head_attention as jax_mha
from mxnet_tpu.ops.pallas.flash_attention import _flash_fwd as jax_flash_fwd
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))


def _split_views(qkv, heads):
    """The (B, H, S, D) views of q, k and v in a (B, S, 3 H D) buffer."""
    B, S, three_hd = qkv.shape
    D = three_hd // (3 * heads)
    return [x.view(B, S, heads, D).transpose(1, 2)
            for x in qkv.split(heads * D, dim=-1)]


# (B, H, S, D), block_q, block_k, causal: the Pallas kernel's blocks as in
# test_torch_flash_attention.py; S = 640 pads whole k-blocks
CASES = [((2, 2, 256, 64), 128, 128, False),
         ((2, 2, 256, 64), 128, 128, True),
         ((1, 3, 192, 32), 128, 128, False),
         ((1, 2, 640, 64), 512, 128, True)]


@pytest.mark.parametrize("shape,bq,bk,causal", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_views_match_pallas_interpret(shape, bq, bk, causal, dtype):
    B, H, S, D = shape
    qkv = onp.random.RandomState(7).randn(B, S, 3 * H * D).astype(onp.float32)
    tdt = getattr(torch, dtype)
    q, k, v = _split_views(torch.from_numpy(qkv).to(tdt), H)
    assert not q.is_contiguous()
    scale = 1.0 / onp.sqrt(D)
    jq, jk, jv = (jnp.asarray(x.float().contiguous().numpy(),
                              dtype=getattr(jnp, dtype)) for x in (q, k, v))
    j_out, j_lse = jax_flash_fwd(jq, jk, jv, scale, causal, bq, bk, True)
    t_out, t_lse = fa.flash_attention_fwd_reference(q, k, v, scale, causal)
    tol = 1e-5 if dtype == "float32" else 2e-2
    onp.testing.assert_allclose(t_out.float().numpy(),
                                onp.asarray(j_out.astype(jnp.float32)),
                                rtol=0, atol=tol)
    onp.testing.assert_allclose(t_lse.numpy(), onp.asarray(j_lse), rtol=0,
                                atol=tol)


def _buffer(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype,elt", [(torch.bfloat16, 2),
                                       (torch.float32, 4)])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_stride_rule_takes_split_views_and_the_output_layout(dtype, elt, D):
    B, S, H = 2, 5, 3
    q, k, v = _split_views(_buffer((B, S, 3 * H * D), dtype), H)
    for x in (q, k, v):
        assert fa.tma_strides(x) == (3 * H * D * elt, D * elt,
                                     S * 3 * H * D * elt)
    out = _buffer((B, S, H, D), dtype).transpose(1, 2)
    assert fa.tma_strides(out) == (H * D * elt, D * elt, S * H * D * elt)
    assert fa.tma_strides(out.transpose(1, 2).contiguous()
                          .view(B, H, S, D)) == (D * elt, S * D * elt,
                                                 H * S * D * elt)


@pytest.mark.parametrize("shape,stride,want", [
    ((1, 1, 5, 32), (7, 3, 32, 1), (64, 16, 16)),        # B = H = 1
    ((2, 1, 5, 32), (160, 0, 32, 1), (64, 16, 320)),     # H = 1, stride 0
    ((2, 3, 1, 32), (96, 32, 5, 1), (16, 64, 192))])     # S = 1
def test_stride_rule_ignores_the_strides_of_size_one_dims(shape, stride,
                                                          want):
    x = _buffer((2 * 3 * 5 * 32,)).as_strided(shape, stride)
    assert fa.tma_strides(x) == want


@pytest.mark.parametrize("case", ["d_stride", "stride_not_16B", "misaligned",
                                  "not_4d"])
def test_stride_rule_refuses_what_tma_cannot_address(case):
    if case == "d_stride":        # the head dim is not the unit-stride one
        x = _buffer((1, 2, 64, 64)).transpose(2, 3)
        match = "unit stride"
    elif case == "stride_not_16B":   # rows of 36 bf16 = 72 bytes
        x = _buffer((1, 2, 8, 36))[..., :32]
        match = "multiple of 16 bytes"
    elif case == "misaligned":       # starts one element into the buffer
        x = _buffer((1, 2, 8, 64 + 8))[..., 1:65]
        match = "16-byte aligned"
    else:
        x = _buffer((2, 8, 64))
        match = r"\(B, H, S, D\)"
    with pytest.raises(MXNetError, match=match):
        fa.tma_strides(x)


def test_a_failed_encode_or_launch_raises():
    q = torch.zeros(1, 1, 8, 32)
    with pytest.raises(MXNetError, match="tensor-map encode failed with "
                                         "CUresult 1"):
        fa._raise_on(-1, "flash_attention_fwd", q)
    with pytest.raises(MXNetError, match="CUDA error 98"):
        fa._raise_on(98, "flash_attention_fwd", q)
    fa._raise_on(0, "flash_attention_fwd", q)


def _record_flash_args(monkeypatch):
    seen = []
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", recording)
    return seen


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_hands_the_qkv_views_over(causal, monkeypatch):
    """On the flash route q, k and v reach flash_attention as views of the
    QKV projection's output (no copy), and the result still matches the
    JAX package's multi_head_attention."""
    rng = onp.random.RandomState(11)
    N, L, H, D = 2, 48, 4, 16
    qkv = torch.from_numpy(rng.randn(N, L, 3 * H * D).astype(onp.float32))
    q, k, v = qkv.split(H * D, dim=-1)
    seen = _record_flash_args(monkeypatch)
    got = ops.multi_head_attention(q, k, v, None, heads=H, causal=causal)
    assert len(seen) == 1
    for x in seen[0]:
        assert x.shape == (N, H, L, D) and not x.is_contiguous()
        assert x.untyped_storage().data_ptr() == \
            qkv.untyped_storage().data_ptr()
    want = jax_mha(*(jnp.asarray(x.contiguous().numpy()) for x in (q, k, v)),
                   None, heads=H, causal=causal)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_through_the_qkv_views_match_jax(causal):
    """The backward reaches the QKV buffer through the views (as the BERT
    layer's split does) and matches jax.vjp of the JAX package's
    multi_head_attention."""
    rng = onp.random.RandomState(12)
    N, L, H, D = 2, 40, 4, 16
    qkv = rng.randn(N, L, 3 * H * D).astype(onp.float32)
    g = rng.randn(N, L, H * D).astype(onp.float32)
    t_qkv = torch.from_numpy(qkv).requires_grad_()
    out = ops.multi_head_attention(*t_qkv.split(H * D, dim=-1), None,
                                   heads=H, causal=causal)
    (got,) = torch.autograd.grad(out, (t_qkv,), torch.from_numpy(g))
    _, vjp = jax.vjp(
        lambda x: jax_mha(*jnp.split(x, 3, axis=-1), None, heads=H,
                          causal=causal), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-5)


def _kernel_route_on_cpu(monkeypatch):
    """FlashAttention's CUDA route run on CPU tensors: the three kernel
    wrappers replaced by their plain versions, writing the kernels' output
    layout ((B, S, H, D) memory) and recording what they were handed."""
    seen = {}

    def bshd(x):
        return fa._bshd_like(x).copy_(x)

    def fwd(q, k, v, scale, causal):
        seen["fwd"] = (q, k, v)
        out, lse = fa.flash_attention_fwd_reference(q, k, v, scale, causal)
        return bshd(out), lse

    def dq(q, k, v, out, dout, lse, scale, causal):
        seen["dq"] = (q, k, v, out, dout)
        g, delta = fa.flash_attention_bwd_dq_reference(q, k, v, out, dout,
                                                       lse, scale, causal)
        return bshd(g), delta

    def dkv(q, k, v, dout, lse, delta, scale, causal):
        seen["dkv"] = (q, k, v, dout)
        return tuple(bshd(g) for g in fa.flash_attention_bwd_dkv_reference(
            q, k, v, dout, lse, delta, scale, causal))

    monkeypatch.setattr(fa, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(fa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", dq)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", dkv)
    return seen


@pytest.mark.parametrize("causal", [False, True])
def test_backward_reads_every_view_in_place(causal, monkeypatch):
    """On the kernel route the backward hands K2 and K3 the QKV
    projection's views, the forward's (B, S, H, D) output and the model's
    transposed output gradient as they are: no copy, and every one is a
    layout the stride rule takes. The gradient still matches jax.vjp of
    the JAX package's multi_head_attention within 1e-5 (f32)."""
    seen = _kernel_route_on_cpu(monkeypatch)
    rng = onp.random.RandomState(13)
    N, L, H, D = 2, 40, 4, 32
    qkv = rng.randn(N, L, 3 * H * D).astype(onp.float32)
    g = rng.randn(N, L, H * D).astype(onp.float32)
    t_qkv = torch.from_numpy(qkv).requires_grad_()
    out = ops.multi_head_attention(*t_qkv.split(H * D, dim=-1), None,
                                   heads=H, causal=causal)
    (got,) = torch.autograd.grad(out, (t_qkv,), torch.from_numpy(g))
    storage = t_qkv.untyped_storage().data_ptr()
    for name in ("dq", "dkv"):
        for x in seen[name][:3]:
            assert x.untyped_storage().data_ptr() == storage, name
            assert not x.is_contiguous()
    fwd_out = seen["dq"][3]
    assert fwd_out.transpose(1, 2).is_contiguous()
    for dout in (seen["dq"][4], seen["dkv"][3]):
        assert dout.shape == (N, H, L, D) and not dout.is_contiguous()
        assert dout.transpose(1, 2).is_contiguous()
    for x in seen["dq"] + seen["dkv"]:
        assert fa.tma_addressable(x)
    _, vjp = jax.vjp(
        lambda x: jax_mha(*jnp.split(x, 3, axis=-1), None, heads=H,
                          causal=causal), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-5)


def test_an_expanded_gradient_is_made_contiguous_first(monkeypatch):
    """The one copy on the kernel route: an output gradient TMA cannot
    address (``out.sum().backward()`` hands back an expanded one, all
    strides 0) is made contiguous before K2 and K3 read it."""
    seen = _kernel_route_on_cpu(monkeypatch)
    q, k, v = (torch.randn(1, 2, 24, 32, generator=torch.Generator()
                           .manual_seed(i)).requires_grad_()
               for i in range(3))
    fa.FlashAttention.apply(q, k, v, 0.25, False).sum().backward()
    dout = seen["dq"][4]
    assert dout.is_contiguous() and fa.tma_addressable(dout)
    assert torch.equal(dout, torch.ones_like(dout))
    assert not fa.tma_addressable(torch.ones(1, 2, 24, 32).expand(
        1, 2, 24, 32)[..., :1].expand(1, 2, 24, 32))
