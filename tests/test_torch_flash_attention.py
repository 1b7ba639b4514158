"""The port's flash-attention forward (mxnet_tpu_torch.ops.cuda) against the
JAX package's Pallas kernel run in interpret mode on the CPU.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is checked on the card by chip_smoke.py. f32 compares within
1e-5 (both sides are true fp32, only the order of sums differs); bf16
within 2e-2 (P is rounded to bf16, and bf16 outputs differ by an ulp)."""
import numpy as onp
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu.ops.pallas.flash_attention import (
    _dense_attention as jax_dense, _flash_fwd as jax_flash_fwd)
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))


def _inputs(seed, shape, dtype=onp.float32):
    rng = onp.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(3)]


# the shapes of tests/test_flash_attention.py: (B, H, S, D), block_q,
# block_k, causal; S=640 with bq=512/bk=128 pads whole k-blocks
CASES = [((2, 2, 256, 64), 512, 1024, False),
         ((2, 2, 256, 64), 512, 1024, True),
         ((1, 1, 192, 64), 128, 128, False),
         ((1, 2, 640, 64), 512, 128, False),
         ((1, 2, 640, 64), 512, 128, True)]


@pytest.mark.parametrize("shape,bq,bk,causal", CASES)
def test_reference_matches_pallas_interpret_f32(shape, bq, bk, causal):
    q, k, v = _inputs(0, shape)
    scale = 1.0 / onp.sqrt(shape[-1])
    j_out, j_lse = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, causal, bq, bk, True)
    t_out, t_lse = fa.flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale, causal)
    onp.testing.assert_allclose(t_out.numpy(), onp.asarray(j_out),
                                rtol=0, atol=1e-5)
    onp.testing.assert_allclose(t_lse.numpy(), onp.asarray(j_lse),
                                rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_matches_pallas_interpret_bf16(causal):
    shape = (1, 2, 256, 64)
    q, k, v = _inputs(1, shape)
    scale = 1.0 / onp.sqrt(shape[-1])
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    j_out, j_lse = jax_flash_fwd(jq, jk, jv, scale, causal, 128, 128, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    t_out, t_lse = fa.flash_attention_fwd_reference(tq, tk, tv, scale, causal)
    assert t_out.dtype == torch.bfloat16 and t_lse.dtype == torch.float32
    onp.testing.assert_allclose(t_out.float().numpy(),
                                onp.asarray(j_out.astype(jnp.float32)),
                                rtol=0, atol=2e-2)
    onp.testing.assert_allclose(t_lse.numpy(), onp.asarray(j_lse),
                                rtol=0, atol=2e-2)


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, (1, 2, 128, 32)))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.launches == before
    ref, _ = fa.flash_attention_fwd_reference(q, k, v, 32 ** -0.5, True)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_cross_length_goes_dense_bottom_right(causal):
    rng = onp.random.RandomState(3)
    q = rng.randn(2, 2, 8, 32).astype(onp.float32)
    k = rng.randn(2, 2, 20, 32).astype(onp.float32)
    v = rng.randn(2, 2, 20, 32).astype(onp.float32)
    before = fa.launches
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert fa.launches == before
    want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     1.0 / onp.sqrt(32), causal)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-5)
    if causal:
        # bottom-right: the last query row attends every key, the first
        # query row keys 0..Lk-Lq
        s = torch.from_numpy(q[0, 0]) @ torch.from_numpy(k[0, 0]).T / onp.sqrt(32)
        first = torch.softmax(s[0, :13], -1) @ torch.from_numpy(v[0, 0, :13])
        onp.testing.assert_allclose(out[0, 0, 0].numpy(), first.numpy(),
                                    rtol=0, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, (1, 1, 64, 64)))
    before = fa.launches
    with pytest.raises(MXNetError, match="CUDA tensor"):
        fa.flash_attention_fwd(q, k, v, 0.125, False)
    assert fa.launches == before
