"""Head dims the flash-attention kernels do not take (anything outside 32,
64 and 128) go to the dense path on every device, as the JAX package's
``multi_head_attention`` runs any head dim off the TPU; 32, 64 and 128 stay
on the kernel route.

Forward and the QKV gradients against the JAX package's
``multi_head_attention`` and ``jax.vjp`` of it, in f32 within 1e-5 (true
fp32 on both sides, only the order of sums differs)."""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops.nn import multi_head_attention as jax_mha
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))


def _no_kernel_route(monkeypatch):
    def refuse(*args):
        raise AssertionError("FlashAttention.apply was called")

    monkeypatch.setattr(fa.FlashAttention, "apply", refuse)


@pytest.mark.parametrize("D", [16, 48])
@pytest.mark.parametrize("causal", [False, True])
def test_other_head_dims_match_jax_forward_and_gradients(D, causal,
                                                         monkeypatch):
    """D = 16 (the generative oracle's model) and D = 48 take the dense
    path, never the kernels' autograd function, and match the JAX
    package's forward and jax.vjp's QKV gradients."""
    _no_kernel_route(monkeypatch)
    rng = onp.random.RandomState(D)
    N, L, H = 2, 40, 2
    q, k, v, g = (rng.randn(N, L, H * D).astype(onp.float32)
                  for _ in range(4))
    want, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, None, heads=H,
                                                causal=causal),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.multi_head_attention(tq, tk, tv, None, heads=H, causal=causal)
    onp.testing.assert_allclose(out.detach().numpy(), onp.asarray(want),
                                rtol=0, atol=1e-5)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b, name in zip(got, want_grads, "qkv"):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), rtol=0,
                                    atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [32, 64, 128])
def test_kernel_head_dims_keep_the_kernel_route(D, monkeypatch):
    """With the kernels' autograd function refusing, D in (32, 64, 128)
    fails: those head dims are never routed to the dense path."""
    _no_kernel_route(monkeypatch)
    x = torch.zeros(1, 16, 2 * D)
    with pytest.raises(AssertionError, match="FlashAttention.apply"):
        ops.multi_head_attention(x, x, x, None, heads=2)


@pytest.mark.parametrize("D", [16, 48, 96])
def test_routing_is_the_same_on_every_device(D, monkeypatch):
    """The routing reads the shape alone: a meta tensor (which stands in
    for a CUDA one here) takes the dense path too, without any kernel."""
    _no_kernel_route(monkeypatch)
    q = torch.empty(1, 2, 24, D, device="meta")
    out = fa.flash_attention(q, q, q, causal=True)
    assert out.shape == q.shape and out.device.type == "meta"
