"""The port's fused 1x1-conv + BatchNorm op (K4,
mxnet_tpu_torch.ops.cuda.fused_conv1x1) against the JAX package's Pallas
kernel run in interpret mode on the CPU, and against its plain reference.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is checked on the card by chip_smoke.py (phase 2c).
Tolerances: y within one bf16 ulp of its largest value (2^-7 max |ref|):
the port and the JAX reference round f32 sums taken in another order, so a
value can land on the neighbouring bf16, and the Pallas kernel in interpret
mode sums its bf16 products less exactly still (its own y is up to 1.3e-3
from the JAX reference's at |y| <= 4); the column moments within 1e-5 of
max |ref| (f32 sums over up to 1024 rows in another order; measured up to
5.6e-6 against Pallas, 2.9e-7 against the reference).

The Pallas kernel is compared only where ``block_m`` divides M: it sums
every row of its last M tile into the moments, rows past M included, so at
a ragged M (1000 rows at block_m 512) its moments are NaN in interpret
mode. There the port is held against the JAX ``conv1x1_bn_act_reference``,
which computes what the kernel should."""
import itertools

import numpy as onp
import pytest

import jax.numpy as jnp
import torch

from mxnet_tpu.ops.pallas.fused_conv1x1 import (
    conv1x1_bn_act as jax_fused, conv1x1_bn_act_reference as jax_reference)
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops.cuda import fused_conv1x1 as fc

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))


def _inputs(seed, M, K, N):
    rng = onp.random.RandomState(seed)
    x = rng.randn(M, K).astype(onp.float32)
    w = (rng.randn(K, N) / onp.sqrt(K)).astype(onp.float32)
    scale = (0.5 + rng.rand(K)).astype(onp.float32)
    shift = (0.2 * rng.randn(K)).astype(onp.float32)
    return x, w, scale, shift


def _port(x, w, scale, shift, x_dtype, relu):
    tx = torch.from_numpy(x).to(x_dtype)
    return fc.conv1x1_bn_act(tx, torch.from_numpy(w), torch.from_numpy(scale),
                             torch.from_numpy(shift), relu=relu)


def _jax_args(x, w, scale, shift, x_dtype):
    jx = jnp.asarray(x)
    if x_dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    return jx, jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift)


def _assert_close(port, ref):
    y, s, q = port
    ry, rs, rq = (onp.asarray(a, dtype=onp.float32) for a in ref)
    got = y.float().numpy()
    assert got.shape == ry.shape
    onp.testing.assert_allclose(got, ry, rtol=0,
                                atol=2.0 ** -7 * onp.abs(ry).max())
    for a, b in ((s, rs), (q, rq)):
        assert a.dtype == torch.float32
        onp.testing.assert_allclose(a.numpy(), b, rtol=0,
                                    atol=1e-5 * max(1.0, onp.abs(b).max()))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape,block_m", [((1024, 64, 256), 512),
                                           ((896, 128, 64), 448)])
def test_plain_version_matches_pallas_interpret(shape, block_m, relu,
                                                x_dtype):
    x, w, scale, shift = _inputs(0, *shape)
    ref = jax_fused(*_jax_args(x, w, scale, shift, x_dtype), relu=relu,
                    block_m=block_m, interpret=True)
    _assert_close(_port(x, w, scale, shift, x_dtype, relu), ref)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_plain_version_matches_jax_reference_at_ragged_m(relu, x_dtype):
    x, w, scale, shift = _inputs(1, 1000, 64, 64)
    ref = jax_reference(*_jax_args(x, w, scale, shift, x_dtype), relu=relu)
    _assert_close(_port(x, w, scale, shift, x_dtype, relu), ref)


def test_pallas_kernel_moments_are_wrong_at_ragged_m():
    """The reference's fault the port does not copy: with block_m not
    dividing M the Pallas kernel sums rows past M into the moments (NaN in
    interpret mode), while y itself is right."""
    x, w, scale, shift = _inputs(2, 1000, 64, 64)
    args = _jax_args(x, w, scale, shift, torch.float32)
    y, s, _ = jax_fused(*args, block_m=512, interpret=True)
    ry, rs, _ = jax_reference(*args)
    onp.testing.assert_array_equal(onp.asarray(y, onp.float32),
                                   onp.asarray(ry, onp.float32))
    assert not onp.allclose(onp.asarray(s), onp.asarray(rs), equal_nan=False)
    port = _port(x, w, scale, shift, torch.float32, True)
    assert torch.isfinite(port[1]).all() and torch.isfinite(port[2]).all()


def test_cpu_tensors_take_the_plain_version():
    x, w, scale, shift = (torch.from_numpy(a) for a in _inputs(3, 200, 16, 24))
    before = fc.launches
    got = fc.conv1x1_bn_act(x, w, scale, shift)
    want = fc.conv1x1_bn_act_reference(x, w, scale, shift)
    assert fc.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (200, 24)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("K,N", [(12, 64), (64, 20), (3, 5)])
def test_kernel_call_refuses_k_or_n_not_a_multiple_of_8(K, N):
    """A non-CPU call goes to the kernel's checks (here on meta tensors,
    which stand in for CUDA ones): K and N must be multiples of 8."""
    with pytest.raises(MXNetError, match="multiples of 8"):
        fc.conv1x1_bn_act(_meta(32, K, dtype=torch.bfloat16), _meta(K, N),
                          _meta(K), _meta(K))


@pytest.mark.parametrize("fault", ["x_dtype", "scale_shape", "w_shape",
                                   "not_cuda"])
def test_kernel_call_refuses_what_the_kernel_does_not_take(fault):
    x, w, s, t = (_meta(32, 64, dtype=torch.bfloat16), _meta(64, 16),
                  _meta(64), _meta(64))
    match = {"x_dtype": "bfloat16 or float32", "scale_shape": r"\(64,\)",
             "w_shape": "expected", "not_cuda": "CUDA tensor"}[fault]
    if fault == "x_dtype":
        x = _meta(32, 64, dtype=torch.float16)
    elif fault == "scale_shape":
        s = _meta(32)
    elif fault == "w_shape":
        w = _meta(48, 16)
    with pytest.raises(MXNetError, match=match):
        fc.conv1x1_bn_act(x, w, s, t)


@pytest.mark.parametrize("M,K,N,sms,want", [
    (401408, 64, 64, 132, (64, 132)),      # stage 2, batch 128: 3136 tiles
    (1568, 512, 2048, 132, (256, 104)),    # stage 5, batch 32: 104 tiles
    (1000, 64, 64, 132, (64, 8)),          # ragged M
    (100, 64, 8, 132, (64, 1)),            # N = 8
    (6272, 2048, 512, 132, (256, 98)),     # s5_in: 98 tiles, not split
    (6272, 512, 2048, 132, (256, 132)),    # s5_expand: 392 tiles
    (25088, 1024, 256, 132, (256, 132)),   # s4_in: 196 tiles
    (100352, 512, 128, 132, (128, 132))])
def test_grid_choice(M, K, N, sms, want):
    """Tiles of 64 columns for N <= 64, 128 for N <= 128, else 256; one
    block per SM at most, never more blocks than tiles. K is not split at
    stage 5 (s5_in fills 98 of 132 SMs): a split measured slower."""
    assert fc._schedule(M, N, sms) == want


@pytest.mark.parametrize("M,K,N,want", [
    (401408, 64, 256, (128, 132)), (6272, 2048, 512, (128, 132))])
def test_grid_choice_for_f32_x(M, K, N, want):
    """f32 x (twice the bytes a ring buffer) keeps tiles of 128 columns."""
    assert fc._schedule(M, N, 132, x_is_bf16=False) == want


def test_schedule_obeys_the_kernels_rules():
    """Every schedule is one the C entry takes: a tile width of 64, 128 or
    256 columns and between 1 and min(tiles, SMs) blocks."""
    for M, N, sms, bf16 in itertools.product(
            (1, 127, 129, 1000, 6272, 25088), (8, 64, 136, 512, 2048),
            (1, 7, 132), (True, False)):
        block_n, blocks = fc._schedule(M, N, sms, bf16)
        assert block_n in ((64, 128, 256) if bf16 else (64, 128))
        assert block_n >= min(N, 256 if bf16 else 128)
        tiles = -(-M // 128) * -(-N // block_n)
        assert 1 <= blocks <= min(tiles, sms), (M, N, sms)


def test_workspace_sizes():
    """The zeroed workspace holds (blocks, 2, N) f32 moment rows and one
    ticket per column strip."""
    assert fc._workspace_sizes(512, 256, 132) == (132 * 2 * 512, 2)
    assert fc._workspace_sizes(64, 64, 8) == (8 * 2 * 64, 1)
    assert fc._workspace_sizes(24, 64, 1) == (2 * 24, 1)


def test_workspace_is_cached_zeroed_and_grows():
    """One zeroed int32 buffer per device and stream, reused while large
    enough and replaced by a larger zeroed one (the kernel leaves it
    zeroed); another stream gets its own."""
    dev = torch.device("cpu")
    keys = [(dev, 1), (dev, 2)]
    try:
        a = fc._workspace(dev, 1, 100)
        assert a.dtype == torch.int32 and a.numel() >= 100
        assert not a.any()
        assert fc._workspace(dev, 1, 50) is a
        other = fc._workspace(dev, 2, 50)
        assert other is not a and not other.any()
        b = fc._workspace(dev, 1, a.numel() + 1)
        assert b is not a and b.numel() > a.numel() and not b.any()
        assert fc._workspace(dev, 1, 10) is b
        assert fc._workspace(dev, 2, 10) is other
    finally:
        for k in keys:
            fc._ws.pop(k, None)
