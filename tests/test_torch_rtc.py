"""The rtc slice (mxnet_tpu_torch.rtc, its NVRTC bindings and the kernels
of csrc/rtc/) on the CPU, where there is neither a card nor NVRTC.

The chain kernel == plain version == JAX package is closed in two halves:
here each kernel's plain version (tools/rtc_examples.py) is held against
the JAX package on the same inputs, and chip_smoke.py (phase 6) holds each
kernel against its plain version on the card. Tolerances: the reference's
runtime kernels (axpy, scale, k), run by the JAX ``PallasModule`` in
interpret mode as tests/test_library.py runs them, bitwise (2x and 3x are
exact or one rounding); the GELU, its gradient and the log-softmax in f32
within 1e-6 relative (1e-5 for the gradient and the log-softmax, whose
row sums run in another order), since XLA's tanh/exp/log and PyTorch's
round differently in the last bits; the log-softmax of bf16 logits within
one bf16 ulp of each value (both compute in f32 and round once).

Also here: the signature parser against every parameter list that
csrc/rtc/*.cu declares, the launch's argument checks on meta tensors, and
that a CudaModule or a launch on CPU arrays raises MXNetError instead of
falling back.
"""
import re

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import rtc as jax_rtc
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, rtc
from mxnet_tpu_torch.ops import _nvrtc
from mxnet_tpu_torch.tools import rtc_examples as rx

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

META = torch.device("meta")


def _f32(seed, *shape, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale).astype(
        onp.float32)


# ---------------------------------------------------------------------------
# plain versions against the JAX package
# ---------------------------------------------------------------------------
def test_reference_kernels_match_the_pallas_module():
    """axpy, scale and k of tests/test_library.py:123-146, compiled by the
    JAX PallasModule and run in interpret mode, equal the port's plain
    versions bitwise."""
    mod = jax_rtc.PallasModule("""
def axpy(x_ref, y_ref, o_ref):
    o_ref[...] = 2.0 * x_ref[...] + y_ref[...]

def scale(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 3.0

def k(x_ref, o_ref):
    o_ref[...] = x_ref[...]
""")
    for x, y in ((onp.arange(8, dtype=onp.float32), onp.ones(8, "float32")),
                 (_f32(0, 1000), _f32(1, 1000))):
        jx, jy = mx.nd.array(x), mx.nd.array(y)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        got = {"axpy": mod.get_kernel("axpy").launch(
                   [jx, jy], out_shapes=[x.shape]),
               "scale": mod.get_kernel("scale").launch(
                   [jx], out_shapes=[x.shape]),
               "k": mod.get_kernel("k").launch([jx], out_shapes=[x.shape])}
        plain = {"axpy": rx.axpy_plain(tx, ty), "scale": rx.scale_plain(tx),
                 "k": rx.identity_plain(tx)}
        for name, out in got.items():
            onp.testing.assert_array_equal(plain[name].numpy(),
                                           out.asnumpy(), err_msg=name)


def test_gelu_plain_matches_the_jax_package():
    x = _f32(2, 64, 96, scale=3.0)
    dy = _f32(3, 64, 96)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = mx.nd.gelu_tanh(jx)
    jy.backward(mx.nd.array(dy))
    tx = torch.from_numpy(x)
    onp.testing.assert_allclose(rx.gelu_tanh_plain(tx).numpy(), jy.asnumpy(),
                                rtol=1e-6, atol=1e-6)
    onp.testing.assert_allclose(
        rx.gelu_tanh_grad_plain(tx, torch.from_numpy(dy)).numpy(),
        jx.grad.asnumpy(), rtol=1e-5, atol=1e-5)


def test_gelu_function_matches_jax_autograd():
    """GeluTanh (an autograd.Function; on CPU arrays its plain versions)
    under the port's autograd against the JAX package's gelu_tanh under
    its autograd: y and x.grad of loss = (y * w).sum()."""
    x, w = _f32(4, 32, 48, scale=2.0), _f32(5, 32, 48)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = mx.nd.gelu_tanh(jx)
        (jy * mx.nd.array(w)).sum().backward()
    px = mt.nd.array(x, ctx=mt.cpu())
    px.attach_grad()
    with mt.autograd.record():
        py = rx.GeluTanh()(px)
        loss = (py * mt.nd.array(w, ctx=mt.cpu())).sum()
    loss.backward()
    assert py.context == mt.cpu() and py.dtype == onp.float32
    onp.testing.assert_allclose(py.asnumpy(), jy.asnumpy(), rtol=1e-6,
                                atol=1e-6)
    onp.testing.assert_allclose(px.grad.asnumpy(), jx.grad.asnumpy(),
                                rtol=1e-5, atol=1e-5)


def test_log_softmax_plain_matches_the_jax_package():
    x = _f32(6, 19, 3000, scale=4.0)
    onp.testing.assert_allclose(
        rx.log_softmax_plain(torch.from_numpy(x)).numpy(),
        mx.nd.log_softmax(mx.nd.array(x), axis=-1).asnumpy(),
        rtol=1e-5, atol=1e-5)
    # bf16 logits: both compute in f32 and round once to bf16
    jb = mx.nd.array(x).astype("bfloat16")
    ref = mx.nd.log_softmax(jb, axis=-1)
    assert str(ref.dtype) == "bfloat16"
    got = rx.log_softmax_plain(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(onp.asarray(ref.asnumpy(), onp.float32))
    _, e = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    assert ((got.float() - want).abs() <= ulp).all()


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------
_DECL = re.compile(r'extern "C" __global__ void '
                   r'(?:__launch_bounds__\(\d+\) )?(\w+)\(([^)]*)\)')


def _declared():
    out = {}
    for path in sorted(rx.CSRC_RTC.glob("*.cu")):
        for name, params in _DECL.findall(path.read_text()):
            out[name] = (path.name, " ".join(params.split()))
    return out


@pytest.mark.parametrize("name", sorted(rx.SIGNATURES))
def test_signature_equals_the_declaration(name):
    declared = _declared()
    assert name in declared, name
    source, params = declared[name]
    assert rx.SOURCES[name] == source
    assert rtc.parse_signature(params) == rtc.parse_signature(
        rx.SIGNATURES[name])
    assert params == rx.SIGNATURES[name]


def test_every_declared_kernel_has_a_signature():
    assert set(_declared()) == set(rx.SIGNATURES)


def test_parse_signature():
    P = rtc.Param
    assert rtc.parse_signature(
        "const float *x, const float *y, int n, float *o") == [
        P("x", "float", True), P("y", "float", True), P("n", "int", False),
        P("o", "float", True)]
    assert rtc.parse_signature(
        "const __nv_bfloat16* __restrict__ a, int64_t n, double s, "
        "uint8_t *m, __half h, int32_t k") == [
        P("a", "__nv_bfloat16", True), P("n", "int64_t", False),
        P("s", "double", False), P("m", "uint8_t", True),
        P("h", "__half", False), P("k", "int32_t", False)]
    for bad in ("float **x", "long n", "float", "const float *x,", ""):
        with pytest.raises(MXNetError):
            rtc.parse_signature(bad)


# ---------------------------------------------------------------------------
# argument checks (meta tensors stand in for the card's)
# ---------------------------------------------------------------------------
def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_check_args_marshals_a_good_launch():
    params = rtc.parse_signature(rx.SIGNATURES["log_softmax"])
    x, y = _meta((4, 6), torch.bfloat16), _meta((4, 6), torch.bfloat16)
    vals = rtc.check_args(params, [x, 4, 6, y], META)
    assert [type(v).__name__ for v in vals] == [
        "c_void_p", "c_int", "c_int", "c_void_p"]
    assert [v.value for v in vals[1:3]] == [4, 6]
    half = rtc.check_args(rtc.parse_signature("__half a, __nv_bfloat16 b, "
                                               "int64_t n, uint8_t u"),
                          [1.5, 1.0, 2 ** 40, 255], META)
    assert [v.value for v in half] == [0x3E00, 0x3F80, 2 ** 40, 255]


@pytest.mark.parametrize("args, match", [
    ("dtype", "must be float32"), ("device", "lies on"),
    ("contiguous", "not contiguous"), ("count", "takes 4 arguments"),
    ("float_for_int", "must be a Python int"), ("bool", "Python int"),
    ("range", "out of range"), ("scalar_for_pointer", "must be an NDArray"),
    ("string_for_float", "Python number")])
def test_check_args_refuses(args, match):
    params = rtc.parse_signature(rx.SIGNATURES["axpy"])
    x, y, o = _meta((8,)), _meta((8,)), _meta((8,))
    bad = {"dtype": [x.half(), y, 8, o], "device": [x, torch.empty(8), 8, o],
           "contiguous": [_meta((8, 2))[:, 0], y, 8, o],
           "count": [x, y, 8], "float_for_int": [x, y, 8.0, o],
           "bool": [x, y, True, o], "range": [x, y, 2 ** 31, o],
           "scalar_for_pointer": [x, 1.0, 8, o]}
    if args == "string_for_float":
        with pytest.raises(MXNetError, match=match):
            rtc.check_args(rtc.parse_signature("float a"), ["1"], META)
        return
    with pytest.raises(MXNetError, match=match):
        rtc.check_args(params, bad[args], META)


# ---------------------------------------------------------------------------
# no fallback on the CPU
# ---------------------------------------------------------------------------
def test_launch_on_cpu_arrays_raises():
    k = rtc.CudaKernel(None, "axpy", "axpy", rx.SIGNATURES["axpy"])
    x = mt.nd.array(onp.arange(8, dtype=onp.float32), ctx=mt.cpu())
    y = mt.nd.ones((8,), ctx=mt.cpu())
    before = rtc.launches
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, y, 8], out_shapes=[(8,)])
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, y, 8, mt.nd.zeros((8,), ctx=mt.cpu())])
    with pytest.raises(MXNetError):
        rx.axpy(x, y)
    assert rtc.launches == before and k.launches == 0


def test_cuda_module_raises_without_nvrtc():
    if _nvrtc.cuda_home() is not None:
        pytest.skip("this host has NVRTC; the card's run compiles modules")
    with pytest.raises(MXNetError, match="NVRTC not found"):
        rtc.CudaModule('extern "C" __global__ void k(float *x) {}')
    with pytest.raises(MXNetError, match="NVRTC not found"):
        rx.module("elementwise.cu")
