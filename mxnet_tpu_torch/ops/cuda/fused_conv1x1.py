"""Fused 1x1 convolution + BatchNorm on the card: the port of
``mxnet_tpu/ops/pallas/fused_conv1x1.py``.

K4, ``_fused_kernel`` reached through ``pl.pallas_call`` in
``conv1x1_bn_act`` (``fused_conv1x1.py:84``), is
``mxnet_tpu_torch/csrc/fused_conv1x1.cu``: for x (M, K) and w (K, N) it
computes y = relu(x * scale + shift) @ w with the affine and the ReLU in
f32 on the way into shared memory, the product in bf16 on the tensor cores
with f32 accumulation, y written in bf16, and the per-column sum and sum of
squares of the f32 y (the next BatchNorm's moments) reduced without float
atomics in a fixed order. It takes any M: the ragged last tile is masked
out of the moments, which the Pallas kernel does not do (it sums every row
of its last tile, so its moments are wrong unless ``block_m`` divides M).

Bound on an H100: bytes at ResNet-50's stage 2-4 shapes (x read and y
written once), operations at stage 5. Times are in PERF.md.

Routing: CPU tensors take the plain version
(:func:`conv1x1_bn_act_reference`); CUDA tensors take the kernel or raise.
Nothing falls back. ``launches`` counts the kernel's launches. The reference
has no backward for this op (a bare ``pallas_call``), so neither has the
port.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ...base import MXNetError
from .. import _build

__all__ = ["conv1x1_bn_act", "conv1x1_bn_act_reference", "launches"]

_LIB_NAME = "fused_conv1x1"
_SOURCES = ("fused_conv1x1.cu",)
_X_DTYPES = {torch.bfloat16: 1, torch.float32: 0}   # -> x_is_bf16 flag
_BLOCK_M = 128                                     # rows of an output tile

#: kernel launches by :func:`conv1x1_bn_act` on CUDA tensors in this process
launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib_fn = None


def _kernel():
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            fn = _build.load(_LIB_NAME, _SOURCES).mxt_conv1x1_bn_act
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib_fn = fn
        return _lib_fn


def conv1x1_bn_act_reference(x, w, scale, shift, *, relu: bool = True):
    """Plain PyTorch version: ``(y bf16, col_sum f32, col_sumsq f32)`` with
    the reference's arithmetic (``conv1x1_bn_act_reference``,
    ``fused_conv1x1.py:109``): f32 affine and ReLU, rounded to bf16; a
    product of bf16 values summed in f32; the moments of the f32 y."""
    xh = x.float() * scale.float() + shift.float()
    if relu:
        xh = torch.relu(xh)
    y = torch.matmul(xh.to(torch.bfloat16).float(),
                     w.to(torch.bfloat16).float())
    return y.to(torch.bfloat16), y.sum(dim=0), (y * y).sum(dim=0)


def _grid(M: int, N: int, sms: int):
    """``(block_n, grid_m)``: 64-column tiles for N <= 64, else 128; and
    the number of blocks along M, each walking every grid_m-th 128-row
    tile, chosen so that about two blocks per SM are in flight (fewer
    partial rows to reduce than one block per tile)."""
    block_n = 64 if N <= 64 else 128
    n_tiles = -(-N // block_n)
    m_tiles = -(-M // _BLOCK_M)
    return block_n, max(1, min(m_tiles, -(-2 * sms // n_tiles)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv1x1_bn_act(x, w, scale, shift, *, relu: bool = True):
    """``(y, col_sum, col_sumsq)`` for y = relu(x * scale + shift) @ w:
    x (M, K) bf16 or f32, w (K, N) (cast to bf16), scale and shift (K,)
    (cast to f32). y is (M, N) bf16; the moments are the column sums of y
    and y^2 taken in f32 before rounding. CPU tensors take
    :func:`conv1x1_bn_act_reference`; CUDA tensors take K4, which needs K
    and N to be multiples of 8, and raise MXNetError on anything else or
    when the launch is refused."""
    global launches
    xs = (x, w, scale, shift)
    if all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
           for a in xs):
        return conv1x1_bn_act_reference(x, w, scale, shift, relu=relu)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError(f"conv1x1_bn_act: x (M, K) and w (K, N) expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if tuple(scale.shape) != (K,) or tuple(shift.shape) != (K,):
        raise MXNetError(f"conv1x1_bn_act: scale and shift must be ({K},), "
                         f"got {tuple(scale.shape)}, {tuple(shift.shape)}")
    if x.dtype not in _X_DTYPES:
        raise MXNetError(f"conv1x1_bn_act: x must be bfloat16 or float32, "
                         f"got {x.dtype}")
    if K % 8 or N % 8:
        raise MXNetError(f"conv1x1_bn_act: K = {K} and N = {N} must be "
                         "multiples of 8 (16-byte rows)")
    for name, a in zip(("x", "w", "scale", "shift"), xs):
        if a.device.type != "cuda" or a.device != x.device:
            raise MXNetError(f"conv1x1_bn_act: {name} must be a CUDA tensor "
                             f"on {x.device}, got {a.device}")
    dev = x.device
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return (y, torch.zeros(N, device=dev), torch.zeros(N, device=dev))
    col_sum = torch.empty(N, dtype=torch.float32, device=dev)
    col_sumsq = torch.empty(N, dtype=torch.float32, device=dev)
    x = _aligned(x)
    w = _aligned(w.to(torch.bfloat16))
    scale = _aligned(scale.to(torch.float32))
    shift = _aligned(shift.to(torch.float32))
    block_n, grid_m = _grid(
        M, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((2, grid_m, N), dtype=torch.float32, device=dev)
    counter = torch.zeros(-(-N // block_n), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), y.data_ptr(), col_sum.data_ptr(),
                col_sumsq.data_ptr(), partial.data_ptr(), counter.data_ptr(),
                M, K, N, _X_DTYPES[x.dtype], int(bool(relu)), block_n,
                grid_m, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise MXNetError(f"conv1x1_bn_act: kernel launch failed with CUDA "
                         f"error {rc} at M={M}, K={K}, N={N}, {x.dtype}")
    with _count_lock:
        launches += 1
    return y, col_sum, col_sumsq
