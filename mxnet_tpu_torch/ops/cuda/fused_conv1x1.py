"""Fused 1x1 convolution + BatchNorm on the card: the port of
``mxnet_tpu/ops/pallas/fused_conv1x1.py``.

K4, ``_fused_kernel`` reached through ``pl.pallas_call`` in
``conv1x1_bn_act`` (``fused_conv1x1.py:84``), is
``mxnet_tpu_torch/csrc/fused_conv1x1.cu``: for x (M, K) and w (K, N) it
computes y = relu(x * scale + shift) @ w with the affine and the ReLU in
f32 registers (the prologue, applied to each x fragment on its way into
the tensor cores), the product in bf16 on wgmma with f32 accumulation, y
written in bf16 by TMA, and the per-column sum and sum of squares of the
f32 y (the next BatchNorm's moments) reduced without float atomics in a
fixed order. It takes any M: the ragged last tile is masked out of the
moments, which the Pallas kernel does not do (it sums every row of its
last tile, so its moments are wrong unless ``block_m`` divides M).

The kernel is persistent: at most one block per SM walks 128-row x
``block_n``-column output tiles. :func:`_schedule` picks the tile width
and the grid from the shape and the SM count.

Bound on an H100: bytes at ResNet-50's stage 2-4 shapes (x read and y
written once), operations at stage 5. Times are in PERF.md.

Routing: CPU tensors take the plain version
(:func:`conv1x1_bn_act_reference`); CUDA tensors take the kernel or raise.
Nothing falls back. ``launches`` counts the kernel's launches. The reference
has no backward for this op (a bare ``pallas_call``), so neither has the
port.

The kernel's moment workspace and its tickets live in one zeroed int32
buffer per device and stream (:func:`_workspace`), which the kernel leaves
zeroed, so no fill runs per call and calls on two streams never share it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

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
_ws_lock = threading.Lock()
_ws: Dict[tuple, torch.Tensor] = {}
_sm_counts: Dict[torch.device, int] = {}


def bind(lib: ctypes.CDLL):
    """The C entry ``mxt_conv1x1_bn_act`` of a loaded library, typed (the
    port's own, or a variant of its source that a tool builds)."""
    fn = lib.mxt_conv1x1_bn_act
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            _lib_fn = bind(_build.load(_LIB_NAME, _SOURCES))
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


def _schedule(M: int, N: int, sms: int, x_is_bf16: bool = True):
    """``(block_n, blocks)`` for one call: 64-column tiles for N <= 64, 128
    for N <= 128 (and for f32 x, whose ring buffers are twice as large),
    else 256; ``blocks``, the persistent grid, one per SM at most. Where the
    tiles are fewer than the SMs (ResNet-50's stage 5) the card is not
    filled: narrower tiles or a split of K filled it and measured slower
    on an H100 (PERF.md)."""
    block_n = 64 if N <= 64 else 128 if N <= 128 or not x_is_bf16 else 256
    tiles = -(-M // _BLOCK_M) * -(-N // block_n)
    return block_n, min(tiles, sms)


def _workspace_sizes(N: int, block_n: int, blocks: int):
    """Sizes, in 4-byte words, of the zeroed workspace's two parts: the
    blocks' moment rows (blocks, 2, N) f32 and one ticket per column strip,
    int32."""
    return blocks * 2 * N, -(-N // block_n)


def _workspace(device: torch.device, stream: int,
               words: int) -> torch.Tensor:
    """The zeroed int32 workspace of ``device`` and ``stream`` (a stream
    handle), at least ``words`` long. The kernel leaves it zeroed, so it is
    allocated (and filled) only when it grows."""
    with _ws_lock:
        buf = _ws.get((device, stream))
        if buf is None or buf.numel() < words:
            buf = torch.zeros(max(words, 1 << 16), dtype=torch.int32,
                              device=device)
            _ws[(device, stream)] = buf
        return buf


def _sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = n
    return n


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(x, w, scale, shift, relu, block_n, blocks, fn=None):
    """One launch on checked, aligned CUDA inputs with the given schedule
    (and C entry ``fn``, default the port's); returns ``(y, col_sum,
    col_sumsq)``. Uncounted: :func:`conv1x1_bn_act` counts its launches,
    and tools call this to time other schedules and builds."""
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    col_sum = torch.empty(N, dtype=torch.float32, device=dev)
    col_sumsq = torch.empty(N, dtype=torch.float32, device=dev)
    slots, tickets = _workspace_sizes(N, block_n, blocks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    base = _workspace(dev, stream, slots + tickets).data_ptr()
    fn = fn or _kernel()
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), y.data_ptr(), col_sum.data_ptr(),
                col_sumsq.data_ptr(), base, base + 4 * slots, M, K, N,
                _X_DTYPES[x.dtype], int(bool(relu)), block_n, blocks,
                stream)
    if rc != 0:
        what = (f"tensor-map encode failed with CUresult {-rc}" if rc < 0
                else f"kernel launch failed with CUDA error {rc}")
        raise MXNetError(f"conv1x1_bn_act: {what} at M={M}, K={K}, N={N}, "
                         f"{x.dtype}, block_n={block_n}, blocks={blocks}")
    return y, col_sum, col_sumsq


def _checked(x, w, scale, shift):
    """The kernel's inputs, checked and made contiguous and 16-byte
    aligned (w as bf16, scale and shift as f32); raises MXNetError on
    anything the kernel does not take."""
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
    for name, a in zip(("x", "w", "scale", "shift"), (x, w, scale, shift)):
        if a.device.type != "cuda" or a.device != x.device:
            raise MXNetError(f"conv1x1_bn_act: {name} must be a CUDA tensor "
                             f"on {x.device}, got {a.device}")
    return (_aligned(x), _aligned(w.to(torch.bfloat16)),
            _aligned(scale.to(torch.float32)),
            _aligned(shift.to(torch.float32)))


def conv1x1_bn_act(x, w, scale, shift, *, relu: bool = True):
    """``(y, col_sum, col_sumsq)`` for y = relu(x * scale + shift) @ w:
    x (M, K) bf16 or f32, w (K, N) (cast to bf16), scale and shift (K,)
    (cast to f32). y is (M, N) bf16; the moments are the column sums of y
    and y^2 taken in f32 before rounding. CPU tensors take
    :func:`conv1x1_bn_act_reference`; CUDA tensors take K4, which needs K
    and N to be multiples of 8, and raise MXNetError on anything else or
    when the launch is refused."""
    global launches
    if all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
           for a in (x, w, scale, shift)):
        return conv1x1_bn_act_reference(x, w, scale, shift, relu=relu)
    x, w, scale, shift = _checked(x, w, scale, shift)
    M, K = x.shape
    N = w.shape[1]
    if M == 0:
        dev = x.device
        return (torch.empty((0, N), dtype=torch.bfloat16, device=dev),
                torch.zeros(N, device=dev), torch.zeros(N, device=dev))
    out = _run(x, w, scale, shift, relu,
               *_schedule(M, N, _sm_count(x.device),
                          x.dtype == torch.bfloat16))
    with _count_lock:
        launches += 1
    return out
