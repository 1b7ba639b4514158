"""Runtime-compiled kernels of the rtc slice, used as a user would use
``rtc.CudaModule``: the sources in ``mxnet_tpu_torch/csrc/rtc/`` are read as
text, compiled at run time, and launched on NDArrays.

For each kernel: its C signature (equal to the parameter list its source
declares), a launcher that picks the grid and launches it on a card's
arrays, and its plain PyTorch version (the kernel's arithmetic, which the
CPU tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card). :class:`GeluTanh` gives the GELU kernel pair a
gradient through ``autograd.Function``; on CPU arrays it takes the plain
versions. Nothing on the package's main path imports this module.
"""
from __future__ import annotations

import math
import threading
from pathlib import Path
from typing import Dict

import torch

from .. import autograd
from ..ndarray import NDArray
from ..rtc import CudaKernel, CudaModule

__all__ = ["CSRC_RTC", "SOURCES", "SIGNATURES", "module", "kernel",
           "axpy", "scale", "identity", "gelu_tanh_fwd", "gelu_tanh_bwd",
           "log_softmax", "axpy_plain", "scale_plain", "identity_plain",
           "gelu_tanh_plain", "gelu_tanh_grad_plain", "log_softmax_plain",
           "GeluTanh"]

CSRC_RTC = Path(__file__).resolve().parents[1] / "csrc" / "rtc"
#: kernel name -> the source file (under csrc/rtc/) that defines it
SOURCES = {"axpy": "elementwise.cu", "scale": "elementwise.cu",
           "k": "elementwise.cu", "gelu_tanh_fwd": "gelu_tanh.cu",
           "gelu_tanh_bwd": "gelu_tanh.cu", "log_softmax": "log_softmax.cu"}
SIGNATURES = {
    "axpy": "const float *x, const float *y, int n, float *o",
    "scale": "const float *x, int n, float *o",
    "k": "const float *x, int n, float *o",
    "gelu_tanh_fwd": "const __nv_bfloat16 *x, int n, __nv_bfloat16 *y",
    "gelu_tanh_bwd": "const __nv_bfloat16 *x, const __nv_bfloat16 *dy, "
                     "int n, __nv_bfloat16 *dx",
    "log_softmax": "const __nv_bfloat16 *x, int rows, int cols, "
                   "__nv_bfloat16 *y",
}
_THREADS = 256           # elementwise kernels: threads a block
_ROW_THREADS = 128       # log_softmax: threads a block, one block a row

_lock = threading.Lock()
_modules: Dict[str, CudaModule] = {}
_kernels: Dict[str, CudaKernel] = {}


def module(source: str) -> CudaModule:
    """The CudaModule of ``csrc/rtc/<source>``, compiled on first use."""
    mod = _modules.get(source)
    if mod is None:
        mod = CudaModule((CSRC_RTC / source).read_text())
        with _lock:
            mod = _modules.setdefault(source, mod)
    return mod


def kernel(name: str) -> CudaKernel:
    k = _kernels.get(name)
    if k is None:
        k = module(SOURCES[name]).get_kernel(name, SIGNATURES[name])
        with _lock:
            k = _kernels.setdefault(name, k)
    return k


def _grid(x: NDArray, per_thread: int = 1) -> tuple:
    """One thread for every ``per_thread`` values (the kernels' grid-stride
    loops then run once): a grid capped at 8 blocks an SM left each thread
    one load in flight at a time and trailed PyTorch's elementwise kernels
    on the device."""
    return (max(1, math.ceil(x.size / per_thread / _THREADS)), 1, 1)


def axpy(x: NDArray, y: NDArray) -> NDArray:
    """o = 2x + y (f32) on the card, 4 values a thread."""
    return kernel("axpy").launch([x, y, x.size], grid_dims=_grid(x, 4),
                                 block_dims=(_THREADS, 1, 1),
                                 out_shapes=[x.shape])


def scale(x: NDArray) -> NDArray:
    """o = 3x (f32) on the card."""
    return kernel("scale").launch([x, x.size], grid_dims=_grid(x),
                                  block_dims=(_THREADS, 1, 1),
                                  out_shapes=[x.shape])


def identity(x: NDArray) -> NDArray:
    """o = x (f32) on the card, the reference's kernel ``k``."""
    return kernel("k").launch([x, x.size], grid_dims=_grid(x),
                              block_dims=(_THREADS, 1, 1),
                              out_shapes=[x.shape])


def gelu_tanh_fwd(x: NDArray) -> NDArray:
    """The tanh GELU of a bf16 array on the card."""
    return kernel("gelu_tanh_fwd").launch(
        [x, x.size], grid_dims=_grid(x, 8), block_dims=(_THREADS, 1, 1),
        out_shapes=[x.shape])


def gelu_tanh_bwd(x: NDArray, dy: NDArray) -> NDArray:
    """dx = dy * gelu'(x), bf16, on the card."""
    dy = NDArray(dy.data.contiguous())
    return kernel("gelu_tanh_bwd").launch(
        [x, dy, x.size], grid_dims=_grid(x, 8), block_dims=(_THREADS, 1, 1),
        out_shapes=[x.shape])


def log_softmax(x: NDArray) -> NDArray:
    """Log-softmax over the last axis of a 2-D bf16 array on the card, one
    128-thread block a row, two passes over the row (online max and sum,
    then the output), no dynamic shared memory."""
    rows, cols = x.shape
    return kernel("log_softmax").launch(
        [x, rows, cols], grid_dims=(max(1, rows), 1, 1),
        block_dims=(_ROW_THREADS, 1, 1), out_shapes=[x.shape])


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in PyTorch
# ---------------------------------------------------------------------------
_K_BETA = math.sqrt(2.0 / math.pi)
_K_KAPPA = 0.044715


def axpy_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 2.0 * x + y


def scale_plain(x: torch.Tensor) -> torch.Tensor:
    return 3.0 * x


def identity_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def gelu_tanh_plain(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) in f32, rounded to
    x's dtype."""
    f = x.float()
    inner = _K_BETA * (f + _K_KAPPA * (f * f * f))
    return (0.5 * f * (1.0 + torch.tanh(inner))).to(x.dtype)


def gelu_tanh_grad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dy * gelu'(x) in f32, rounded to x's dtype."""
    f, g = x.float(), dy.float()
    x_sq = f * f
    t = torch.tanh(_K_BETA * (f + _K_KAPPA * (x_sq * f)))
    left_derivative = 0.5 * (1.0 + t)
    right_derivative = 0.5 * f * (1.0 - t * t) * (
        _K_BETA * (1.0 + 3.0 * _K_KAPPA * x_sq))
    return (g * (left_derivative + right_derivative)).to(x.dtype)


def log_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """(x - max) - log(sum(exp(x - max))) over the last axis in f32,
    rounded to x's dtype."""
    f = x.float()
    shifted = f - f.amax(dim=-1, keepdim=True)
    return (shifted - shifted.exp().sum(dim=-1, keepdim=True).log()) \
        .to(x.dtype)


class GeluTanh(autograd.Function):
    """The tanh GELU with a gradient: on the card, ``gelu_tanh_fwd`` in the
    forward and ``gelu_tanh_bwd`` in the backward (two launches a step);
    on CPU arrays, the plain versions."""

    def forward(self, x: NDArray) -> NDArray:
        self.save_for_backward(x)
        if x.context.device_type == "cpu":
            return NDArray(gelu_tanh_plain(x.data))
        return gelu_tanh_fwd(x)

    def backward(self, dy: NDArray) -> NDArray:
        (x,) = self.saved_tensors
        if x.context.device_type == "cpu":
            return NDArray(gelu_tanh_grad_plain(x.data, dy.data))
        return gelu_tanh_bwd(x, dy)
