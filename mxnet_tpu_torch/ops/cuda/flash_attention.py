"""Flash-attention forward on the card: the port of
``mxnet_tpu/ops/pallas/flash_attention.py``.

Replaces the Pallas kernel ``_attention_fwd_kernel`` reached through
``pl.pallas_call`` in ``_flash_fwd`` (``flash_attention.py:213``). The
kernel itself is ``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``: one thread
block per (batch*head, q-tile) walking the K/V tiles through shared
memory with an online softmax in f32 registers; bf16 runs on the tensor
cores (``mma.sync``), f32 runs as true-fp32 scalar FMA.

Bound on an H100 at the BERT-base serving shape (32, 12, 512, 64) in bf16:
q, k, v, o (25.2 MB each) plus the f32 lse (0.8 MB) is ~101.5 MB, ~30 us at
3.35 TB/s; 4*B*H*S^2*D = 25.8 GFLOP is ~26 us at 989 TFLOP/s. The kernel is
bound by bytes. Its design keeps the (S x S) scores out of device memory
entirely (each input read once per q-tile, mostly from L2); it does not yet
overlap tile loads with the products or use wgmma/TMA. Times are in PERF.md.

Routing: a CPU tensor takes :func:`flash_attention_fwd_reference`, the plain
PyTorch version; a CUDA tensor takes the kernel or raises. Nothing falls
back. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ...base import MXNetError
from .. import _build

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_reference", "launches"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}   # -> is_bf16 flag
_LIB_NAME = "flash_attention_fwd"
_SOURCES = ("flash_attention_fwd.cu",)

#: kernel launches by :func:`flash_attention_fwd` in this process
launches = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib_fn = None


def _kernel():
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            fn = _build.load(_LIB_NAME, _SOURCES).mxt_flash_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib_fn = fn
        return _lib_fn


def flash_attention_fwd_reference(q, k, v, sm_scale: float, causal: bool):
    """Plain PyTorch forward: ``(out, lse)`` for (B, H, S, D) inputs, the
    arithmetic the kernel does. Scores and softmax in f32 (bf16 inputs give
    exact bf16 products summed in f32); P is rounded to v's dtype before
    P.V; masked scores take -1e30 and l is clamped at 1e-30. Causal masks
    are bottom-right aligned, which is plain ``tril`` when Lq == Lk."""
    S, Sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        keep = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def _check(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise MXNetError(f"flash_attention_fwd: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.device != q.device:
            raise MXNetError("flash_attention_fwd: q, k, v on different "
                             f"devices ({q.device}, {x.device})")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise MXNetError("flash_attention_fwd: q, k, v must share one "
                             f"dtype in {sorted(map(str, _DTYPES))}, got "
                             f"{q.dtype}/{x.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise MXNetError("flash_attention_fwd: q, k, v must be "
                             f"(B, H, S, D) of one shape, got {tuple(x.shape)} "
                             f"vs {tuple(q.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise MXNetError(f"flash_attention_fwd: {name} must be contiguous "
                             "and 16-byte aligned")
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError(f"flash_attention_fwd: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")


def flash_attention_fwd(q, k, v, sm_scale: float, causal: bool):
    """The kernel: ``(out, lse)`` for contiguous CUDA (B, H, S, D) tensors
    in bf16 or f32 with D in (32, 64, 128); lse is (B, H, S) f32. Raises
    MXNetError on anything else, or when the launch is refused."""
    global launches
    _check(q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return out, lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B * H, S, D, _DTYPES[q.dtype],
                float(sm_scale), int(bool(causal)), stream)
    if rc != 0:
        raise MXNetError(f"flash_attention_fwd: kernel launch failed with "
                         f"CUDA error {rc} at shape {tuple(q.shape)}, "
                         f"{q.dtype}")
    with _count_lock:
        launches += 1
    return out, lse


def _dense_attention(q, k, v, sm_scale: float, causal: bool):
    """Dense SDPA for Lq != Lk: a copy of the JAX package's
    ``_dense_attention``, with its bottom-right causal convention (query
    row i sees keys j <= i + (Lk - Lq); the last query row sees every
    key)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        S, Sk = q.shape[2], k.shape[2]
        keep = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False, sm_scale=None):
    """Fused attention over (B, H, S, D). Lq != Lk goes to the dense path;
    otherwise a CPU tensor takes the plain version and a CUDA tensor the
    kernel (which raises on what it does not take)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[2] != k.shape[2]:
        return _dense_attention(q, k, v, float(sm_scale), bool(causal))
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, float(sm_scale),
                                             bool(causal))[0]
    return flash_attention_fwd(q, k, v, float(sm_scale), bool(causal))[0]
