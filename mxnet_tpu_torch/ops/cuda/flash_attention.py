"""Flash attention on the card: the port of
``mxnet_tpu/ops/pallas/flash_attention.py``.

Three hand-written CUDA kernels replace the Pallas kernels:

- K1, ``_attention_fwd_kernel`` reached through ``pl.pallas_call`` in
  ``_flash_fwd`` (``flash_attention.py:213``), is
  ``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``: a persistent block per
  SM walks 128-row q-tiles, a producer thread keeping a TMA ring of K/V
  tiles full and two consumer warpgroups running both products on
  ``wgmma`` with an online softmax in f32 registers. It reads q, k and v as
  strided views (the QKV projection's split output, in place) and writes
  ``out`` as (B, S, H, D) memory, returned as its (B, H, S, D) view.
- K2, ``_bwd_dq_kernel`` (``:403``), and K3, ``_bwd_dkv_kernel`` (``:421``),
  both launched by ``_pallas_bwd``, are
  ``mxnet_tpu_torch/csrc/flash_attention_bwd.cu``: one block per
  (batch*head, q-tile) for dq and one per (batch*head, k-tile) for dk/dv,
  each recomputing P from the forward's lse.

bf16 runs on the tensor cores (K1 ``wgmma``, K2 and K3 ``mma.sync``), f32
as true-fp32 scalar FMA.

Bounds on an H100: K1 at the BERT-base serving shape (32, 12, 512, 64) bf16
moves ~101.5 MB (~30 us at 3.35 TB/s) against 25.8 GFLOP (~26 us at 989
TFLOP/s); K2 and K3 at the training shape (64, 12, 128, 64) bf16 move ~64
and ~76 MB (~19 and ~23 us) against 4.8 and 6.4 GFLOP. All three are bound
by bytes. K1 overlaps its TMA loads with the products; K2 and K3 do not
yet. Times are in PERF.md.

Routing: :class:`FlashAttention` is the autograd function. On CPU tensors
both directions take the plain PyTorch versions
(:func:`flash_attention_fwd_reference`,
:func:`flash_attention_bwd_reference`); on CUDA tensors the forward is K1
and the backward K2 + K3 at every sequence length (the JAX package's
S <= 1024 dense backward is a TPU routing choice and is not copied), or
they raise. Nothing falls back, and nothing is copied quietly: K1 takes
any layout :func:`tma_strides` accepts and raises on others; the backward
makes its saved tensors contiguous, as K2 and K3 require. ``launches``,
``launches_dq`` and ``launches_dkv`` count the three kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ...base import MXNetError
from .. import _build

__all__ = ["FlashAttention", "bind_fwd", "flash_attention",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "tma_strides",
           "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_reference", "launches", "launches_dq",
           "launches_dkv"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}   # -> is_bf16 flag
_LIB_NAME = "flash_attention_fwd"
_SOURCES = ("flash_attention_fwd.cu",)
_BWD_LIB_NAME = "flash_attention_bwd"
_BWD_SOURCES = ("flash_attention_bwd.cu",)

#: kernel launches by :func:`flash_attention_fwd` (K1) in this process
launches = 0
#: kernel launches by :func:`flash_attention_bwd_dq` (K2)
launches_dq = 0
#: kernel launches by :func:`flash_attention_bwd_dkv` (K3)
launches_dkv = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib_fn = None
_bwd_lock = threading.Lock()
_bwd_fns = None


def bind_fwd(lib):
    """K1's C entry ``mxt_flash_attention_fwd`` in the loaded ``lib``, with
    its argument types: (views: 16 int64 = address and S, H, B byte strides
    of q, k, v and out; lse, B, H, S, D, is_bf16, sm_scale, causal,
    stream)."""
    fn = lib.mxt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel():
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            _lib_fn = bind_fwd(_build.load(_LIB_NAME, _SOURCES))
        return _lib_fn


def _bwd_kernels():
    """``(dq_fn, dkv_fn)``: the K2 and K3 entry points, built on first use
    (a library of its own, so K1's build is untouched)."""
    global _bwd_fns
    with _bwd_lock:
        if _bwd_fns is None:
            lib = _build.load(_BWD_LIB_NAME, _BWD_SOURCES)
            dq, dkv = (lib.mxt_flash_attention_bwd_dq,
                       lib.mxt_flash_attention_bwd_dkv)
            ints = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p]
            dq.argtypes = [ctypes.c_void_p] * 7 + ints
            dkv.argtypes = [ctypes.c_void_p] * 8 + ints
            dq.restype = dkv.restype = ctypes.c_int
            _bwd_fns = (dq, dkv)
        return _bwd_fns


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


def flash_attention_bwd_reference(q, k, v, out, lse, dout, sm_scale: float,
                                  causal: bool):
    """Plain PyTorch backward: ``(dq, dk, dv)`` for (B, H, S, D) inputs, the
    forward's ``out`` and (B, H, S) ``lse``, and the output gradient
    ``dout``, with the kernels' arithmetic (that of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``): delta = rowsum(dO * O) in f32, P = exp(S - lse)
    with masked scores at -1e30, P rounded to dO's dtype before P^T dO and
    dS = P (dP - delta) scale rounded to the input dtype before dS K and
    dS^T Q; every product summed in f32."""
    S = q.shape[2]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - lse.unsqueeze(-1))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tma_strides(x):
    """The (S, H, B) strides in bytes of a (B, H, S, D) view that K1 reads
    or writes in place: unit stride on D, every other stride a positive
    multiple of 16 bytes and a 16-byte-aligned address, which is what a TMA
    tensor map can address. A dimension of size 1 is never stepped along,
    so its stride is not checked and is given as 16. Raises MXNetError on
    any other layout: the wrapper never copies."""
    if x.data_ptr() % 16:
        raise MXNetError(f"flash_attention_fwd: the address must be 16-byte "
                         f"aligned, got {x.data_ptr():#x}")
    return _byte_strides(tuple(x.shape), x.stride(), x.element_size())


@functools.lru_cache(maxsize=256)
def _byte_strides(shape, stride, elt):
    """:func:`tma_strides` for one shape, strides and element size (a pure
    function, cached: a model hands K1 a few layouts over and over)."""
    if len(shape) != 4:
        raise MXNetError(f"flash_attention_fwd: expected a (B, H, S, D) view, "
                         f"got shape {shape}")
    if stride[3] != 1:
        raise MXNetError(f"flash_attention_fwd: the head dim must have unit "
                         f"stride, got strides {stride}")
    out = []
    for dim in (2, 1, 0):   # S, H, B
        nbytes = stride[dim] * elt
        if shape[dim] != 1 and (nbytes <= 0 or nbytes % 16):
            raise MXNetError(f"flash_attention_fwd: every stride but the head "
                             f"dim's must be a positive multiple of 16 bytes, "
                             f"got {stride} x {elt} bytes")
        out.append(nbytes if shape[dim] != 1 else 16)
    return tuple(out)


def _check(what, q, k, v, dout=None, lse=None, delta=None, strided=False):
    mats = [("q", q), ("k", k), ("v", v)]
    if dout is not None:
        mats.append(("dout", dout))
    for name, x in mats:   # is_cuda and get_device(): no device objects
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise MXNetError(f"{what}: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.get_device() != q.get_device():
            raise MXNetError(f"{what}: q, k, v on different "
                             f"devices ({q.device}, {x.device})")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise MXNetError(f"{what}: q, k, v must share one "
                             f"dtype in {sorted(map(str, _DTYPES))}, got "
                             f"{q.dtype}/{x.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise MXNetError(f"{what}: q, k, v must be "
                             f"(B, H, S, D) of one shape, got {tuple(x.shape)} "
                             f"vs {tuple(q.shape)}")
        if not strided and (not x.is_contiguous() or x.data_ptr() % 16):
            raise MXNetError(f"{what}: {name} must be contiguous "
                             "and 16-byte aligned")
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (
                not isinstance(x, torch.Tensor) or x.device != q.device
                or x.dtype != torch.float32 or x.shape != q.shape[:3]
                or not x.is_contiguous()):
            raise MXNetError(f"{what}: {name} must be a contiguous float32 "
                             f"(B, H, S) = {tuple(q.shape[:3])} tensor on "
                             f"{q.device}, got {getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))}")
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError(f"{what}: head dim {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(rc, what, q):
    if rc < 0:
        raise MXNetError(f"{what}: tensor-map encode failed with CUresult "
                         f"{-rc} at shape {tuple(q.shape)}, {q.dtype}")
    if rc != 0:
        raise MXNetError(f"{what}: kernel launch failed with CUDA error {rc} "
                         f"at shape {tuple(q.shape)}, {q.dtype}")


def flash_attention_fwd(q, k, v, sm_scale: float, causal: bool):
    """K1: ``(out, lse)`` for CUDA (B, H, S, D) views in bf16 or f32 with D
    in (32, 64, 128), each in a layout :func:`tma_strides` accepts (the
    split views of a QKV projection are read in place). ``out`` is a
    (B, H, S, D) view of (B, S, H, D) memory, so ``out.transpose(1, 2)``
    is contiguous; lse is (B, H, S) f32. Raises MXNetError on anything
    else, or when the tensor-map encode or the launch fails."""
    global launches
    _check("flash_attention_fwd", q, k, v, strided=True)
    B, H, S, D = q.shape
    out = torch.empty_strided((B, H, S, D), (S * H * D, D, H * D, 1),
                              dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return out, lse
    fn = _kernel()
    views = (ctypes.c_longlong * 16)(   # per tensor: address, S, H, B strides
        q.data_ptr(), *tma_strides(q), k.data_ptr(), *tma_strides(k),
        v.data_ptr(), *tma_strides(v), out.data_ptr(), *tma_strides(out))
    with torch.cuda.device(q.device):
        rc = fn(views, lse.data_ptr(), B, H, S, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                _stream(q))
    _raise_on(rc, "flash_attention_fwd", q)
    with _count_lock:
        launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, sm_scale: float,
                           causal: bool):
    """K2: dq for contiguous CUDA (B, H, S, D) q, k, v, dout (bf16 or f32,
    D in (32, 64, 128)) and (B, H, S) f32 ``lse`` (the forward's) and
    ``delta`` = rowsum(dout * out). Raises MXNetError on anything else, or
    when the launch is refused."""
    global launches_dq
    _check("flash_attention_bwd_dq", q, k, v, dout, lse, delta)
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    if B * H * S == 0:
        return dq
    fn = _bwd_kernels()[0]
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B * H, S, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                _stream(q))
    _raise_on(rc, "flash_attention_bwd_dq", q)
    with _count_lock:
        launches_dq += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, sm_scale: float,
                            causal: bool):
    """K3: ``(dk, dv)``, with the arguments and checks of
    :func:`flash_attention_bwd_dq`."""
    global launches_dkv
    _check("flash_attention_bwd_dkv", q, k, v, dout, lse, delta)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B * H * S == 0:
        return dk, dv
    fn = _bwd_kernels()[1]
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B * H, S, D, _DTYPES[q.dtype], float(sm_scale),
                int(bool(causal)), _stream(q))
    _raise_on(rc, "flash_attention_bwd_dkv", q)
    with _count_lock:
        launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, sm_scale: float,
                        causal: bool):
    """The backward on the card: ``(dq, dk, dv)`` from delta (a plain f32
    reduction, as the reference computes it outside its kernels), K2 and
    K3."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, sm_scale, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, sm_scale,
                                     causal)
    return dq, dk, dv


def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, sm_scale, causal)`` over (B, H, S, D)
    with Lq == Lk: the counterpart of the JAX package's ``_flash`` custom
    VJP (``flash_attention.py:511``). Forward K1 on the views as given,
    saving (q, k, v, out, lse); backward K2 + K3 on contiguous copies of
    the saved views. CPU tensors take the plain versions in both
    directions; CUDA tensors take the kernels or raise."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        if _on_cpu(q, k, v):
            out, lse = flash_attention_fwd_reference(q, k, v, sm_scale, causal)
        else:
            out, lse = flash_attention_fwd(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if _on_cpu(q, k, v):
            bwd = flash_attention_bwd_reference
        else:   # K2 and K3 take contiguous tensors
            bwd = flash_attention_bwd
            q, k, v, out = (x.contiguous() for x in (q, k, v, out))
        dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


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
    """Fused attention over (B, H, S, D), differentiable. Lq != Lk goes to
    the dense path; otherwise :class:`FlashAttention` (the plain versions
    for CPU tensors, the kernels for CUDA tensors, which raise on what they
    do not take)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[2] != k.shape[2]:
        return _dense_attention(q, k, v, float(sm_scale), bool(causal))
    return FlashAttention.apply(q, k, v, float(sm_scale), bool(causal))
