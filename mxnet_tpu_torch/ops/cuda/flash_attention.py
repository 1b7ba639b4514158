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
  ``mxnet_tpu_torch/csrc/flash_attention_bwd.cu``, K1's design turned
  around: persistent blocks walk 128-row work units (q-tiles for dq,
  k-tiles for dk/dv), a producer thread keeps TMA loads in flight and two
  consumer warpgroups recompute P from the forward's lse and run every
  product on ``wgmma``. K2 also computes delta = rowsum(dO * O) and writes
  it for K3, which runs after it on the same stream.

bf16 and fp16 run on the tensor cores (one kernel template, instantiated
for each), f32 as true-fp32 scalar FMA. Every kernel
reads its (B, H, S, D) inputs in place as strided views and writes its
outputs as (B, S, H, D) memory, returned as (B, H, S, D) views.

Bounds on an H100: K1 at the BERT-base serving shape (32, 12, 512, 64) bf16
moves ~101.5 MB (~30 us at 3.35 TB/s) against 25.8 GFLOP (~26 us at 989
TFLOP/s); K2 and K3 at the training shape (64, 12, 128, 64) bf16 move ~76
MB each (~23 us) against 4.8 and 6.4 GFLOP. All three are bound by bytes;
fp16 moves the same bytes at the same peak rate.
Times are in PERF.md.

Routing: :func:`flash_attention` sends Lq != Lk, and a head dim outside
(32, 64, 128), to the dense path on every device, with torch autograd's
gradient (the reference's ``multi_head_attention`` runs any head dim);
everything else goes to :class:`FlashAttention`, the autograd function. On
CPU tensors both its directions take the plain PyTorch versions
(:func:`flash_attention_fwd_reference`,
:func:`flash_attention_bwd_reference`); on CUDA tensors the forward is K1
and the backward K2 + K3 at every sequence length (the JAX package's
S <= 1024 dense backward is a TPU routing choice and is not copied), or
they raise. Nothing falls back, and nothing is copied quietly: every kernel
takes any layout :func:`tma_strides` accepts and raises on others; the one
copy is of an output gradient TMA cannot address (an expanded one, with
zero strides), which the backward makes contiguous first. ``launches``,
``launches_dq`` and ``launches_dkv`` count the three kernels' launches.

:func:`single_query_attention`, one decode step's query row against a KV
cache, is plain torch ops on every device, as the reference's is plain jnp
(it has no Pallas kernel).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ...base import MXNetError
from .. import _build

__all__ = ["FlashAttention", "bind_fwd", "block_ops", "flash_attention",
           "fwd_sources",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "tma_strides", "tma_addressable",
           "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq_reference",
           "flash_attention_bwd_dkv_reference",
           "flash_attention_bwd_reference", "single_query_attention",
           "launches", "launches_dq", "launches_dkv"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
# -> the C entries' dtype code (kDtypeF32, kDtypeBf16, kDtypeF16 in
# csrc/hopper.cuh)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB_NAME = "flash_attention_fwd"
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
    of q, k, v and out; lse, B, H, S, D, dtype code, sm_scale, causal,
    stream)."""
    fn = lib.mxt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwd_sources(source="flash_attention_fwd.cu", dims=_HEAD_DIMS):
    """K1's translation units for ``_build.load``: ``source`` compiled once
    per head dim of ``dims``, with ``MXT_FWD_DIM`` naming the kernels that
    object holds (all three dtypes), and once without it, for the C entry
    (a variant that builds fewer dims must call no other)."""
    return (*[(source, (f"MXT_FWD_DIM={d}",)) for d in dims], source)


def _kernel():
    global _lib_fn
    with _lib_lock:
        if _lib_fn is None:
            _lib_fn = bind_fwd(_build.load(_LIB_NAME, fwd_sources()))
        return _lib_fn


def bind_bwd(lib):
    """``(dq_fn, dkv_fn)``: K2's and K3's C entries in the loaded ``lib``,
    with their argument types: (views: 24 int64 = address and S, H, B byte
    strides of six tensors; lse, delta, B, H, S, D, dtype code, sm_scale,
    causal, stream)."""
    fns = (lib.mxt_flash_attention_bwd_dq, lib.mxt_flash_attention_bwd_dkv)
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _bwd_kernels():
    """``(dq_fn, dkv_fn)``: the K2 and K3 entry points, built on first use
    (a library of its own)."""
    global _bwd_fns
    with _bwd_lock:
        if _bwd_fns is None:
            _bwd_fns = bind_bwd(_build.load(_BWD_LIB_NAME, _BWD_SOURCES))
        return _bwd_fns


def _wide(x):
    """``x`` in the plain versions' accumulation dtype: f32, or f64 for an
    f64 tensor."""
    return x if x.dtype == torch.float64 else x.float()


def flash_attention_fwd_reference(q, k, v, sm_scale: float, causal: bool):
    """Plain PyTorch forward: ``(out, lse)`` for (B, H, S, D) inputs, the
    arithmetic the kernel does. Scores and softmax in f32 (bf16 inputs give
    exact bf16 products summed in f32); P is rounded to v's dtype before
    P.V; masked scores take -1e30 and l is clamped at 1e-30. Causal masks
    are bottom-right aligned, which is plain ``tril`` when Lq == Lk. (An
    f64 input, which the kernel does not take, computes in f64 throughout:
    the plain versions are then an f64 yardstick.)"""
    S, Sk = q.shape[2], k.shape[2]
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * sm_scale
    if causal:
        keep = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(_wide(p.to(v.dtype)), _wide(v)) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, dout, lse, delta, sm_scale, causal):
    """P = exp(S - lse) with masked scores at -1e30, and dS = P (dP -
    delta) scale rounded to the input dtype (as a float32 tensor), for the
    plain backward versions; every product summed in f32 (f64 for f64
    inputs)."""
    S = q.shape[2]
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * sm_scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(_wide(dout), _wide(v).transpose(-1, -2))
    ds = _wide((p * (dp - delta.unsqueeze(-1)) * sm_scale).to(q.dtype))
    return p, ds


def flash_attention_bwd_dq_reference(q, k, v, out, dout, lse,
                                     sm_scale: float, causal: bool):
    """Plain PyTorch K2: ``(dq, delta)`` for (B, H, S, D) inputs, the
    forward's ``out`` and (B, H, S) ``lse``, and the output gradient
    ``dout``, with the kernel's arithmetic (that of ``_bwd_dq_kernel``,
    with delta = rowsum(dO * O) in f32 as ``_pallas_bwd`` computes it):
    dq = dS K."""
    delta = (_wide(dout) * _wide(out)).sum(dim=-1)
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, sm_scale, causal)
    return torch.matmul(ds, _wide(k)).to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                      sm_scale: float, causal: bool):
    """Plain PyTorch K3: ``(dk, dv)`` for (B, H, S, D) inputs, the
    forward's (B, H, S) ``lse`` and K2's ``delta``, with the kernel's
    arithmetic (that of ``_bwd_dkv_kernel``): dv = P^T dO with P rounded
    to dO's dtype, dk = dS^T Q."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, sm_scale, causal)
    dv = torch.matmul(_wide(p.to(dout.dtype)).transpose(-1, -2),
                      _wide(dout))
    dk = torch.matmul(ds.transpose(-1, -2), _wide(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, sm_scale: float,
                                  causal: bool):
    """Plain PyTorch backward: ``(dq, dk, dv)``, the two plain kernel
    versions composed as the card composes K2 and K3."""
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, out, dout, lse,
                                                 sm_scale, causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                               sm_scale, causal)
    return dq, dk, dv


def tma_strides(x):
    """The (S, H, B) strides in bytes of a (B, H, S, D) view that a kernel
    reads or writes in place: unit stride on D, every other stride a
    positive multiple of 16 bytes and a 16-byte-aligned address, which is
    what a TMA tensor map can address. A dimension of size 1 is never
    stepped along, so its stride is not checked and is given as 16. Raises
    MXNetError on any other layout: the wrappers never copy."""
    if x.data_ptr() % 16:
        raise MXNetError(f"flash attention: the address must be 16-byte "
                         f"aligned, got {x.data_ptr():#x}")
    strides, fault = _byte_strides(tuple(x.shape), x.stride(),
                                   x.element_size())
    if fault:
        raise MXNetError(f"flash attention: {fault}")
    return strides


def tma_addressable(x) -> bool:
    """Whether :func:`tma_strides` takes ``x`` (no exception raised)."""
    return x.data_ptr() % 16 == 0 and _byte_strides(
        tuple(x.shape), x.stride(), x.element_size())[1] is None


@functools.lru_cache(maxsize=256)
def _byte_strides(shape, stride, elt):
    """``(strides, None)`` as :func:`tma_strides` returns them for one
    shape, strides and element size, or ``(None, fault)`` (a pure function,
    cached: a model hands the kernels a few layouts over and over)."""
    if len(shape) != 4:
        return None, f"expected a (B, H, S, D) view, got shape {shape}"
    if stride[3] != 1:
        return None, f"the head dim must have unit stride, got strides {stride}"
    out = []
    for dim in (2, 1, 0):   # S, H, B
        nbytes = stride[dim] * elt
        if shape[dim] != 1 and (nbytes <= 0 or nbytes % 16):
            return None, (f"every stride but the head dim's must be a "
                          f"positive multiple of 16 bytes, got {stride} x "
                          f"{elt} bytes")
        out.append(nbytes if shape[dim] != 1 else 16)
    return tuple(out), None


def _check(what, mats, rows=()):
    """``mats``: (name, tensor) pairs of (B, H, S, D) views, q first, that
    must lie on one CUDA device with one shape and one dtype in _DTYPES and
    a head dim in _HEAD_DIMS; ``rows``: (name, tensor) pairs of contiguous
    float32 (B, H, S) tensors on that device. Layouts are checked by
    :func:`tma_strides` when the views are read."""
    q = mats[0][1]
    for name, x in mats:   # is_cuda and get_device(): no device objects
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise MXNetError(f"{what}: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.get_device() != q.get_device():
            raise MXNetError(f"{what}: q and {name} on different "
                             f"devices ({q.device}, {x.device})")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise MXNetError(f"{what}: q and {name} must share one "
                             f"dtype in {sorted(map(str, _DTYPES))}, got "
                             f"{q.dtype}/{x.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise MXNetError(f"{what}: q and {name} must be "
                             f"(B, H, S, D) of one shape, got {tuple(x.shape)} "
                             f"vs {tuple(q.shape)}")
    for name, x in rows:
        if not isinstance(x, torch.Tensor) or x.device != q.device \
                or x.dtype != torch.float32 or x.shape != q.shape[:3] \
                or not x.is_contiguous():
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


def _bshd_like(q):
    """An empty (B, H, S, D) view of new (B, S, H, D) memory, q's dtype
    and device: the layout every kernel writes."""
    B, H, S, D = q.shape
    return torch.empty_strided((B, H, S, D), (S * H * D, D, H * D, 1),
                               dtype=q.dtype, device=q.device)


def _views(*xs):
    """The C entries' view array: per tensor its address and (S, H, B)
    byte strides (:func:`tma_strides`, which raises on what TMA cannot
    address)."""
    return (ctypes.c_longlong * (4 * len(xs)))(*(
        n for x in xs for n in (x.data_ptr(), *tma_strides(x))))


def flash_attention_fwd(q, k, v, sm_scale: float, causal: bool):
    """K1: ``(out, lse)`` for CUDA (B, H, S, D) views in bf16, fp16 or f32
    with D in (32, 64, 128), each in a layout :func:`tma_strides` accepts (the
    split views of a QKV projection are read in place). ``out`` is a
    (B, H, S, D) view of (B, S, H, D) memory, so ``out.transpose(1, 2)``
    is contiguous; lse is (B, H, S) f32. Raises MXNetError on anything
    else, or when the tensor-map encode or the launch fails."""
    global launches
    _check("flash_attention_fwd", [("q", q), ("k", k), ("v", v)])
    B, H, S, D = q.shape
    out = _bshd_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return out, lse
    fn = _kernel()
    views = _views(q, k, v, out)
    with torch.cuda.device(q.device):
        rc = fn(views, lse.data_ptr(), B, H, S, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                _stream(q))
    _raise_on(rc, "flash_attention_fwd", q)
    with _count_lock:
        launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, out, dout, lse, sm_scale: float,
                           causal: bool):
    """K2: ``(dq, delta)`` for CUDA (B, H, S, D) views q, k, v, the
    forward's ``out`` and the output gradient ``dout`` (bf16, fp16 or f32,
    D in (32, 64, 128), each in a layout :func:`tma_strides` accepts, read in
    place) and the forward's contiguous (B, H, S) f32 ``lse``. ``dq`` is a
    (B, H, S, D) view of (B, S, H, D) memory; ``delta`` = rowsum(dout *
    out), (B, H, S) f32, is what :func:`flash_attention_bwd_dkv` takes.
    Raises MXNetError on anything else, or when the tensor-map encode or
    the launch fails."""
    global launches_dq
    _check("flash_attention_bwd_dq", [("q", q), ("k", k), ("v", v),
                                      ("out", out), ("dout", dout)],
           [("lse", lse)])
    B, H, S, D = q.shape
    dq = _bshd_like(q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * H * S == 0:
        return dq, delta
    fn = _bwd_kernels()[0]
    views = _views(q, k, v, out, dout, dq)
    with torch.cuda.device(q.device):
        rc = fn(views, lse.data_ptr(), delta.data_ptr(), B, H, S, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                _stream(q))
    _raise_on(rc, "flash_attention_bwd_dq", q)
    with _count_lock:
        launches_dq += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, sm_scale: float,
                            causal: bool):
    """K3: ``(dk, dv)`` for CUDA (B, H, S, D) views q, k, v and ``dout``
    (as :func:`flash_attention_bwd_dq` takes them), the forward's ``lse``
    and K2's ``delta`` (contiguous (B, H, S) f32; launch K3 on the stream
    K2 ran on, as the wrappers do). ``dk`` and ``dv`` are (B, H, S, D)
    views of (B, S, H, D) memory. Raises MXNetError on anything else, or
    when the tensor-map encode or the launch fails."""
    global launches_dkv
    _check("flash_attention_bwd_dkv", [("q", q), ("k", k), ("v", v),
                                       ("dout", dout)],
           [("lse", lse), ("delta", delta)])
    B, H, S, D = q.shape
    dk, dv = _bshd_like(k), _bshd_like(v)
    if B * H * S == 0:
        return dk, dv
    fn = _bwd_kernels()[1]
    views = _views(q, k, v, dout, dk, dv)
    with torch.cuda.device(q.device):
        rc = fn(views, lse.data_ptr(), delta.data_ptr(), B, H, S, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                _stream(q))
    _raise_on(rc, "flash_attention_bwd_dkv", q)
    with _count_lock:
        launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, sm_scale: float,
                        causal: bool):
    """The backward on the card: ``(dq, dk, dv)`` from K2 (which also
    computes delta) and K3, on the views as given."""
    dq, delta = flash_attention_bwd_dq(q, k, v, out, dout, lse, sm_scale,
                                       causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, sm_scale,
                                     causal)
    return dq, dk, dv


def _on_cpu(*xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


def _shape_only(q) -> bool:
    """A ``meta`` tensor (shape inference): the plain versions compute no
    value on it, and nothing is launched or counted."""
    return q.device.type == "meta"


def _in_place(dout):
    """The output gradient as K2 and K3 read it: as it is, unless TMA
    cannot address it (an expanded one, with zero strides, as
    ``out.sum().backward()`` gives), which is made contiguous first."""
    return dout if tma_addressable(dout) else dout.contiguous()


def _bwd_dq_in_place(q, k, v, out, dout, lse, sm_scale, causal):
    return flash_attention_bwd_dq(q, k, v, out, _in_place(dout), lse,
                                  sm_scale, causal)


def _bwd_dkv_in_place(q, k, v, dout, lse, delta, sm_scale, causal):
    return flash_attention_bwd_dkv(q, k, v, _in_place(dout), lse, delta,
                                   sm_scale, causal)


def block_ops(q):
    """``(fwd, bwd_dq, bwd_dkv)`` for attention blocks of ``q``'s device
    and head dim, with the signatures of K1's, K2's and K3's wrappers: the
    kernels for CUDA tensors (which raise on what they do not take), the
    plain versions for CPU tensors, for meta tensors (shape inference) and
    for head dims outside (32, 64, 128), which the kernels do not take
    (dense attention's arithmetic on every device). On the kernel route the backward pair reads every operand in
    place but an output gradient TMA cannot address, which it copies
    contiguous first. :class:`FlashAttention` and the ring
    (``parallel/ring_attention.py``) both dispatch through this."""
    if _on_cpu(q) or _shape_only(q) or q.shape[-1] not in _HEAD_DIMS:
        return (flash_attention_fwd_reference,
                flash_attention_bwd_dq_reference,
                flash_attention_bwd_dkv_reference)
    return flash_attention_fwd, _bwd_dq_in_place, _bwd_dkv_in_place


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, sm_scale, causal)`` over (B, H, S, D)
    with Lq == Lk: the counterpart of the JAX package's ``_flash`` custom
    VJP (``flash_attention.py:511``). Forward K1 on the views as given,
    saving (q, k, v, out, lse); backward K2 + K3 on the saved views and the
    output gradient as they are (a split QKV projection's views, K1's
    output and the transposed gradient a model hands back are all read in
    place; an output gradient TMA cannot address is copied, as
    :func:`block_ops` says). CPU tensors take the plain versions in both
    directions; CUDA tensors take the kernels or raise."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        out, lse = block_ops(q)[0](q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        _, bwd_dq, bwd_dkv = block_ops(q)
        dq, delta = bwd_dq(q, k, v, out, dout, lse, ctx.sm_scale, ctx.causal)
        dk, dv = bwd_dkv(q, k, v, dout, lse, delta, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


def _dense_attention(q, k, v, sm_scale: float, causal: bool):
    """Dense SDPA for Lq != Lk and for head dims the kernels do not take: a
    copy of the JAX package's
    ``_dense_attention``, with its bottom-right causal convention (query
    row i sees keys j <= i + (Lk - Lq); the last query row sees every
    key)."""
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * sm_scale
    if causal:
        S, Sk = q.shape[2], k.shape[2]
        keep = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(_wide(p), _wide(v)).to(q.dtype)


def single_query_attention(q, k_ctx, v_ctx, k_new, v_new, lengths, *,
                           heads: int = 1, sm_scale=None):
    """One autoregressive decode step of attention against a KV cache (the
    reference's ``single_query_attention``, ``flash_attention.py:578``).

    ``q``/``k_new``/``v_new`` are the step's projections, (B, heads*D);
    ``k_ctx``/``v_ctx`` the cached context, (B, L, heads*D), lane j holding
    position j (lanes at and past ``lengths[b]`` hold stale pool contents,
    which must be finite). The new key/value pair is selected in at lane
    ``lengths[b]`` and lanes past it are scored ``_NEG_INF``, which
    underflows to an exactly-zero softmax weight in f32, so stale lanes
    never touch a real row. Numerics as :func:`_dense_attention`: f32
    scores, softmax, P cast to q's dtype, f32-accumulated output, cast
    back.

    Both products are written as an exact f32 elementwise product and a
    sum over the innermost axis of a contiguous tensor (D for the scores,
    L for P V), not as batched matrix products: a row's result must not
    depend on how many rows the call has (the decode engine's batched
    step equals its serial one), and cuBLAS's batched products choose
    their kernel, and so their summation order, by the batch count and
    the operands' strides, where PyTorch's inner-axis sum takes its order
    from the reduced length (``tools/decode_rows.py`` checks both on the
    card)."""
    B, units = q.shape
    L = k_ctx.shape[1]
    D = units // heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    lane = torch.arange(L, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.long)
    sel = (lane[None, :] == lengths[:, None])[..., None]        # (B, L, 1)
    k = torch.where(sel, k_new[:, None, :], k_ctx)
    v = torch.where(sel, v_new[:, None, :], v_ctx)
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    qh = q.reshape(B, heads, 1, D).to(**f32)
    kh = k.reshape(B, L, heads, D).transpose(1, 2).to(**f32)   # (B, H, L, D)
    vt = v.reshape(B, L, heads, D).permute(0, 2, 3, 1).to(**f32)  # (B,H,D,L)
    s = (qh * kh).sum(-1) * float(sm_scale)                     # (B, H, L)
    valid = lane[None, :] <= lengths[:, None]                   # (B, L)
    s = s.masked_fill(~valid[:, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = (p.float()[:, :, None, :] * vt).sum(-1)               # (B, H, D)
    return out.to(q.dtype).reshape(B, units)


def flash_attention(q, k, v, *, causal: bool = False, sm_scale=None):
    """Fused attention over (B, H, S, D), differentiable. Lq != Lk, and a
    head dim outside (32, 64, 128), go to the dense path on every device
    (its gradient is torch autograd's); otherwise :class:`FlashAttention`
    (the plain versions for CPU tensors, the kernels for CUDA tensors,
    which raise on what they do not take)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[2] != k.shape[2] or q.shape[-1] not in _HEAD_DIMS:
        return _dense_attention(q, k, v, float(sm_scale), bool(causal))
    return FlashAttention.apply(q, k, v, float(sm_scale), bool(causal))
