"""Ring attention: sequence (context) parallelism over the ranks of a mesh
axis (the counterpart of ``mxnet_tpu/parallel/ring_attention.py``).

The sequence axis is split over the ranks of ``axis_name`` (default "sp"):
rank ``r`` of ``n`` holds the query, key and value rows
``[r * S_local, (r + 1) * S_local)``. Its queries attend to every rank's
keys and values as the K/V blocks travel round the ring, one rank a step,
through the port's tape-aware :func:`~.collectives.ppermute`; after ``t``
steps the block resident on rank ``r`` came from rank ``(r - t) mod n``
(the reference's ``ring_attention.py:76-79``).

Each block is one call of the flash-attention kernels
(``ops/cuda/flash_attention.py``), not the reference's ``jnp.einsum`` tile:

- **Forward.** K1 (``flash_attention_fwd``) gives each block's output and
  log-sum-exp ``(out_j, lse_j)``; the blocks merge in f32 by their lse,
  ``lse = logsumexp_j lse_j`` and ``out = sum_j exp(lse_j - lse) out_j``,
  taken block by block (``torch.logaddexp``), then rounded once to q's
  dtype. Under ``causal`` the block from this rank (the diagonal) runs
  K1 with its causal mask, blocks from earlier ranks run it unmasked, and
  blocks from later ranks are skipped: every one of their positions lies
  in the future. The reference keeps such a block with scores at -1e30,
  whose weight ``exp(-1e30 - m)`` is exactly 0 once the diagonal block
  has set a finite max, so skipping it changes nothing. K1 launches a
  call: ``n`` without ``causal``, ``r + 1`` on rank ``r`` with it.
- **Backward.** :class:`RingAttention`'s backward runs the ring once more
  with the same blocks and the same skips. K2 (``flash_attention_bwd_dq``)
  and K3 (``flash_attention_bwd_dkv``) take the merged (global) ``out``
  and ``lse``, so each block's P = exp(S - lse) is the global probability
  and delta = rowsum(dO * O) the global one; dq sums the blocks' dq in
  f32 on this rank, and the f32 dk/dv accumulators travel round the ring
  with their K/V block and arrive home after ``n`` rotations. K2 and K3
  launch as often as K1.

Each block takes what ``flash_attention.block_ops`` picks, the rule
:class:`~mxnet_tpu_torch.ops.cuda.flash_attention.FlashAttention` follows
too: on CPU tensors the kernels' plain versions
(``flash_attention_fwd_reference``, ``flash_attention_bwd_*_reference``)
through the same code; on CUDA tensors the kernels, which raise on what
they do not take. A head dim outside (32, 64, 128), which the kernels do
not take, follows ``flash_attention``'s rule for such shapes (F1: dense
attention on every device): its blocks take the plain versions, dense
attention with the same arithmetic, on every device. With one rank on the
axis there is no ring: :func:`ring_attention` is one
:func:`~mxnet_tpu_torch.ops.cuda.flash_attention.flash_attention` call.

Received blocks are new contiguous (B, H, S, D) tensors, 16-byte aligned,
which the kernels read in place (``tma_strides``). On gloo, card tensors'
send and receive go through pinned host memory (``collectives._staged``).
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops.cuda import flash_attention as fa
from . import collectives

__all__ = ["RingAttention", "ring_attention", "ring_self_attention"]


def _ring_masks(n, index, causal):
    """Per ring step, the mask of the block resident on rank ``index``
    (it came from rank ``(index - t) mod n``): None (skipped), True (the
    causal diagonal) or False."""
    out = []
    for t in range(n):
        src = (index - t) % n
        if causal and src > index:
            out.append(None)
        else:
            out.append(bool(causal and src == index))
    return out


class RingAttention(torch.autograd.Function):
    """``RingAttention.apply(q, k, v, sm_scale, causal, axis_name, mesh)``
    over this rank's (B, H, S_local, D) shards, the axis of size > 1."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, axis_name, mesh):
        n = collectives.axis_size(axis_name, mesh)
        index = collectives.axis_index(axis_name, mesh)
        perm = [(i, (i + 1) % n) for i in range(n)]
        fwd = fa.block_ops(q)[0]
        kv = torch.stack((k, v))
        out = lse = None
        masks = _ring_masks(n, index, causal)
        for t, mask in enumerate(masks):
            if mask is not None:
                o_j, l_j = fwd(q, kv[0], kv[1], sm_scale, mask)
                if out is None:
                    out, lse = o_j.float(), l_j
                else:
                    new = torch.logaddexp(lse, l_j)
                    out = out * torch.exp(lse - new).unsqueeze(-1) + \
                        o_j.float() * torch.exp(l_j - new).unsqueeze(-1)
                    lse = new
            if t < n - 1:
                kv = collectives.ppermute(kv, axis_name, perm, mesh=mesh)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (sm_scale, axis_name, mesh, perm, masks)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        sm_scale, axis_name, mesh, perm, masks = ctx.args
        n = len(masks)
        _, bwd_dq, bwd_dkv = fa.block_ops(q)
        kv = torch.stack((k, v))
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for t, mask in enumerate(masks):
            if mask is not None:
                dq_j, delta = bwd_dq(q, kv[0], kv[1], out, dout, lse,
                                     sm_scale, mask)
                dk_j, dv_j = bwd_dkv(q, kv[0], kv[1], dout, lse, delta,
                                     sm_scale, mask)
                dq += dq_j.float()
                dkv[0] += dk_j.float()
                dkv[1] += dv_j.float()
            if t < n - 1:
                kv = collectives.ppermute(kv, axis_name, perm, mesh=mesh)
            dkv = collectives.ppermute(dkv, axis_name, perm, mesh=mesh)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, axis_name: str = "sp", causal: bool = False,
                   scale=None, mesh=None):
    """Ring attention over this rank's (B, H, S_local, D) shards of q, k
    and v along mesh axis ``axis_name`` of ``mesh`` (default the current
    mesh); returns this rank's (B, H, S_local, D) output, differentiable.
    Rank ``r`` holds positions ``[r * S_local, (r + 1) * S_local)``, which
    ``causal`` masks by. ``scale`` defaults to 1/sqrt(D)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError(f"ring_attention: q, k, v must be (B, H, S, D) of "
                         f"one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if collectives.axis_size(axis_name, mesh) == 1:
        return fa.flash_attention(q, k, v, causal=causal, sm_scale=scale)
    return RingAttention.apply(q, k, v, float(scale), bool(causal),
                               axis_name, mesh)


def ring_self_attention(q, k, v, mesh, *, causal: bool = False, scale=None,
                        axis_name: str = "sp"):
    """Ring attention over the whole (B, H, S, D) q, k and v that every
    rank of ``axis_name`` holds: this rank takes its 1/n of S
    (:func:`~.collectives.scatter_to_axis`), runs :func:`ring_attention`
    and returns the whole (B, H, S, D) output through a tape-aware
    all_gather along S (:func:`~.collectives.gather_from_axis`). Every rank
    holds the same output, and a loss of it gives every rank the whole
    gradient of q, k and v. S must be a multiple of the axis size."""
    parts = [collectives.scatter_to_axis(t, axis_name, dim=2, mesh=mesh)
             for t in (q, k, v)]
    out = ring_attention(*parts, axis_name=axis_name, causal=causal,
                         scale=scale, mesh=mesh)
    return collectives.gather_from_axis(out, axis_name, dim=2, mesh=mesh)
