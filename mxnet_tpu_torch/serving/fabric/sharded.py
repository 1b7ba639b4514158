"""Sharded endpoint twins: one logical replica spanning the contexts of a
slice (the port of ``mxnet_tpu/serving/fabric/sharded.py``).

:class:`ShardedEndpoint` and :class:`ShardedDecodeEndpoint` are drop-in
subclasses of ``serving.ModelEndpoint`` / ``serving.generate.DecodeEndpoint``
over a slice's contexts (:mod:`.slices`). The reference compiles each bucket
with ``NamedSharding`` over the slice's mesh and lets XLA place the rows; the
port does the placement itself, eagerly:

- **the batch axis splits.** A bucket's rows are cut into contiguous equal
  chunks, one per context of the slice's first (batch) axis; each chunk is
  copied into that context's staging buffers, runs through that context's
  copy of the block, and the outputs are concatenated on the slice's first
  context. Every row is computed whole on one context: no contraction is
  split, no floating-point sum reordered. Other axes replicate: a chunk
  runs once, on the first context of its batch group;
- **parameters** are copied to every context (one copy a context, refreshed
  when the block's tensors change, so a hot swap reaches every context).
  With ``shard_params`` each parameter whose leading axis divides by the
  batch groups is stored as a leading-axis shard a context and gathered —
  a byte move — before a forward reads it (the reference's fsdp-style
  spreading); the others are copied whole.

What is bitwise and what is not: a chunk's outputs are bitwise the block's
direct forward of that chunk on that context. They need not be bitwise the
same rows inside one forward over the whole bucket: cuBLAS and oneDNN pick
their kernels by row count, so ``B/n`` rows may round differently from ``B``
rows (the reference's XLA partitioner runs one program on every device, so
its oracle holds). On a one-card slice the chunk is the bucket, and the
served outputs are bitwise a ``ModelEndpoint``'s.

A sharded endpoint's bucket ladder may only contain multiples of its batch
groups (the reference's rule: XLA refuses an uneven batch axis); the
default ladder is the pow2 ladder filtered down to those.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...base import Context, MXNetError
from .. import bucketing
from ..endpoint import ModelEndpoint, StagedBatch, _Slot
from ..generate.engine import DecodeEndpoint
from ..generate.kv_cache import PagedKVPool, write_prefill, write_step
from .slices import SliceMesh, SliceSpec

__all__ = ["ShardedEndpoint", "ShardedDecodeEndpoint"]


def _resolve_mesh(slice_spec: Optional[SliceSpec],
                  mesh: Optional[SliceMesh]) -> SliceMesh:
    if slice_spec is not None:
        if mesh is not None:
            raise MXNetError("pass slice_spec OR mesh, not both")
        return slice_spec.make_mesh()
    if mesh is None:
        raise MXNetError("a sharded endpoint needs a slice_spec or mesh")
    return mesh


def _mesh_label(mesh: SliceMesh) -> str:
    """Topology-stable slice label: axis layout, not device ids."""
    return ",".join(f"{a}={s}" for a, s in sorted(mesh.shape.items()))


def _sharded_buckets(buckets: Optional[Sequence[int]], max_batch_size: int,
                     shard: int) -> Sequence[int]:
    """Bucket ladder constrained to multiples of the batch-shard size:
    every bucket's rows split evenly over the batch groups."""
    if max_batch_size % shard:
        raise MXNetError(
            f"max_batch_size={max_batch_size} must be a multiple of the "
            f"slice's batch-shard size {shard} (uneven batch sharding "
            "does not compile)")
    if buckets is None:
        return [b for b in bucketing.pow2_buckets(max_batch_size)
                if b % shard == 0]
    bad = [b for b in buckets if int(b) % shard]
    if bad:
        raise MXNetError(
            f"buckets {bad} are not multiples of the batch-shard size "
            f"{shard}; every sharded bucket's batch axis must divide by it")
    return buckets


def _group_contexts(mesh: SliceMesh, ctx: Optional[Context]):
    """(batch axis, batch groups, the first context of each group)."""
    axis = mesh.axis_names[0]
    shard = mesh.axis_size(axis)
    if ctx is not None and Context(ctx) != mesh.contexts[0]:
        raise MXNetError(f"a sharded endpoint serves from its slice's first "
                         f"context {mesh.contexts[0]}, got ctx={ctx}")
    step = mesh.size // shard
    return axis, shard, [mesh.contexts[g * step] for g in range(shard)]


def _on(device: torch.device):
    """Make ``device`` current for the work of one context."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _stamp(t: torch.Tensor):
    return (t.data_ptr(), -1 if t.is_inference() else t._version)


class _Method(torch.nn.Module):
    """``block.<method>`` as a forward, for ``functional_call``."""

    def __init__(self, block, method: str):
        super().__init__()
        self.block = block
        self._method = method

    def forward(self, *args):
        return getattr(self.block, self._method)(*args)


class _Placement:
    """Each batch group's copy of a block's parameters and buffers.

    Group 0 reads the block's own tensors where they are whole; every other
    group holds a copy on its context (a leading-axis shard of a divisible
    parameter with ``shard_params``, gathered before use). The copies are
    rebuilt when one of the block's tensors changed (a hot swap, an
    in-place update). ``gathers`` counts the gathered parameters."""

    def __init__(self, block, contexts: List[Context], shard_params: bool):
        self._block = block
        self._devices = [c.torch_device() for c in contexts]
        self._shard_params = shard_params
        self._key = None
        self._held: List[Dict[str, tuple]] = []
        self._calls: Dict[str, _Method] = {}
        self.gathers = 0

    def _named(self):
        return list(self._block.named_parameters()) + \
            list(self._block.named_buffers())

    def _refresh(self):
        named = self._named()
        key = tuple(_stamp(t) for _, t in named)
        if key == self._key:
            return
        n = len(self._devices)
        held: List[Dict[str, tuple]] = [{} for _ in range(n)]
        for name, t in named:
            t = t.detach()
            if self._shard_params and n > 1 and t.dim() >= 1 and \
                    t.shape[0] % n == 0:
                for g, piece in enumerate(t.chunk(n)):
                    held[g][name] = ("shard", piece.to(self._devices[g],
                                                       copy=True))
                continue
            for g, dev in enumerate(self._devices):
                own = g == 0 and t.device == dev
                held[g][name] = ("whole", t if own else t.to(dev, copy=True))
        self._held = held
        self._key = key

    def shards(self, g: int) -> Dict[str, torch.Tensor]:
        """The leading-axis shards group ``g`` stores."""
        self._refresh()
        return {n: t for n, (kind, t) in self._held[g].items()
                if kind == "shard"}

    def _state(self, g: int) -> Optional[Dict[str, torch.Tensor]]:
        """Group ``g``'s tensors by name, shards gathered onto its context;
        None where they are the block's own."""
        held, dev = self._held[g], self._devices[g]
        if g == 0 and all(kind == "whole" for kind, _ in held.values()):
            return None
        state = {}
        for name, (kind, t) in held.items():
            if kind == "shard":
                t = torch.cat([h[name][1].to(dev) for h in self._held])
                self.gathers += 1
            state[name] = t
        return state

    def run(self, g: int, method: Optional[str], args):
        """``block(*args)`` (or ``block.<method>(*args)``) with group
        ``g``'s tensors, on its context."""
        self._refresh()
        with _on(self._devices[g]):
            state = self._state(g)
            if state is None:
                fn = self._block if method is None \
                    else getattr(self._block, method)
                return fn(*args)
            if method is None:
                return torch.func.functional_call(self._block, state, args)
            call = self._calls.get(method)
            if call is None:
                call = self._calls[method] = _Method(self._block, method)
            return torch.func.functional_call(
                call, {f"block.{n}": t for n, t in state.items()}, args)


class _Events(tuple):
    """One event a context, waited for together (a slot's fence)."""

    def synchronize(self):
        for ev in self:
            ev.synchronize()


class ShardedEndpoint(ModelEndpoint):
    """A ModelEndpoint whose replica spans every context of one slice.

    Parameters beyond ModelEndpoint's:

    slice_spec : SliceSpec, optional
        The gang-scheduled slice (from :func:`.slices.plan_slices`) this
        replica owns. ``capacity`` becomes its device count.
    mesh : SliceMesh, optional
        Explicit mesh alternative to ``slice_spec``.
    shard_params : bool
        Store each parameter whose leading axis divides by the batch groups
        as one shard a context, gathered before use; the others are copied
        whole. A byte move, invisible in the outputs. Default True.

    The endpoint serves from the slice's first context (``ctx``, where the
    outputs are concatenated); a ``ctx`` other than it raises.
    """

    def __init__(self, name: str, block, input_shapes, dtype="float32",
                 max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 slice_spec: Optional[SliceSpec] = None,
                 mesh: Optional[SliceMesh] = None,
                 shard_params: bool = True, ctx=None):
        smesh = _resolve_mesh(slice_spec, mesh)
        self.slice_spec = slice_spec
        self._smesh = smesh
        self._batch_axis, self._shard, self._group_ctxs = \
            _group_contexts(smesh, ctx)
        self._group_devices = [c.torch_device() for c in self._group_ctxs]
        self._shard_params = bool(shard_params)
        self.capacity = smesh.size
        buckets = _sharded_buckets(buckets, int(max_batch_size), self._shard)
        self._placement = _Placement(block, self._group_ctxs,
                                     self._shard_params)
        super().__init__(name, block, input_shapes, dtype=dtype,
                         max_batch_size=max_batch_size, buckets=buckets,
                         ctx=smesh.contexts[0])

    # -- placement ------------------------------------------------------
    def _device_label(self) -> str:
        platform = "gpu" if self._on_card() else "cpu"
        return f"{platform}:{_mesh_label(self._smesh)}"

    def _place(self, arrays):
        """Host arrays -> one tuple of device chunks a batch group; a batch
        whose rows do not divide (the one-row signature probe) runs whole
        on the first context."""
        rows = arrays[0].shape[0]
        if rows % self._shard:
            return (super()._place(arrays),)
        k = rows // self._shard
        return tuple(
            tuple(torch.from_numpy(np.ascontiguousarray(
                a[g * k:(g + 1) * k])).to(dev) for a in arrays)
            for g, dev in enumerate(self._group_devices))

    def _forward(self, device_inputs):
        """Each group's chunk through its context's copy of the block, the
        outputs concatenated (row order kept) on the first context."""
        outs = []
        with torch.inference_mode():
            for g, ins in enumerate(device_inputs):
                out = self._placement.run(g, None, ins)
                outs.append(tuple(out) if isinstance(out, (list, tuple))
                            else (out,))
            if len(outs) == 1:
                return outs[0]
            return tuple(torch.cat([o[i].to(self.device) for o in outs])
                         for i in range(len(outs[0])))

    # -- the server's slot hooks ----------------------------------------
    def _device_buffers(self, host):
        k = host[0].shape[0] // self._shard
        return tuple(tuple(torch.empty((k,) + tuple(h.shape[1:]),
                                       dtype=h.dtype, device=dev)
                           for h in host)
                     for dev in self._group_devices)

    def _upload(self, slot: _Slot):
        k = slot.host_t[0].shape[0] // self._shard
        ready = []
        for g, (bufs, dev) in enumerate(zip(slot.device,
                                            self._group_devices)):
            for d, h in zip(bufs, slot.host_t):
                d.copy_(h[g * k:(g + 1) * k], non_blocking=True)
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ready.append(ev)
        return _Events(ready) if ready else None

    def _wait_ready(self, staged: StagedBatch):
        if staged.ready is not None:
            for ev, dev in zip(staged.ready, self._group_devices):
                torch.cuda.current_stream(dev).wait_event(ev)

    def __repr__(self):
        return (f"ShardedEndpoint({self.name!r}, "
                f"mesh={_mesh_label(self._smesh)}, "
                f"inputs={self.input_shapes}, buckets={self.buckets})")


class _ReplicatedKVPool(PagedKVPool):
    """A PagedKVPool whose K and V pools are replicated on every batch
    group's context: ``k_pool``/``v_pool`` are the first context's,
    ``replicas`` every context's (first included). The allocator is one;
    a compaction moves the first context's pages and copies them to the
    other replicas."""

    def __init__(self, *args, replica_ctxs=(), **kw):
        super().__init__(*args, **kw)
        self._others = [(torch.zeros_like(self.k_pool, device=dev),
                         torch.zeros_like(self.v_pool, device=dev))
                        for dev in (c.torch_device() for c in replica_ctxs)]

    @property
    def replicas(self):
        return [(self.k_pool, self.v_pool)] + self._others

    def defrag(self) -> int:
        moved = super().defrag()
        if moved:
            for k, v in self._others:
                k.copy_(self.k_pool)
                v.copy_(self.v_pool)
        return moved


class ShardedDecodeEndpoint(DecodeEndpoint):
    """A DecodeEndpoint twin over a slice.

    Layout: a decode step's rows split over the slice's batch groups (its
    bucket ladder is constrained to multiples of the groups, like the dense
    twin); prefill (one prompt) runs on the first context, and the paged KV
    pools are replicated, one a group. Each group's step writes the new
    K/V rows of its own sequences; before the step returns, every group's
    new rows are written into every replica, so the next step on any
    context reads every sequence's whole context (a prefill's K/V is
    written into every replica the same way). Parameters replicate.

    Each group runs its products at the endpoint's fixed row count (its
    rows padded to ``max_batch_size``), the row count ``DecodeEndpoint``
    runs every step at, so a sequence's tokens are bitwise those of a
    ``DecodeEndpoint`` on the same kind of device, serial or batched.
    """

    def __init__(self, name: str, block, *,
                 slice_spec: Optional[SliceSpec] = None,
                 mesh: Optional[SliceMesh] = None,
                 max_batch_size: Optional[int] = None,
                 decode_buckets: Optional[Sequence[int]] = None,
                 ctx=None, **kw):
        smesh = _resolve_mesh(slice_spec, mesh)
        self.slice_spec = slice_spec
        self._smesh = smesh
        self._batch_axis, self._shard, self._group_ctxs = \
            _group_contexts(smesh, ctx)
        self._group_devices = [c.torch_device() for c in self._group_ctxs]
        self.capacity = smesh.size
        if max_batch_size is None:
            from ... import config as _config
            max_batch_size = int(_config.get("MXNET_DECODE_MAX_BATCH"))
        decode_buckets = _sharded_buckets(decode_buckets,
                                          int(max_batch_size), self._shard)
        self._placement = _Placement(block, self._group_ctxs, False)
        super().__init__(name, block, max_batch_size=max_batch_size,
                         decode_buckets=decode_buckets, ctx=smesh.contexts[0],
                         **kw)

    def _make_pool(self, *args, **kw) -> PagedKVPool:
        return _ReplicatedKVPool(*args, replica_ctxs=self._group_ctxs[1:],
                                 **kw)

    def _device_label(self) -> str:
        platform = "gpu" if self.device.type == "cuda" else "cpu"
        return f"{platform}:{_mesh_label(self._smesh)}"

    def _write_prefill(self, k, v, table, length: int):
        ps = self.pool.page_size
        for kp, vp in self.pool.replicas:
            write_prefill(kp, k.to(kp.device), table, length, ps)
            write_prefill(vp, v.to(vp.device), table, length, ps)

    def _decode(self, host: np.ndarray, B: int) -> np.ndarray:
        """One decode step at batch bucket ``B``: group ``g`` takes rows
        ``g*B/n`` up to ``(g+1)*B/n`` (padded to the fixed row count) and
        runs the base step on its replica with its copy of the block; then
        every replica takes every group's new K/V rows."""
        ps = self.pool.page_size
        k = B // self._shard
        new_k, new_v, rows, ids = [], [], [], []
        with torch.inference_mode():
            for g, (dev, pools) in enumerate(zip(self._group_devices,
                                                 self.pool.replicas)):
                part = np.zeros_like(host)
                part[:k] = host[g * k:(g + 1) * k]
                d = torch.from_numpy(part).to(dev)
                with _on(dev):
                    outs = self._step_outputs(
                        d, k, pools, functools.partial(self._group_step, g))
                new_k.append(torch.stack(outs[1::2])[:, :k])
                new_v.append(torch.stack(outs[2::2])[:, :k])
                rows.append(d[:k])
                ids.append(outs[0][:k].argmax(dim=-1))
            for kp, vp in self.pool.replicas:
                dev = kp.device
                with _on(dev):
                    meta = torch.cat([r.to(dev) for r in rows])
                    pos, valid, tables = meta[:, 1], meta[:, 2].bool(), \
                        meta[:, 3:]
                    write_step(kp, torch.cat([t.to(dev) for t in new_k], 1),
                               tables, pos, valid, ps)
                    write_step(vp, torch.cat([t.to(dev) for t in new_v], 1),
                               tables, pos, valid, ps)
            next_ids = torch.cat([i.to(self.device) for i in ids])
        return next_ids.cpu().numpy()          # sync point

    def _group_step(self, g: int, *args):
        return self._placement.run(g, "decode_step", args)

    def __repr__(self):
        return (f"ShardedDecodeEndpoint({self.name!r}, "
                f"mesh={_mesh_label(self._smesh)}, "
                f"decode_buckets={self.decode_buckets})")
