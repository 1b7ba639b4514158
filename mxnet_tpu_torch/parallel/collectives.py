"""The communication layer of the port: ``torch.distributed`` over the
processes of a job (the counterpart of ``mxnet_tpu/parallel/collectives.py``).

This module is the one place of the port that calls ``torch.distributed``
(``parallel/mesh.py`` makes the mesh axes' process groups). The JAX package
is single-controller: GSPMD inserts the collectives a sharded program
implies. The port runs one process per rank, so every reduction is written
out, through these functions.

Two layers, as in the reference:

1. **The host control plane.** :func:`initialize_distributed` joins the job
   that ``mxnet_tpu_torch/tools/launch.py`` started (the variables
   ``MXNET_TPU_COORDINATOR``, ``MXNET_TPU_NUM_WORKERS`` and
   ``MXNET_TPU_WORKER_ID``); without them the process is a one-rank job and
   nothing is initialized. Then :func:`rank`, :func:`num_workers`,
   :func:`barrier`, :func:`broadcast_from_root`, and the world's
   :func:`world_all_reduce`, :func:`world_all_gather` and
   :func:`world_broadcast` that the kvstores use.

2. **In-program collectives** over a mesh axis (:func:`all_reduce`,
   :func:`all_gather`, :func:`reduce_scatter`, :func:`ppermute`,
   :func:`all_to_all`, :func:`axis_index`, :func:`axis_size`), each a
   ``torch.autograd.Function``, so that a gradient flows through it (an
   in-place ``torch.distributed`` call is invisible to autograd). Their
   backwards are the transposes under the rule that every rank's loss is
   one term of the job's loss (all_reduce's is an all_reduce, all_gather's
   a reduce_scatter). Tensor parallelism computes one loss that every rank
   of its axis holds alike; its three operators are :func:`copy_to_axis`
   (identity forward, all_reduce backward), :func:`reduce_from_axis`
   (all_reduce forward, identity backward) and :func:`gather_from_axis`
   (all_gather forward, the rank's slice backward).

**The backend**, decided once by :func:`initialize_distributed`: NCCL where
every rank has a card of its own, gloo otherwise (on the CPU, or several
ranks on one card, which NCCL refuses). Gloo runs all_reduce, broadcast,
all_gather, reduce_scatter and all_to_all on CUDA tensors itself; it has no
send or receive for them, so :func:`ppermute` on CUDA tensors is staged
through pinned host memory by :func:`_staged`, one function, counted by
name (:func:`host_staged`). ``chip_smoke.py`` phase 16(a) probes gloo's own
form of each of the four on the card, results checked, and fails where one
that is left to gloo does not run or is wrong.
"""
from __future__ import annotations

import datetime
import os
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ["initialize_distributed", "backend", "device", "rank",
           "num_workers", "barrier", "broadcast_from_root",
           "world_all_reduce", "world_all_gather", "world_broadcast",
           "all_reduce", "all_gather", "reduce_scatter", "ppermute",
           "all_to_all", "axis_index", "axis_size", "copy_to_axis",
           "reduce_from_axis", "gather_from_axis", "scatter_to_axis",
           "host_staged", "nccl_available",
           "batch_shard", "sharded_batch", "batch_sum", "tensor_parallel",
           "tensor_parallel_axis"]

#: what gloo does not do on CUDA tensors (send and receive): staged through
#: the host
GLOO_CUDA_STAGED = ("ppermute",)
_STAGED: Dict[str, int] = {}
_LOCAL = threading.local()


# ---------------------------------------------------------------------------
# the host control plane
# ---------------------------------------------------------------------------
def _backend_rule(world: int) -> str:
    """NCCL where every rank of this (one-host) job has a card of its own,
    else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout: Optional[float] = None) -> bool:
    """Join the job: ``init_process_group`` over
    ``tcp://coordinator_address`` (default ``MXNET_TPU_COORDINATOR``) with
    the world size and rank given or read from ``MXNET_TPU_NUM_WORKERS``
    and ``MXNET_TPU_WORKER_ID``, the backend by the rule above and a
    timeout of ``timeout`` seconds (default ``MXNET_DIST_TIMEOUT``). A
    no-op when already initialized; a one-rank job (nothing initialized)
    when no coordinator is known. Returns whether a process group is
    up."""
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        coordinator_address = os.environ.get("MXNET_TPU_COORDINATOR")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("MXNET_TPU_NUM_WORKERS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MXNET_TPU_WORKER_ID", "0"))
    if timeout is None:
        from .. import config
        timeout = config.get("MXNET_DIST_TIMEOUT")
    name = _backend_rule(num_processes)
    if name == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        name, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=float(timeout)))
    return True


def backend() -> Optional[str]:
    """"nccl", "gloo", or None in a one-rank job."""
    return dist.get_backend() if dist.is_initialized() else None


def device() -> torch.device:
    """This rank's device: its own card under NCCL, card 0 when ranks
    share it, the CPU without CUDA."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", 0)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_workers() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier():
    """Every rank waits for the others (the ps-lite Barrier)."""
    if num_workers() > 1:
        dist.barrier()


def nccl_available() -> bool:
    """Whether this PyTorch build has the NCCL backend."""
    return dist.is_available() and dist.is_nccl_available()


def host_staged() -> Dict[str, int]:
    """How many times each collective was staged through host memory."""
    return dict(_STAGED)


def _staged(op: str, out: torch.Tensor, inp: torch.Tensor, run) -> None:
    """The collective ``op`` on CUDA tensors that gloo does not take,
    through pinned host memory: ``inp`` copied out, ``run(host_out,
    host_in)``, the host result copied into ``out``."""
    _STAGED[op] = _STAGED.get(op, 0) + 1
    h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
    h_in.copy_(inp)
    h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    run(h_out, h_in)
    out.copy_(h_out)


def _needs_staging(op: str, t: torch.Tensor) -> bool:
    return t.is_cuda and backend() == "gloo" and op in GLOO_CUDA_STAGED


def _reduce_op(op: str):
    table = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
             "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    if op not in table:
        raise MXNetError(f"unsupported all_reduce op {op!r}")
    return table[op]


def _raw_all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """In-place all_reduce of ``t`` over ``group``; ``t`` returned."""
    dist.all_reduce(t, op=_reduce_op(op), group=group)
    if op == "mean":
        t.div_(dist.get_world_size(group))
    return t


def _raw_all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0, in rank order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _raw_reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``t``, this rank's 1/n of dim 0."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise MXNetError(f"reduce_scatter: dim 0 ({t.shape[0]}) is not a "
                         f"multiple of the axis size {n}")
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


def _raw_all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 split in n blocks, block j sent to rank j; the received
    blocks concatenated in rank order."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _raw_broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    dist.broadcast(t, src=src, group=group)
    return t


def world_all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The world's all_reduce of ``t``, in place (no gradient: the
    kvstores' wire); ``t`` itself in a one-rank job."""
    if not dist.is_initialized():
        return t
    return _raw_all_reduce(t, op, None)


def world_all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on all) stacked on a new dim 0, in
    rank order."""
    if not dist.is_initialized():
        return t.unsqueeze(0)
    return _raw_all_gather(t.unsqueeze(0), None)


def world_broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` into every rank's ``t``, in place."""
    if not dist.is_initialized():
        return t
    return _raw_broadcast(t, src, None)


def broadcast_from_root(tree):
    """Rank 0's tensors (a tensor, or a list/tuple/dict of them) to every
    rank: new tensors, the inputs untouched."""
    if isinstance(tree, dict):
        return {k: broadcast_from_root(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_root(v) for v in tree)
    if num_workers() == 1:
        return tree
    return _raw_broadcast(tree.detach().clone(), 0, None)


# ---------------------------------------------------------------------------
# in-program collectives over a mesh axis
# ---------------------------------------------------------------------------
def _axis(axis_name, mesh=None):
    """(group, size, index) of ``axis_name`` on ``mesh`` (default the
    current mesh); size 1 and no group where the axis is absent."""
    from .mesh import current_mesh
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return None, 1, 0
    return mesh.group(axis_name), mesh.axis_size(axis_name), \
        mesh.axis_index(axis_name)


def _to_front(t, dim):
    return t if dim == 0 else t.movedim(dim, 0)


def _from_front(t, dim):
    return t if dim == 0 else t.movedim(0, dim)


def _gather(x, group, dim):
    return _from_front(_raw_all_gather(_to_front(x, dim), group), dim)


def _scatter_sum(x, group, dim):
    return _from_front(_raw_reduce_scatter(_to_front(x, dim), group), dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        ctx.op, ctx.group = op, group
        out = _raw_all_reduce(x.detach().clone(), op, group)
        if op in ("max", "min"):
            ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op in ("max", "min"):
            x, out = ctx.saved_tensors
            return g * (x == out).to(g.dtype), None, None
        op = "mean" if ctx.op == "mean" else "sum"
        return _raw_all_reduce(g.clone(), op, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def _permute(x, group, perm, index, size):
    """``perm`` as (source, destination) axis indices: the block this rank
    receives (zeros where no rank sends to it)."""
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == index:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group))
        if dst == index:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if not ops:
        return out
    if _needs_staging("ppermute", x):
        def run(h_out, h_in):
            hops = [dist.P2POp(o.op, h_in if o.tensor is x else h_out,
                               o.peer, group) for o in ops]
            for w in dist.batch_isend_irecv(hops):
                w.wait()
        _staged("ppermute", out, x, run)
        return out
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm, index, size):
        ctx.args = (group, [(d, s) for s, d in perm], index, size)
        return _permute(x, group, perm, index, size)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None, None, None


def _exchange(x, group, n, split, concat):
    """all_to_all: ``split`` cut in n blocks, block j to rank j, the
    received blocks concatenated along ``concat`` in rank order."""
    send = torch.stack(x.chunk(n, dim=split))
    recv = _raw_all_to_all(send, group)
    return torch.cat(list(recv.unbind(0)), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = (group, n, concat, split)
        return _exchange(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g.clone(), "sum", ctx.group), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _raw_all_reduce(x.detach().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, scatter):
        ctx.args = (group, dim, index, x.shape[dim], scatter)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, index, n, scatter = ctx.args
        if scatter:
            n_ranks = dist.get_world_size(group)
            return _scatter_sum(g, group, dim) / n_ranks, None, None, None, \
                None
        return g.narrow(dim, index * n, n), None, None, None, None


class _ScatterToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, n):
        ctx.args = (group, dim)
        return x.narrow(dim, index * (x.shape[dim] // n),
                        x.shape[dim] // n).contiguous()

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _gather(g, group, dim), None, None, None, None


def all_reduce(x, axis_name, op: str = "sum", mesh=None):
    """All-reduce over a mesh axis: "sum", "mean", "max" or "min"."""
    _reduce_op(op)
    group, n, _ = _axis(axis_name, mesh)
    if n == 1:
        return x
    return _AllReduce.apply(x, op, group)


def all_gather(x, axis_name, axis: int = 0, tiled: bool = True, mesh=None):
    """The axis's ranks' ``x`` concatenated along ``axis`` (``tiled``), or
    stacked on a new ``axis``."""
    group, n, _ = _axis(axis_name, mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    if n == 1:
        return x
    return _AllGather.apply(x, group, axis % x.dim())


def reduce_scatter(x, axis_name, axis: int = 0, mesh=None):
    """The sum over the axis's ranks, this rank's 1/n along ``axis``."""
    group, n, _ = _axis(axis_name, mesh)
    if n == 1:
        return x
    return _ReduceScatter.apply(x, group, axis % x.dim())


def ppermute(x, axis_name, perm, mesh=None):
    """Point to point: ``perm`` lists (source, destination) axis indices;
    a rank no one sends to receives zeros."""
    group, n, index = _axis(axis_name, mesh)
    if n == 1:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    return _PPermute.apply(x, group, list(perm), index, n)


def all_to_all(x, axis_name, split_axis: int, concat_axis: int, mesh=None):
    """``split_axis`` cut in n blocks, block j sent to rank j; the n
    blocks received concatenated along ``concat_axis`` in rank order."""
    group, n, _ = _axis(axis_name, mesh)
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, split_axis % x.dim(),
                           concat_axis % x.dim())


def axis_index(axis_name, mesh=None) -> int:
    return _axis(axis_name, mesh)[2]


def axis_size(axis_name, mesh=None) -> int:
    return _axis(axis_name, mesh)[1]


def copy_to_axis(x, axis_name, mesh=None):
    """A replicated activation entering a tensor-parallel region: the
    identity forward, the all_reduce of its gradient backward."""
    group, n, _ = _axis(axis_name, mesh)
    return x if n == 1 else _CopyToAxis.apply(x, group)


def reduce_from_axis(x, axis_name, mesh=None):
    """Partial sums leaving a tensor-parallel region: all_reduce forward,
    the identity backward (every rank holds the same gradient)."""
    group, n, _ = _axis(axis_name, mesh)
    return x if n == 1 else _ReduceFromAxis.apply(x, group)


def gather_from_axis(x, axis_name, dim: int = 0, batch_split: bool = False,
                     mesh=None):
    """A shard gathered for use: all_gather along ``dim`` forward. The
    backward is this rank's slice of the gradient when the axis's ranks
    compute on the same data (``batch_split`` False: their gradients are
    equal), else the mean over the ranks, reduce-scattered."""
    group, n, index = _axis(axis_name, mesh)
    if n == 1:
        return x
    return _GatherFromAxis.apply(x, group, dim % x.dim(), index,
                                 batch_split)


def scatter_to_axis(x, axis_name, dim: int = 0, mesh=None):
    """A tensor every rank of the axis holds whole, split for use: this
    rank's 1/n along ``dim`` forward, the all_gather of the slices'
    gradients backward (the transpose of :func:`gather_from_axis` when the
    axis's ranks compute on the same data: every rank gets the whole
    gradient)."""
    group, n, index = _axis(axis_name, mesh)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise MXNetError(f"scatter_to_axis: dim {dim} ({x.shape[dim]}) is "
                         f"not a multiple of the axis size {n}")
    return _ScatterToAxis.apply(x, group, dim % x.dim(), index, n)


# ---------------------------------------------------------------------------
# the batch split of a data-parallel step
# ---------------------------------------------------------------------------
class sharded_batch:
    """Within it, this rank holds rows ``[index * b, (index + 1) * b)`` of
    a global batch split over the mesh axes ``axes`` (a data-parallel
    step): BatchNorm takes the global batch's moments and Dropout draws the
    global batch's mask, keeping this rank's rows."""

    def __init__(self, mesh, axes):
        axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
        self.state = None
        if axes:
            size, index = 1, 0
            for a in axes:
                size *= mesh.axis_size(a)
                index = index * mesh.axis_size(a) + mesh.axis_index(a)
            self.state = (mesh, axes, index, size)

    def __enter__(self):
        self._prev = getattr(_LOCAL, "batch", None)
        _LOCAL.batch = self.state
        return self

    def __exit__(self, *exc):
        _LOCAL.batch = self._prev


def batch_shard():
    """(mesh, axes, index, size) of the active :class:`sharded_batch`,
    else None."""
    return getattr(_LOCAL, "batch", None)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the active batch split (tape-aware;
    ``t`` itself outside one)."""
    shard = batch_shard()
    if shard is None:
        return t
    mesh, axes = shard[0], shard[1]
    for a in axes:
        t = all_reduce(t, a, "sum", mesh=mesh)
    return t


class tensor_parallel:
    """Within it, blocks whose parameters are sharded over ``axis`` of
    ``mesh`` run their tensor-parallel forwards (BERT's attention heads and
    FFN columns local to the rank, the row-parallel products reduced)."""

    def __init__(self, mesh, axis):
        self.state = (mesh, axis) if axis is not None and \
            mesh.axis_size(axis) > 1 else None

    def __enter__(self):
        self._prev = getattr(_LOCAL, "tp", None)
        _LOCAL.tp = self.state
        return self

    def __exit__(self, *exc):
        _LOCAL.tp = self._prev


def tensor_parallel_axis():
    """(mesh, axis) of the active :class:`tensor_parallel`, else None."""
    return getattr(_LOCAL, "tp", None)
