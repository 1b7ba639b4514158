"""ParallelTrainStep of the port: the one-device training step of
``mxnet_tpu/parallel/train_step.py``.

One ``step()`` does one iteration of the training loop: forward of the
block, the loss (mean of the loss block's output, in f32), its gradient,
then ``rescale_grad``, gradient clipping and the optimizer's rule for every
parameter, with the update count ``t`` advanced once per step and handed
to the rule as an f32 scalar, as the reference hands it (so Adam's bias
correction ``beta ** t`` rounds in f32 there and here, as in the port's
``Trainer``). The JAX
package compiles this into one XLA program per step (and a ``lax.scan`` of
it for ``step_n``); PyTorch runs it eagerly, so ``step_n`` is a loop of the
same step and equals K ``step()`` calls exactly.

Mixed precision as the reference does it (``train_step.py:206-221``): the
parameters stay float32 masters on the mesh's device; with
``compute_dtype`` every floating parameter is cast for the forward
(``torch.func.functional_call`` with the cast tensors), so gradients reach
the masters through the cast. Not ``torch.autocast``: its per-op policy is
another recipe.

BatchNorm's moving statistics (the reference's aux states, written back as
extra outputs of its step, ``train_step.py:261-266``) are float32 buffers of
the block, not parameters: the cast above never touches them, and each
``BatchNorm`` writes its updated moving mean and variance back into its own
buffers, in place and in f32, during the step's one forward. So every step
updates them exactly once, and ``step_n(K)`` equals K steps for them too.

The step owns the ``torch.Generator`` that feeds every ``Dropout`` of the
block (seeded by ``seed``).

**On a mesh of several ranks** (one process each, ``make_mesh`` in a job
that ``tools/launch.py`` started) the JAX package's one global program is
written out per rank:

- *data parallel*: every rank is handed the global batch and keeps its rows
  of the batch axes (``data_spec``, default ``dp``); the loss is the mean
  over the global batch; after the backward every gradient is all-reduced
  (a mean) over the batch axes, coalesced into one buffer per dtype.
  BatchNorm takes the global batch's moments, and Dropout draws the global
  batch's mask and keeps the rank's rows (``collectives.sharded_batch``),
  so a dp=2 step computes what a dp=1 step does on the same batch, up to
  the order of the reductions.
- *tensor and fully sharded data parallel*: a parameter with a partition
  spec (``Parameter.shard``) is held as this rank's shard, and so is its
  optimizer state. Blocks that compute on shards (``tp_local_params``:
  BERT's attention and FFN) get the shard and run their tensor-parallel
  forward; every other sharded parameter is all-gathered for use, its
  gradient the rank's slice (``collectives.gather_from_axis``). A whole
  parameter's gradient is averaged over the tensor-parallel axis too: the
  ranks compute it alike but for the summation order of kernels whose
  order varies from call to call on the card (PyTorch's CUDA embedding
  backward does, at BERT's two-row token-type table:
  ``tools/grad_determinism.py``), and the mean keeps them bitwise equal.
  :meth:`sync_to_block` gathers the shards back into the block's
  Parameters. A fused QKV weight (``shard(spec, blocks=3)``) is split per
  block: a rank's shard holds the Q, K and V rows of its heads.

Retry, the numerics guard, telemetry and rematerialization (P14/P16) are
not ported yet.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from ..base import DTypes, MXNetError
from ..gluon import Block
from ..gluon.nn import Dropout
from . import collectives
from .mesh import DeviceMesh

__all__ = ["ParallelTrainStep", "shard_of", "unshard"]


def _tree_map(fn, y):
    return type(y)(fn(a) for a in y) if isinstance(y, (tuple, list)) \
        else fn(y)


def _spec_axes(spec):
    """The mesh axes a spec's first entry names (a data spec: the batch
    axes)."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    spec = tuple(spec)
    if not spec or spec[0] is None:
        return ()
    return tuple(spec[0]) if isinstance(spec[0], (tuple, list)) \
        else (spec[0],)


def _split_dim(spec, mesh):
    """(dim, axis) of the one dimension a parameter's spec splits over an
    axis of ``mesh`` larger than 1, else None."""
    if spec is None:
        return None
    spec = (spec,) if isinstance(spec, str) else tuple(spec)
    found = []
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        names = [a for a in names if a is not None and
                 mesh.axis_size(a) > 1]
        if len(names) > 1:
            raise MXNetError(f"spec {spec}: one mesh axis a dimension")
        if names:
            found.append((d, names[0]))
    if len(found) > 1:
        raise MXNetError(f"spec {spec}: one sharded dimension a parameter")
    return found[0] if found else None


def shard_of(t: torch.Tensor, dim: int, n: int, index: int,
             blocks: int = 1) -> torch.Tensor:
    """Rank ``index``'s shard of ``t`` split n ways along ``dim``; with
    ``blocks`` > 1 the dimension is that many equal blocks, each split
    alike, and the shard holds the rank's part of every block in order."""
    parts = t.chunk(blocks, dim=dim)
    return torch.cat([p.chunk(n, dim=dim)[index] for p in parts], dim=dim)


def unshard(shards, dim: int, blocks: int = 1) -> torch.Tensor:
    """The tensor whose :func:`shard_of` over ``len(shards)`` ranks are
    ``shards`` (in rank order)."""
    per = [s.chunk(blocks, dim=dim) for s in shards]
    return torch.cat([torch.cat([p[b] for p in per], dim=dim)
                      for b in range(blocks)], dim=dim)


class _Shard:
    """How one trained parameter is split: ``dim`` over ``axis``
    (``n`` ranks, this one ``index``), in ``blocks`` blocks; ``local``
    when its block computes on the shard."""

    __slots__ = ("dim", "axis", "n", "index", "blocks", "local",
                 "batch_split")


class ParallelTrainStep:
    """Forward + backward + update of ``block`` on ``mesh`` (this rank's
    part of it). The block's Gluon parameters must be initialized (or
    loaded); it is called with tensors, in the module's training mode.

    ``step(x, y, *extras)`` calls ``block(x, *extras)``, then
    ``loss(*outputs, *labels)`` with ``y`` a label array or a tuple/list of
    them, updates the parameters in place and returns the loss as a 0-d f32
    tensor on the device (not synchronized). ``step_n(xs, ys, *extras_s)``
    takes inputs with a leading K axis and returns the (K,) losses.
    ``data_spec``, ``label_spec`` and ``extra_specs`` (one per extra input)
    are the reference's placements: an input whose spec's first entry
    names the batch axes is split over them (each rank keeps its rows),
    any other is whole on every rank."""

    def __init__(self, block: torch.nn.Module, loss, optimizer,
                 mesh: DeviceMesh, *, data_spec=None, label_spec=None,
                 extra_specs: Sequence = (), compute_dtype=None,
                 seed: int = 0):
        missing = [p.name for m in block.modules() if isinstance(m, Block)
                   for p in m._reg_params.values() if p._var is None]
        if missing:
            raise MXNetError(f"ParallelTrainStep: parameters not initialized "
                             f"{missing[:5]} (of {len(missing)}); call "
                             "initialize() or load the weights first")
        self._mesh = mesh
        self._device = mesh.device
        self._block = block.to(self._device)
        self._loss = loss
        self._optimizer = optimizer
        self._n_extras = len(extra_specs)
        self._compute_dtype = None if compute_dtype is None \
            else DTypes.torch(compute_dtype)
        if data_spec is None and "dp" in mesh.axis_names:
            data_spec = ("dp",)
        self._batch_axes = tuple(a for a in _spec_axes(data_spec)
                                 if mesh.axis_size(a) > 1)
        label_axes = self._batch_axes if label_spec is None else tuple(
            a for a in _spec_axes(label_spec) if mesh.axis_size(a) > 1)
        if label_axes != self._batch_axes:
            raise MXNetError(f"label_spec {label_spec} must split the batch "
                             f"as data_spec {data_spec} does")
        self._extra_split = [bool(_spec_axes(sp)) and
                             _spec_axes(sp)[0] in self._batch_axes
                             for sp in extra_specs]
        self._rows = collectives.sharded_batch(mesh, self._batch_axes)
        named = [(n, p) for n, p in self._block.named_parameters()
                 if p.requires_grad]
        self._names = [n for n, _ in named]
        self._plist = [p for _, p in named]
        self._shards: Dict[int, _Shard] = {}
        self._shard_params(mesh)
        self._states = [optimizer.create_state(i, p)
                        for i, p in enumerate(self._plist)]
        self._t = 0
        #: host seconds of the gradient all-reduces, summed over steps
        self.comm_seconds = 0.0
        self.generator = torch.Generator(device=self._device)
        self.generator.manual_seed(seed)
        for m in self._block.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator

    def _shard_params(self, mesh):
        """Replace each parameter with a partition spec over an axis of
        ``mesh`` larger than 1 by this rank's shard, a leaf of its own."""
        by_tensor = {id(p._var): p for m in self._block.modules()
                     if isinstance(m, Block) for p in m._reg_params.values()
                     if p._var is not None}
        local = {id(p) for m in self._block.modules()
                 if hasattr(m, "tp_local_params")
                 for p in m.tp_local_params()}
        tp_axes = set()
        for i, t in enumerate(self._plist):
            param = by_tensor.get(id(t))
            split = _split_dim(getattr(param, "_sharding", None), mesh)
            if split is None:
                continue
            sh = _Shard()
            sh.dim, sh.axis = split
            sh.n, sh.index = mesh.axis_size(sh.axis), \
                mesh.axis_index(sh.axis)
            sh.blocks = param._shard_blocks
            sh.local = id(param) in local
            sh.batch_split = sh.axis in self._batch_axes
            if sh.local:
                if sh.batch_split:
                    raise MXNetError(f"{param.name}: a block computing on "
                                     "its shard needs the batch whole "
                                     f"along {sh.axis!r}")
                tp_axes.add(sh.axis)
            with torch.no_grad():
                part = shard_of(t.detach(), sh.dim, sh.n, sh.index,
                                sh.blocks).clone()
            self._plist[i] = torch.nn.Parameter(part)
            self._shards[i] = sh
        if len(tp_axes) > 1:
            raise MXNetError(f"tensor-parallel blocks over several axes "
                             f"{sorted(tp_axes)}")
        self._tp = collectives.tensor_parallel(
            mesh, tp_axes.pop() if tp_axes else None)
        # gradient all-reduce groups: every axis but a parameter's shard
        # axis. Over the batch axes that is the mean of the ranks' rows;
        # over an axis that splits no data (tp) the ranks' gradients of a
        # whole parameter are equal but for the summation order of their
        # kernels (the embedding backward's varies on the card), and the
        # mean keeps the ranks bitwise equal
        axes = [a for a in mesh.axis_names if mesh.axis_size(a) > 1]
        self._reduce_axes = [
            tuple(a for a in axes
                  if i not in self._shards or self._shards[i].axis != a)
            for i in range(len(self._plist))]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The trained parameters by name (the float32 masters, updated in
        place by every step; this rank's shard of a sharded one)."""
        return dict(zip(self._names, self._plist))

    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        """The block's buffers by name (BatchNorm's moving statistics, in
        float32, updated in place by every step)."""
        return dict(self._block.named_buffers())

    def global_params(self) -> Dict[str, torch.Tensor]:
        """The trained parameters by name, sharded ones gathered whole (in
        the reference's global order)."""
        out = {}
        for i, (name, t) in enumerate(zip(self._names, self._plist)):
            sh = self._shards.get(i)
            if sh is None:
                out[name] = t.detach()
                continue
            g = collectives.all_gather(t.detach(), sh.axis, axis=sh.dim,
                                       mesh=self._mesh)
            out[name] = unshard(g.chunk(sh.n, dim=sh.dim), sh.dim,
                                sh.blocks)
        return out

    def sync_to_block(self):
        """Write the trained parameters (sharded ones gathered) into the
        block's Gluon Parameters."""
        if not self._shards:
            return
        full = self.global_params()
        own = dict(self._block.named_parameters())
        with torch.no_grad():
            for i in self._shards:
                own[self._names[i]].copy_(full[self._names[i]])

    def _place(self, a):
        return torch.as_tensor(a).to(self._device, non_blocking=True)

    def _rows_of(self, a, dim=0):
        """This rank's rows of a global batch array along ``dim``."""
        st = self._rows.state
        if st is None:
            return a
        index, size = st[2], st[3]
        n = a.shape[dim]
        if n % size:
            raise MXNetError(f"batch of {n} rows does not split over "
                             f"{self._batch_axes} ({size} ranks)")
        return a.narrow(dim, index * (n // size), n // size)

    def _local_inputs(self, x, y, extras, dim=0):
        if len(extras) != self._n_extras:
            raise MXNetError(f"step got {len(extras)} extra inputs, "
                             f"extra_specs names {self._n_extras}")
        x = self._rows_of(torch.as_tensor(x), dim)
        y = _tree_map(lambda a: self._rows_of(torch.as_tensor(a), dim), y)
        extras = tuple(self._rows_of(torch.as_tensor(e), dim) if split
                       else torch.as_tensor(e)
                       for e, split in zip(extras, self._extra_split))
        return x, y, extras

    def _forward_loss(self, x, y, extras):
        cd = self._compute_dtype
        if cd is None and not self._shards:
            outs = self._block(x, *extras)
        else:
            use = {}
            for i, (n, p) in enumerate(zip(self._names, self._plist)):
                t = p.to(cd) if cd is not None and p.is_floating_point() \
                    else p
                sh = self._shards.get(i)
                if sh is not None and not sh.local:
                    t = collectives.gather_from_axis(
                        t, sh.axis, sh.dim, sh.batch_split, self._mesh)
                    t = unshard(t.chunk(sh.n, dim=sh.dim), sh.dim, sh.blocks)
                use[n] = t
            if cd is not None and x.is_floating_point():
                x = x.to(cd)
            outs = torch.func.functional_call(self._block, use,
                                              (x,) + tuple(extras))
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        labels = y if isinstance(y, (tuple, list)) else (y,)
        # the range lets tools/step_profile.py attribute the loss's kernels
        with torch.profiler.record_function("mxt.loss"):
            return self._loss(*outs, *labels).float().mean()

    def _reduce_grads(self, grads):
        """Every gradient's mean over its reduce axes, one all-reduce per
        (axes, dtype) over a flat buffer; the host time is summed in
        ``comm_seconds``."""
        start = time.perf_counter()
        groups: Dict = {}
        for i, g in enumerate(grads):
            if self._reduce_axes[i]:
                groups.setdefault((self._reduce_axes[i], g.dtype),
                                  []).append(i)
        for (axes, _), idx in groups.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            for a in axes:
                flat = collectives.all_reduce(flat, a, "mean",
                                              mesh=self._mesh)
            for i, part in zip(idx, flat.split([grads[i].numel()
                                                for i in idx])):
                grads[i] = part.view_as(grads[i])
        self.comm_seconds += time.perf_counter() - start
        return grads

    def _step_impl(self, x, y, extras):
        opt = self._optimizer
        self._t += 1
        if opt.lr_scheduler is not None:
            opt.num_update = self._t
        self._block.train()
        with self._mesh, self._rows, self._tp:
            loss = self._forward_loss(x, y, extras)
            grads = list(torch.autograd.grad(loss, self._plist,
                                             allow_unused=True))
        grads = [torch.zeros_like(w) if g is None else g.to(w.dtype)
                 for w, g in zip(self._plist, grads)]
        if any(self._reduce_axes):
            grads = self._reduce_grads(grads)
        if self._batch_axes:
            loss = loss.detach()
            for a in self._batch_axes:
                loss = collectives.all_reduce(loss, a, "mean",
                                              mesh=self._mesh)
        # the range lets tools/step_profile.py attribute the update's kernels
        with torch.no_grad(), torch.profiler.record_function("mxt.optimizer"):
            for i, (w, g, s) in enumerate(zip(self._plist, grads,
                                              self._states)):
                g = g * opt.rescale_grad
                if opt.clip_gradient is not None:
                    g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
                opt._rule(w, g, s, opt._get_lr(i), opt._get_wd(i),
                          np.float32(self._t))
        return loss.detach()

    def step(self, x, y, *extras):
        """One training step on the global batch ``x``, ``y`` (each rank
        keeps its rows); returns the global batch's loss (0-d f32)."""
        x, y, extras = self._local_inputs(x, y, extras)
        return self._step_impl(self._place(x), _tree_map(self._place, y),
                               tuple(self._place(e) for e in extras))

    __call__ = step

    def step_n(self, xs, ys, *extras_s):
        """K training steps over inputs stacked on a leading K axis; returns
        the (K,) losses. Equal to K :meth:`step` calls on the same slices,
        dropout included (one generator, drawn in the same order)."""
        xs, ys, *extras_s = self.place_batch_n(xs, ys, *extras_s)
        xs, ys, extras_s = self._local_inputs(xs, ys, extras_s, dim=1)
        losses = [self._step_impl(xs[i], _tree_map(lambda a: a[i], ys),
                                  tuple(e[i] for e in extras_s))
                  for i in range(xs.shape[0])]
        return torch.stack(losses)

    def place_batch_n(self, xs, ys, *extras_s):
        """Stacked (K, ...) global inputs moved to the mesh's device once,
        for loops that call :meth:`step_n` on the same arrays."""
        return (self._place(xs), _tree_map(self._place, ys)) + \
            tuple(self._place(e) for e in extras_s)
