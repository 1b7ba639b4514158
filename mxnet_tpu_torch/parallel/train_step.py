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

**Resilience** (``mxnet_tpu_torch.resilience``). Each step runs under a
``RetryPolicy`` (``retry_policy=``; ``MXNET_RETRY_*`` by default) at the
``train_step`` fault site (and ``compile`` at the first step). The JAX
package retries a functional step whose state is written only once the
call succeeded; this step updates in place, so the step generator's state
and ``t`` are taken before the first attempt and put back before a retry,
and once the first in-place write of the step has begun (BatchNorm's moving
statistics in the forward, else the optimizer's first update) a retry is
refused with the reference's message: restore from the latest checkpoint.
``state_dict``/``shard_state_dict``/``load_state_dict`` keep the
reference's keys: ``p{i}`` over the block's ``collect_params()`` in order
(trainable and the aux states such as BatchNorm's moving statistics),
``s{j}/l{k}`` over the trainable ones' optimizer state leaves (Adam's mean,
var), ``t``, ``n_params``, ``param_names``, and the port's ``generator``
(the dropout generator's state), which the reference ignores. A
``NumericsGuard`` attached makes every step compute the global gradient
norm and a finite flag on the device and report its retained batch;
``step_n`` is refused while one is attached.

**Telemetry.** ``step`` runs inside a ``train.step`` span (``step_n``
inside one ``train.step_n``) whose host duration feeds
``mxtpu_train_step_latency_us`` and the drift sentinel (``train_step``);
``mxtpu_train_steps_total`` counts steps (``step_n`` its inner ones) and
``mxtpu_train_examples_total`` the global batch's rows. The step's state
(masters, aux states, optimizer state) is a memstats holder sized at every
reconcile. Under a running profiler session a step is one profiler event.
The reference's ``mxtpu_train_donated_replace_total`` has no counterpart:
the port donates no buffers.

Rematerialization (P14/P16) is not ported yet.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..base import DTypes, MXNetError
from ..gluon import Block
from ..ops.registry import _profiler_running
from ..gluon.nn import Dropout
from ..resilience import faults as _faults
from ..resilience.checkpoint import host_array
from ..resilience.numerics import _leaves as _state_leaves
from ..resilience.retry import RetryPolicy
from ..resilience.sharding import ShardedLeaf
from ..telemetry import memstats as _memstats
from ..telemetry import perf_sentinel as _perf_sentinel
from . import collectives
from .mesh import DeviceMesh

__all__ = ["ParallelTrainStep", "shard_of", "unshard"]

# fleet training counters: is the card stepping, and how fast
_STEPS = _telemetry.counter(
    "mxtpu_train_steps_total",
    "Optimizer steps executed (step_n counts its inner steps).")
_EXAMPLES = _telemetry.counter(
    "mxtpu_train_examples_total",
    "Training examples consumed (leading batch dim); rate = examples/s.")
_STEP_LATENCY = _telemetry.histogram(
    "mxtpu_train_step_latency_us",
    "Host-observed latency of one step()/step_n() dispatch (microseconds).")


def _leading_dim(x, axis: int = 0) -> int:
    """The batch rows of an input (a tensor, an NDArray, an array, or the
    first of a tuple of them); 0 when it has none."""
    if isinstance(x, (tuple, list)):
        x = x[0] if x else None
    shape = getattr(x, "shape", None)
    return int(shape[axis]) if shape is not None and len(shape) > axis \
        else 0


def _observe_steps(steps: int, examples: int, dur_us: int):
    """One step()/step_n() dispatch into the training families and the
    drift sentinel (host time; nothing waits for the card)."""
    _STEPS.inc(steps)
    _EXAMPLES.inc(examples)
    _STEP_LATENCY.observe(dur_us)
    _perf_sentinel.observe("train_step", dur_us)


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


def _gluon_params(module) -> list:
    """The Gluon Parameters of ``module`` in ``collect_params()`` order;
    a plain ``torch.nn.Module`` wrapper (``tools.PretrainStep``) is walked
    through to the Blocks it holds."""
    if isinstance(module, Block):
        return list(module.collect_params().values())
    out, seen = [], set()
    for child in module.children():
        for p in _gluon_params(child):
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


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
    any other is whole on every rank. ``retry_policy`` (a
    ``resilience.RetryPolicy``, default from the ``MXNET_RETRY_*`` flags)
    retries a step that fails transiently before its first in-place
    write."""

    def __init__(self, block: torch.nn.Module, loss, optimizer,
                 mesh: DeviceMesh, *, data_spec=None, label_spec=None,
                 extra_specs: Sequence = (), compute_dtype=None,
                 seed: int = 0, retry_policy=None):
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
        self._order = self._reference_order()
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
        self._retry = retry_policy if retry_policy is not None \
            else RetryPolicy.from_config()
        self._built = False         # the "compile" fault site's first run
        self._writing = False       # an in-place write of this step began
        # the forward writes state in place (BatchNorm's moving statistics)
        self._forward_writes = any(kind == "aux" for kind, _ in self._order)
        self._guard = None
        # device-memory attribution: masters, aux states and optimizer
        # state, sized live at every reconcile
        _memstats.register(
            "train", f"train_step.state.{id(self):x}", owner=self,
            device=_memstats.device_label(self._device),
            sizer=lambda ts: _memstats.nbytes_of(
                [ts._ordered_tensors(), ts._states]))

    def _reference_order(self):
        """The reference's positional order of the step's state: the
        block's ``collect_params()``, each ``("p", i)`` for the trainable
        ``_plist[i]`` or ``("aux", get)`` for an aux state (``get()`` reads
        it through its Parameter, which follows module conversions); then,
        for a plain ``torch.nn.Module``, the trained tensors and buffers
        no Gluon Parameter holds, in module order."""
        index = {id(p): i for i, p in enumerate(self._plist)}
        order, seen, held = [], set(), set()
        self._order_names = []
        for gp in _gluon_params(self._block):
            if gp._var is None:
                continue
            self._order_names.append(gp.name)
            held.add(id(gp._var))
            i = index.get(id(gp._var))
            if i is None:
                order.append(("aux", lambda gp=gp: gp._var))
            else:
                order.append(("p", i))
                seen.add(i)
        for i, name in enumerate(self._names):
            if i not in seen:
                order.append(("p", i))
                self._order_names.append(name)
        for name, b in self._block.named_buffers():
            if id(b) not in held:
                order.append(("aux", lambda n=name:
                              self._block.get_buffer(n)))
                self._order_names.append(name)
        return order

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

    def _compute(self, x, y, extras, poison=None, lrs=None, wds=None):
        """Forward, backward and update with ``t`` already advanced; the
        loss and, with a guard attached, the (gradient norm, finite)
        device scalars. ``poison`` multiplies the loss before the backward
        (the guard's corruption of an integer batch); ``lrs``/``wds``
        replace the schedule's rows (an exact replay)."""
        opt = self._optimizer
        if opt.lr_scheduler is not None:
            opt.num_update = self._t
        self._block.train()
        self._writing = self._forward_writes
        with self._mesh, self._rows, self._tp:
            loss = self._forward_loss(x, y, extras)
            if poison is not None:
                loss = loss * poison
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
        health = None
        if self._guard is not None:
            norms = torch._foreach_norm(grads)
            gnorm = torch.linalg.vector_norm(torch.stack(norms))
            health = (gnorm, torch.isfinite(loss.detach())
                      & torch.isfinite(gnorm))
        self._writing = True
        # the range lets tools/step_profile.py attribute the update's kernels
        with torch.no_grad(), torch.profiler.record_function("mxt.optimizer"):
            for i, (w, g, s) in enumerate(zip(self._plist, grads,
                                              self._states)):
                g = g * opt.rescale_grad
                if opt.clip_gradient is not None:
                    g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
                lr = opt._get_lr(i) if lrs is None else lrs[i]
                wd = opt._get_wd(i) if wds is None else wds[i]
                opt._rule(w, g, s, lr, wd, np.float32(self._t))
        return loss.detach(), health

    def _step_impl(self, x, y, extras, poison=None):
        """One step under the retry policy: the guard's input shim, then
        the attempts, each at the ``train_step`` fault site."""
        injected = None
        if self._guard is not None:
            x, y, injected, shim = self._guard.intercept(x, y)
            poison = shim if shim is not None else poison
        t0 = self._t
        key = self.generator.get_state()

        def attempt():
            _faults.check("train_step")
            if not self._built:
                _faults.check("compile")
                self._built = True
            self._t = t0 + 1
            return self._compute(x, y, extras, poison)

        def pre_retry(exc, attempt, delay_s):
            if self._writing:
                raise MXNetError(
                    "cannot retry train step: its in-place update of the "
                    "parameters or the optimizer state had begun when it "
                    "failed; restore from the latest checkpoint "
                    "(resilience.CheckpointManager) instead") from exc
            self.generator.set_state(key)
            self._t = t0

        self._writing = False
        try:
            loss, health = self._retry.run(attempt, site="train_step",
                                           on_retry=pre_retry)
        except BaseException:
            if not self._writing:
                self._t = t0
                self.generator.set_state(key)
            raise
        if self._guard is not None:
            opt = self._optimizer
            self._guard.observe(
                x=x, y=y, extras=extras, key=key,
                lrs=[opt._get_lr(i) for i in range(len(self._plist))],
                wds=[opt._get_wd(i) for i in range(len(self._plist))],
                t=self._t, loss=loss, health=health, poison=poison,
                injected=injected)
        return loss

    def step(self, x, y, *extras):
        """One training step on the global batch ``x``, ``y`` (each rank
        keeps its rows); returns the global batch's loss (0-d f32)."""
        examples = _leading_dim(x)
        with _telemetry.span("train.step", examples=examples) as sp:
            if _profiler_running():
                from .. import profiler
                out = profiler._dispatch_profiled(
                    "ParallelTrainStep", lambda: self._step(x, y, extras))
            else:
                out = self._step(x, y, extras)
        _observe_steps(1, examples, sp.dur_us)
        return out

    def _step(self, x, y, extras):
        x, y, extras = self._local_inputs(x, y, extras)
        return self._step_impl(self._place(x), _tree_map(self._place, y),
                               tuple(self._place(e) for e in extras))

    __call__ = step

    def step_n(self, xs, ys, *extras_s):
        """K training steps over inputs stacked on a leading K axis; returns
        the (K,) losses. Equal to K :meth:`step` calls on the same slices,
        dropout included (one generator, drawn in the same order). Refused
        while a NumericsGuard is attached (drive the loop with
        :meth:`step`)."""
        if self._guard is not None:
            raise MXNetError(
                "step_n() is not supported with a NumericsGuard attached: "
                "the guard's skip/rewind recovery needs per-step batch "
                "retention and generator accounting — drive the loop with "
                "step()")
        k = _leading_dim(xs)
        examples = _leading_dim(xs, axis=1) * k if k else 0
        with _telemetry.span("train.step_n", steps=k,
                             examples=examples) as sp:
            if _profiler_running():
                from .. import profiler
                out = profiler._dispatch_profiled(
                    "ParallelTrainStep.step_n",
                    lambda: self._step_n(xs, ys, extras_s))
            else:
                out = self._step_n(xs, ys, extras_s)
        _observe_steps(k, examples, sp.dur_us)
        return out

    def _step_n(self, xs, ys, extras_s):
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

    # ------------------------------------------------------------------
    # resilience: the numerics guard, exact replay, the checkpoint surface
    # ------------------------------------------------------------------
    def _attach_numerics_guard(self, guard):
        """Bind a ``resilience.NumericsGuard`` (use ``guard.attach``)."""
        self._guard = guard

    def replay_exact(self, x, y, extras, key, lrs, wds, t, poison=None):
        """Re-execute one step with the inputs it consumed: the placed
        batch, the generator state ``key`` it started from, its lr and wd
        rows and its ``t``; the SDC-screening and repro-bundle path. Takes
        nothing from the schedules and reports to no guard."""
        self.generator.set_state(key.cpu() if isinstance(key, torch.Tensor)
                                 else torch.as_tensor(key, dtype=torch.uint8))
        self._t = int(t)
        loss, _ = self._compute(x, y, tuple(extras), poison,
                                [float(v) for v in lrs],
                                [float(v) for v in wds])
        return loss

    def _ordered_tensors(self):
        """The state's tensors in the reference's positional order (the
        ``p{i}``): trained masters (this rank's shards) and aux states."""
        return [self._plist[ref] if kind == "p" else ref()
                for kind, ref in self._order]

    def _trainable_order(self):
        """``_plist`` indices of the reference's trainable parameters, in
        its order (the ``s{j}``)."""
        return [ref for kind, ref in self._order if kind == "p"]

    def _snapshot(self) -> Dict:
        """On-device copies of the state (the guard's anchor): parameters
        and aux states, optimizer states, the generator and ``t``."""
        with torch.no_grad():
            return {"params": [t.detach().clone()
                               for t in self._ordered_tensors()],
                    "opt": [tuple(leaf.detach().clone() for leaf in
                                  _state_leaves(self._states[i]))
                            for i in self._trainable_order()],
                    "generator": self.generator.get_state(),
                    "t": int(self._t)}

    def _restore_snapshot(self, snap: Dict):
        """Copy a :meth:`_snapshot` back into the live tensors (the
        snapshot stays intact for another attempt)."""
        with torch.no_grad():
            for t, s in zip(self._ordered_tensors(), snap["params"]):
                t.copy_(s)
            for i, saved in zip(self._trainable_order(), snap["opt"]):
                for leaf, s in zip(_state_leaves(self._states[i]), saved):
                    leaf.copy_(s)
        self.generator.set_state(snap["generator"])
        self._t = int(snap["t"])

    @staticmethod
    def _snapshot_bytes(snap: Dict) -> int:
        return sum(t.numel() * t.element_size() for t in
                   list(snap["params"]) + [leaf for st in snap["opt"]
                                           for leaf in st])

    def _header(self) -> Dict:
        return {"kind": "ParallelTrainStep", "version": 1,
                "t": int(self._t), "n_params": len(self._order),
                "param_names": ",".join(self._order_names)}

    def _gathered(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """``t`` (parameter ``i``'s tensor or a state leaf of its shape)
        gathered whole when ``i`` is sharded (a collective)."""
        sh = self._shards.get(i)
        if sh is None:
            return t.detach()
        g = collectives.all_gather(t.detach(), sh.axis, axis=sh.dim,
                                   mesh=self._mesh)
        return unshard(g.chunk(sh.n, dim=sh.dim), sh.dim, sh.blocks)

    def state_dict(self) -> Dict:
        """Host copy of the training state in the reference's keys
        (sharded parameters and their states gathered: every rank of the
        job must call it)."""
        st = self._header()
        st["params"] = {}
        for k, (kind, ref) in enumerate(self._order):
            t = self._gathered(ref, self._plist[ref]) if kind == "p" \
                else ref()
            st["params"][f"p{k}"] = host_array(t)
        st["opt"] = {f"s{j}": {f"l{k}": host_array(self._gathered(i, leaf))
                               for k, leaf in enumerate(
                                   _state_leaves(self._states[i]))}
                     for j, i in enumerate(self._trainable_order())}
        st["generator"] = host_array(self.generator.get_state())
        return st

    def shard_state_dict(self) -> Dict:
        """:meth:`state_dict` with every leaf a ``ShardedLeaf``: a sharded
        parameter and its states as each rank's shard (written by the rank
        holding it), a whole one written by the rank at coordinate 0 of
        every axis. A parameter split in blocks (a fused QKV) is gathered
        and written whole: its shard is not one slice of it."""
        mesh = self._mesh
        origin = {a: 0 for a in mesh.axis_names}

        def leaf(i, t):
            sh = self._shards.get(i) if i is not None else None
            if sh is None or sh.blocks > 1:
                full = t.detach() if sh is None else self._gathered(i, t)
                return ShardedLeaf.whole(host_array(full), writer=0,
                                         rank=mesh.rank)
            writers = [mesh._rank_of({**origin, sh.axis: k})
                       for k in range(sh.n)]
            mine = mesh.rank == writers[sh.index]
            return ShardedLeaf.split(host_array(t), sh.dim, writers,
                                     sh.index if mine else -1)

        st = self._header()
        st["mesh_devices"] = int(mesh.size)
        st["params"] = {f"p{k}": leaf(ref, self._plist[ref]) if kind == "p"
                        else leaf(None, ref())
                        for k, (kind, ref) in enumerate(self._order)}
        st["opt"] = {f"s{j}": {f"l{k}": leaf(i, x) for k, x in enumerate(
            _state_leaves(self._states[i]))}
            for j, i in enumerate(self._trainable_order())}
        st["generator"] = host_array(self.generator.get_state())
        return st

    def load_state_dict(self, state: Dict):
        """Restore a state (this step's :meth:`state_dict`, an assembled
        sharded one, or the JAX package's ``ParallelTrainStep`` state) into
        this step, each rank taking its own shard of a sharded parameter;
        the next step continues as the run that saved it would have."""
        if state.get("kind") != "ParallelTrainStep":
            raise MXNetError(f"not a ParallelTrainStep state: "
                             f"{state.get('kind')!r}")
        if int(state["n_params"]) != len(self._order):
            raise MXNetError(
                "checkpoint does not match this model: expected "
                f"{len(self._order)} params, got {state['n_params']} "
                f"({state.get('param_names')})")

        def local(i, arr, like):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            sh = self._shards.get(i) if i is not None else None
            if sh is not None:
                t = shard_of(t, sh.dim, sh.n, sh.index, sh.blocks)
            if tuple(t.shape) != tuple(like.shape):
                raise MXNetError(f"checkpoint leaf shape {tuple(t.shape)} "
                                 f"vs {tuple(like.shape)}")
            return t

        saved_opt = state.get("opt", {})
        with torch.no_grad():
            for k, (kind, ref) in enumerate(self._order):
                arr = np.asarray(state["params"][f"p{k}"])
                live = self._plist[ref] if kind == "p" else ref()
                full = list(live.shape)
                sh = self._shards.get(ref) if kind == "p" else None
                if sh is not None:
                    full[sh.dim] *= sh.n
                if tuple(arr.shape) != tuple(full):
                    raise MXNetError(
                        f"checkpoint param {k} ({self._order_names[k]}) "
                        f"shape mismatch: {arr.shape} vs {tuple(full)}")
                live.copy_(local(ref if kind == "p" else None, arr, live))
            for j, i in enumerate(self._trainable_order()):
                leaves = _state_leaves(self._states[i])
                saved = saved_opt.get(f"s{j}", {})
                if len(saved) != len(leaves):
                    raise MXNetError(f"optimizer state {j} arity mismatch: "
                                     f"{len(saved)} vs {len(leaves)}")
                for k, leaf in enumerate(leaves):
                    leaf.copy_(local(i, np.asarray(saved[f"l{k}"]), leaf))
        self._t = int(state["t"])
        if "generator" in state:
            self.generator.set_state(torch.from_numpy(
                np.array(state["generator"], np.uint8)))
        if self._guard is not None:
            # retained records predate the restored state: re-anchor
            self._guard.reset()
