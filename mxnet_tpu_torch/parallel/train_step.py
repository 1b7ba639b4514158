"""ParallelTrainStep of the port: the one-device training step of
``mxnet_tpu/parallel/train_step.py``.

One ``step()`` does one iteration of the training loop: forward of the
block, the loss (mean of the loss block's output, in f32), its gradient,
then ``rescale_grad``, gradient clipping and the optimizer's rule for every
parameter, with the update count ``t`` advanced once per step. The JAX
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
block (seeded by ``seed``). Multi-device meshes (P9), retry, the numerics
guard, telemetry and rematerialization (P14/P16) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..base import DTypes, MXNetError
from ..gluon.nn import Dropout
from .mesh import DeviceMesh

__all__ = ["ParallelTrainStep"]


def _tree_map(fn, y):
    return type(y)(fn(a) for a in y) if isinstance(y, (tuple, list)) \
        else fn(y)


class ParallelTrainStep:
    """Forward + backward + update of ``block`` on a one-device ``mesh``.

    ``step(x, y, *extras)`` calls ``block(x, *extras)``, then
    ``loss(*outputs, *labels)`` with ``y`` a label array or a tuple/list of
    them, updates the parameters in place and returns the loss as a 0-d f32
    tensor on the device (not synchronized). ``step_n(xs, ys, *extras_s)``
    takes inputs with a leading K axis and returns the (K,) losses.
    ``extra_specs`` names one placement per extra input, as in the
    reference; on one device every input goes to the mesh's device."""

    def __init__(self, block: torch.nn.Module, loss, optimizer,
                 mesh: DeviceMesh, *, extra_specs: Sequence = (),
                 compute_dtype=None, seed: int = 0):
        self._device = mesh.device
        self._block = block.to(self._device)
        self._loss = loss
        self._optimizer = optimizer
        self._n_extras = len(extra_specs)
        self._compute_dtype = None if compute_dtype is None \
            else DTypes.torch(compute_dtype)
        named = [(n, p) for n, p in self._block.named_parameters()
                 if p.requires_grad]
        self._names = [n for n, _ in named]
        self._plist = [p for _, p in named]
        self._states = [optimizer.create_state(i, p)
                        for i, p in enumerate(self._plist)]
        self._t = 0
        self.generator = torch.Generator(device=self._device)
        self.generator.manual_seed(seed)
        for m in self._block.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The trained parameters by name (the float32 masters, updated in
        place by every step)."""
        return dict(zip(self._names, self._plist))

    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        """The block's buffers by name (BatchNorm's moving statistics, in
        float32, updated in place by every step)."""
        return dict(self._block.named_buffers())

    def _place(self, a):
        return torch.as_tensor(a).to(self._device, non_blocking=True)

    def _forward_loss(self, x, y, extras):
        cd = self._compute_dtype
        if cd is None:
            outs = self._block(x, *extras)
        else:
            cast = {n: p.to(cd) if p.is_floating_point() else p
                    for n, p in zip(self._names, self._plist)}
            if x.is_floating_point():
                x = x.to(cd)
            outs = torch.func.functional_call(self._block, cast,
                                              (x,) + tuple(extras))
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        labels = y if isinstance(y, (tuple, list)) else (y,)
        return self._loss(*outs, *labels).float().mean()

    def _step_impl(self, x, y, extras):
        if len(extras) != self._n_extras:
            raise MXNetError(f"step got {len(extras)} extra inputs, "
                             f"extra_specs names {self._n_extras}")
        opt = self._optimizer
        self._t += 1
        if opt.lr_scheduler is not None:
            opt.num_update = self._t
        self._block.train()
        loss = self._forward_loss(x, y, extras)
        grads = torch.autograd.grad(loss, self._plist, allow_unused=True)
        # the range lets tools/step_profile.py attribute the update's kernels
        with torch.no_grad(), torch.profiler.record_function("mxt.optimizer"):
            for i, (w, g, s) in enumerate(zip(self._plist, grads,
                                              self._states)):
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                g = g * opt.rescale_grad
                if opt.clip_gradient is not None:
                    g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
                opt._rule(w, g, s, opt._get_lr(i), opt._get_wd(i), self._t)
        return loss.detach()

    def step(self, x, y, *extras):
        """One training step; returns the loss (0-d f32 tensor)."""
        return self._step_impl(self._place(x), _tree_map(self._place, y),
                               tuple(self._place(e) for e in extras))

    __call__ = step

    def step_n(self, xs, ys, *extras_s):
        """K training steps over inputs stacked on a leading K axis; returns
        the (K,) losses. Equal to K :meth:`step` calls on the same slices,
        dropout included (one generator, drawn in the same order)."""
        xs, ys, *extras_s = self.place_batch_n(xs, ys, *extras_s)
        losses = [self._step_impl(xs[i], _tree_map(lambda a: a[i], ys),
                                  tuple(e[i] for e in extras_s))
                  for i in range(xs.shape[0])]
        return torch.stack(losses)

    def place_batch_n(self, xs, ys, *extras_s):
        """Stacked (K, ...) inputs moved to the mesh's device once, for
        loops that call :meth:`step_n` on the same arrays."""
        return (self._place(xs), _tree_map(self._place, ys)) + \
            tuple(self._place(e) for e in extras_s)
