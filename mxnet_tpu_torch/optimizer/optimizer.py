"""Optimizers of the port: the ``Optimizer`` base, ``SGD`` and ``Adam`` of
``mxnet_tpu/optimizer/optimizer.py``.

The JAX package's update rule is a pure function over immutable arrays,
jitted with the weight and state buffers donated. The port updates in
place instead: :meth:`Optimizer._rule` overwrites the weight and its state
tensors under ``torch.no_grad()`` and returns nothing, which is what the
donation bought on the TPU (no second copy of the parameters or moments).
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict

import torch

__all__ = ["Optimizer", "SGD", "Adam"]


def _bf16_moments() -> bool:
    """``MXNET_OPT_BF16_MOMENTS`` as the JAX package reads it (default
    off)."""
    raw = os.environ.get("MXNET_OPT_BF16_MOMENTS")
    return raw is not None and raw.lower() in ("1", "true", "yes", "on")


class Optimizer:
    """Base optimizer: the hyper-parameter plumbing of the reference
    (``rescale_grad``, ``wd``, ``clip_gradient``, ``learning_rate``, an
    ``lr_scheduler`` called with the update count, per-index or per-name
    ``lr_mult``/``wd_mult``). Subclasses give :meth:`create_state` and
    :meth:`_rule`."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.idx2name = param_idx2name or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self.lr_mult.get(
            index, self.lr_mult.get(self.idx2name.get(index, ""), 1.0))

    def _get_wd(self, index):
        return self.wd * self.wd_mult.get(
            index, self.wd_mult.get(self.idx2name.get(index, ""), 1.0))

    def create_state(self, index, weight):
        return None

    def _rule(self, w, g, state, lr, wd, t):
        """Update ``w`` and ``state`` in place from the gradient ``g``
        (already rescaled and clipped) at learning rate ``lr``, weight decay
        ``wd`` and update count ``t``."""
        raise NotImplementedError


class SGD(Optimizer):
    """SGD with momentum (``optimizer_op.cc sgd_update/sgd_mom_update``):
    g' = g + wd * w; with momentum, mom = momentum * mom - lr * g' and
    w += mom, else w -= lr * g'. In place, in the weight's dtype (the f32
    masters)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        if state is None:
            w.sub_(lr * g)
            return
        state.mul_(self.momentum).sub_(lr * g)
        w.add_(state)


class Adam(Optimizer):
    """Adam (``optimizer_op.cc adam_update``): weight decay added to the
    gradient (L2, not decoupled), bias correction folded into the step size
    as lr * sqrt(1 - beta2^t) / (1 - beta1^t), epsilon outside the square
    root, f32 arithmetic. With ``MXNET_OPT_BF16_MOMENTS`` on, the moments are
    stored in bf16 and upcast to f32 for the arithmetic."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        dt = torch.float32 if weight.dtype in (torch.bfloat16, torch.float16) \
            else weight.dtype
        if _bf16_moments() and weight.is_floating_point():
            dt = torch.bfloat16
        return (torch.zeros_like(weight, dtype=dt),
                torch.zeros_like(weight, dtype=dt))

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        m, v = state
        acc = torch.float32 if m.dtype in (torch.bfloat16, torch.float16) \
            else m.dtype
        g32 = g.to(acc)
        if wd:
            g32 = g32 + wd * w.to(acc)
        m32 = m.to(acc).mul_(self.beta1).add_(g32, alpha=1 - self.beta1)
        v32 = v.to(acc).mul_(self.beta2).addcmul_(g32, g32,
                                                  value=1 - self.beta2)
        corrected_lr = lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        upd = (m32 * corrected_lr).div_(v32.sqrt().add_(self.epsilon))
        w.copy_(w.to(acc) - upd)
        m.copy_(m32)
        v.copy_(v32)
