"""Optimizers of the port: the counterpart of
``mxnet_tpu/optimizer/optimizer.py`` — the ``Optimizer`` base with its
registry and hyper-parameter plumbing, ``multi_precision``, the fifteen
rules (``SGD``, ``NAG``, ``Adam``, ``AdamW``, ``RMSProp``, ``AdaGrad``,
``AdaDelta``, ``Ftrl``, ``FTML``, ``LAMB``, ``LARS``, ``Signum``, ``SGLD``,
``DCASGD``; ``RMSProp`` plain or centered), and ``Updater``.

The JAX package's update rule is a pure function over immutable arrays,
jitted with the weight and state buffers donated. The port updates in
place instead: :meth:`Optimizer._rule` overwrites the weight and its state
tensors under ``torch.no_grad()`` and returns nothing, which is what the
donation bought on the TPU (no second copy of the parameters or moments).
``ParallelTrainStep`` calls ``_rule`` directly; ``update`` (what the
Gluon ``Trainer`` and ``Updater`` call) adds the per-index update count,
the gradient's rescale and clip and the f32 master of ``multi_precision``
around it. States are tensors (``None``, a tensor or a tuple of them) on
the weight's device. A row-sparse gradient (``RowSparseNDArray``) takes
the lazy update (``_sparse_update``): only its rows of the weight, the
state and the master are updated.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from .. import config
from .. import random as _random
from ..base import MXNetError, Registry
from ..ndarray.ndarray import NDArray, _context_of

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "NAG", "RMSProp", "AdaGrad",
           "AdaDelta", "Ftrl", "FTML", "LAMB", "LARS", "Signum", "SGLD",
           "DCASGD", "create", "register", "Updater", "get_updater"]

_REG = Registry("optimizer")
_HALF = (torch.bfloat16, torch.float16)


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REG.register(klass.__name__)(klass)
    return klass


def create(name, **kwargs):
    """An optimizer by its registered name (``"sgd"``, ``"Adam"``, ...)."""
    return _REG.get(name)(**kwargs)


def _bf16_moments() -> bool:
    """``MXNET_OPT_BF16_MOMENTS`` as the JAX package reads it (default
    off)."""
    return bool(config.get("MXNET_OPT_BF16_MOMENTS"))


def _tensor(a) -> torch.Tensor:
    return a._data if isinstance(a, NDArray) else a


def _zeros(weight, dtype=None):
    return torch.zeros_like(weight, dtype=dtype or weight.dtype)


class Optimizer:
    """Base optimizer: the hyper-parameter plumbing of the reference
    (``rescale_grad``, ``wd``, ``clip_gradient``, ``learning_rate``, an
    ``lr_scheduler`` called with the update count, ``lr_mult``/``wd_mult``
    per index or name, or from the Gluon ``Parameter``s of ``param_dict``),
    the per-index update counts and ``multi_precision``. Subclasses give
    :meth:`create_state` and :meth:`_rule`."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0,
                 **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    # -- hyper-parameters ----------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, attr, table):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        return table.get(index, table.get(self.idx2name.get(index, ""), 1.0))

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # -- state ---------------------------------------------------------
    def create_state(self, index, weight):
        """The state of one weight (a tensor): None, a tensor or a tuple of
        tensors on its device."""
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and a bf16/fp16 weight: ``(master,
        state)``, the master an f32 copy made from the half weight and the
        state the rule's for the master; else :meth:`create_state`."""
        w = _tensor(weight).detach()
        if self.multi_precision and w.dtype in _HALF:
            master = w.float()
            return (master, self.create_state(index, master))
        return self.create_state(index, w)

    # -- update --------------------------------------------------------
    def _rule(self, w, g, state, lr, wd, t):
        """Update ``w`` and ``state`` in place from the gradient ``g``
        (already rescaled and clipped) at learning rate ``lr``, weight decay
        ``wd`` and update count ``t``."""
        raise NotImplementedError

    def _count(self, index):
        """The update count handed to the rule: an f32 scalar, as the
        reference's ``update`` hands it (so ``beta ** t`` rounds as it
        does there; ``ParallelTrainStep`` hands the same)."""
        return np.float32(self._index_update_count[index])

    def _preprocess_grad(self, g):
        g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        self._update_multi_precision(index, weight, grad, state)

    update_multi_precision = update

    @torch.no_grad()
    def _update_multi_precision(self, index, weight, grad, state):
        """One update of ``weight`` (an NDArray or tensor, written in place)
        from ``grad``; lists of each update index by index."""
        if isinstance(index, (list, tuple)):
            for i, w, g, s in zip(index, weight, grad, state):
                self._update_multi_precision(i, w, g, s)
            return
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._count(index)
        if getattr(grad, "stype", "default") == "row_sparse":
            self._sparse_update(weight, grad, state, lr, wd, t)
            return
        w, g = _tensor(weight), _tensor(grad)
        if self.multi_precision and w.dtype in _HALF:
            master, inner = state
            self._rule(master, self._preprocess_grad(g.float()), inner, lr,
                       wd, t)
            w.copy_(master)
        else:
            self._rule(w, self._preprocess_grad(g.to(w.dtype)), state, lr,
                       wd, t)


    def _sparse_update(self, weight, grad, state, lr, wd, t):
        """The lazy update of a row-sparse gradient (the reference's
        ``_sparse_update``): the touched rows of the weight, its state and
        its master are gathered, updated by the same ``_rule`` and
        scattered back; untouched rows see no weight or momentum decay.
        Duplicate row ids are summed first."""
        if grad.nnz == 0:
            return
        rsp = grad.dedup()
        idx = rsp._indices
        w = _tensor(weight)
        half = self.multi_precision and w.dtype in _HALF
        target, inner = state if half else (w, state)
        g = self._preprocess_grad(rsp._data.to(w.dtype))
        rows, st = target[idx], _gather(inner, idx)
        self._rule(rows, g.to(target.dtype), st, lr, wd, t)
        target.index_copy_(0, idx, rows)
        _scatter(inner, idx, st)
        if half:
            w.index_copy_(0, idx, rows.to(w.dtype))


def _gather(state, idx):
    """The rows ``idx`` of every tensor of an optimizer state."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_gather(s, idx) for s in state)
    return state[idx]


def _scatter(state, idx, rows):
    """Write :func:`_gather`'s updated rows back into the state."""
    if state is None:
        return
    if isinstance(state, (tuple, list)):
        for s, r in zip(state, rows):
            _scatter(s, idx, r)
        return
    state.index_copy_(0, idx, rows)


@register
class SGD(Optimizer):
    """SGD with momentum (``optimizer_op.cc sgd_update/sgd_mom_update``):
    g' = g + wd * w; with momentum, mom = momentum * mom - lr * g' and
    w += mom, else w -= lr * g'. In place, in the weight's dtype (the f32
    masters)."""

    def __init__(self, momentum=0.0, lazy_update=False, **kwargs):
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


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (``optimizer_op.cc nag_mom_update``):
    mom = momentum * mom + g', w -= lr * (g' + momentum * mom)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        state.mul_(self.momentum).add_(g)
        w.sub_(lr * (g + self.momentum * state))


def _ema_acc_dtype(dtype):
    """EMA arithmetic dtype for a stored moment dtype: half storage
    (``MXNET_OPT_BF16_MOMENTS``) upcasts to f32; f32/f64 keep theirs."""
    return torch.float32 if dtype in _HALF else dtype


@register
class Adam(Optimizer):
    """Adam (``optimizer_op.cc adam_update``): weight decay added to the
    gradient (L2, not decoupled), bias correction folded into the step size
    as lr * sqrt(1 - beta2^t) / (1 - beta1^t), epsilon outside the square
    root, f32 arithmetic. With ``MXNET_OPT_BF16_MOMENTS`` on, the moments are
    stored in bf16 and upcast to f32 for the arithmetic."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        dt = torch.float32 if weight.dtype in _HALF else weight.dtype
        if _bf16_moments() and weight.is_floating_point():
            dt = torch.bfloat16
        return (torch.zeros_like(weight, dtype=dt),
                torch.zeros_like(weight, dtype=dt))

    def _moments(self, g32, state):
        m, v = state
        acc = _ema_acc_dtype(m.dtype)
        m32 = m.to(acc).mul_(self.beta1).add_(g32, alpha=1 - self.beta1)
        v32 = v.to(acc).mul_(self.beta2).addcmul_(g32, g32,
                                                  value=1 - self.beta2)
        return m32, v32

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        m, v = state
        acc = _ema_acc_dtype(m.dtype)
        g32 = g.to(acc)
        if wd:
            g32 = g32 + wd * w.to(acc)
        m32, v32 = self._moments(g32, state)
        corrected_lr = lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        upd = (m32 * corrected_lr).div_(v32.sqrt().add_(self.epsilon))
        w.copy_(w.to(acc) - upd)
        m.copy_(m32)
        v.copy_(v32)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (contrib ``adamw.cc``): the update
    adds lr * wd * w to Adam's step instead of wd * w to the gradient."""

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        m, v = state
        acc = _ema_acc_dtype(m.dtype)
        m32, v32 = self._moments(g.to(acc), state)
        corrected_lr = lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        upd = corrected_lr * m32 / (v32.sqrt() + self.epsilon) + \
            lr * wd * w.to(acc)
        w.copy_(w.to(acc) - upd)
        m.copy_(m32)
        v.copy_(v32)


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update``; ``centered=True`` is Graves' variant,
    ``rmspropalex_update``, with momentum)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros(weight) for _ in range(n))

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        n = state[0]
        n.mul_(self.rho).add_((1 - self.rho) * g.square())
        if not self.centered:
            w.sub_(lr * g / (n.sqrt() + self.epsilon))
            return
        _, mean_g, mom = state
        mean_g.mul_(self.rho).add_((1 - self.rho) * g)
        mom.mul_(self.momentum).sub_(
            lr * g / (n - mean_g.square() + self.epsilon).sqrt())
        w.add_(mom)


@register
class AdaGrad(Optimizer):
    """AdaGrad: hist += g'^2, w -= lr * g' / (sqrt(hist) + eps)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        state.add_(g.square())
        w.sub_(lr * g / (state.sqrt() + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate in the step): running averages of g'^2
    and of the squared steps."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        acc_g, acc_delta = state
        g = g + wd * w
        acc_g.mul_(self.rho).add_((1 - self.rho) * g.square())
        delta = (acc_delta + self.epsilon).sqrt() / \
            (acc_g + self.epsilon).sqrt() * g
        acc_delta.mul_(self.rho).add_((1 - self.rho) * delta.square())
        w.sub_(delta)


@register
class Ftrl(Optimizer):
    """FTRL-Proximal: z and n accumulators, w = 0 where |z| <= lamda1."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        z, n = state
        sigma = ((n + g.square()).sqrt() - n.sqrt()) / lr
        z.add_(g - sigma * w)
        n.add_(g.square())
        new_w = -(z - z.sign() * self.lamda1) / \
            ((self.beta + n.sqrt()) / lr + wd)
        w.copy_(torch.where(z.abs() > self.lamda1, new_w,
                            torch.zeros_like(new_w)))


@register
class FTML(Optimizer):
    """Follow the Moving Leader: states d, v, z; w = -z / d_t."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        d, v, z = state
        g = g + wd * w
        v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
        d_t = (1 - self.beta1 ** t) / lr * (
            (v / (1 - self.beta2 ** t)).sqrt() + self.epsilon)
        sigma = d_t - self.beta1 * d
        z.mul_(self.beta1).add_((1 - self.beta1) * g - sigma * w)
        d.copy_(d_t)
        w.copy_(-z / d_t)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (contrib ``multi_lamb.cc``): Adam's
    direction plus wd * w, scaled by ||w|| / ||r|| (bounded by
    ``lower_bound``/``upper_bound``), moments in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        dt = torch.float32 if weight.dtype in _HALF else weight.dtype
        return (_zeros(weight, dt), _zeros(weight, dt))

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        m, v = state
        w32, g32 = w.to(m.dtype), g.to(m.dtype)
        m.mul_(self.beta1).add_((1 - self.beta1) * g32)
        v.mul_(self.beta2).add_((1 - self.beta2) * g32.square())
        if self.bias_correction:
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
        else:
            mhat, vhat = m, v
        r = mhat / (vhat.sqrt() + self.epsilon) + wd * w32
        w_norm = torch.linalg.vector_norm(w32)
        if self.lower_bound is not None:
            w_norm = w_norm.clamp_min(self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp_max(self.upper_bound)
        r_norm = torch.linalg.vector_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        w.copy_(w32 - lr * ratio * r)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (contrib ``multi_lars.cc``): SGD
    momentum at lr * eta ||w|| / (||g|| + wd ||w|| + eps)."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-9, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        w_norm = torch.linalg.vector_norm(w.float())
        g_norm = torch.linalg.vector_norm(g.float())
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        g = g + wd * w
        state.mul_(self.momentum).add_((lr * local_lr).to(w.dtype) * g)
        w.sub_(state)


@register
class Signum(Optimizer):
    """signSGD (momentum 0) and Signum: steps of lr along the sign of the
    gradient or of its momentum, with ``wd_lh`` decoupled decay."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        if state is None:
            w.copy_(w * (1 - lr * (wd + self.wd_lh)) - lr * g.sign())
            return
        state.mul_(self.momentum).sub_((1 - self.momentum) * g)
        w.copy_(w * (1 - lr * self.wd_lh) + lr * state.sign() - lr * wd * w)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w -= lr/2 * (g + wd w) plus
    N(0, lr) noise drawn from ``random.generator`` of the weight's
    context."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _tensor(weight)
        g = self._preprocess_grad(_tensor(grad)) + wd * w
        w.copy_(w - lr / 2 * g + self._noise(w) * math.sqrt(lr))

    update_multi_precision = update

    def _noise(self, w):
        return torch.randn(w.shape, generator=_random.generator(
            _context_of(w)), device=w.device).to(w.dtype)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: momentum SGD on g' + lamda g'^2
    (w - w_prev), with w_prev the state's copy of the last weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return (_zeros(weight), weight.detach().clone())

    @torch.no_grad()
    def _rule(self, w, g, state, lr, wd, t):
        mom, prev_w = state
        g = g + wd * w
        mom.mul_(self.momentum).sub_(
            lr * (g + self.lamda * g.square() * (w - prev_w)))
        w.add_(mom)
        prev_w.copy_(w)


class Updater:
    """An optimizer with the state of every index it has updated
    (``updater.py``): called as ``updater(index, grad, weight)``, it makes
    the state at the first call (``create_state_multi_precision``) and
    updates the weight in place."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state_multi_precision(
                    i, w)
            self.optimizer.update_multi_precision(i, w, g, self.states[i])

    def get_states(self, dump_optimizer=False):
        """The states as pickled host arrays (with the optimizer's class
        name when ``dump_optimizer``)."""
        tree = {k: state_to_host(v) for k, v in self.states.items()}
        return pickle.dumps((tree, self.optimizer.__class__.__name__)
                            if dump_optimizer else tree)

    def set_states(self, states):
        """Restore :meth:`get_states` bytes (written by this program) as
        CPU tensors."""
        data = pickle.loads(states)
        if isinstance(data, tuple):
            data = data[0]
        self.states = {k: state_from_host(v) for k, v in data.items()}


def state_to_host(v):
    """A state tree with every tensor as a host numpy array (bf16 as
    ``("bfloat16", uint16 bits)``, numpy having no bf16)."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", t.view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    return tuple(state_to_host(x) for x in v)


def state_from_host(v, device=None):
    """The inverse of :func:`state_to_host`, tensors on ``device``."""
    if v is None:
        return None
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v)).to(device)
    if len(v) == 2 and isinstance(v[0], str) and v[0] == "bfloat16":
        return torch.from_numpy(v[1].view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return tuple(state_from_host(x, device) for x in v)


def state_to(v, device):
    """A state tree with every tensor moved to ``device``."""
    if v is None or isinstance(v, torch.Tensor):
        return v if v is None else v.to(device)
    return tuple(state_to(x, device) for x in v)


def get_updater(optimizer):
    return Updater(optimizer)
