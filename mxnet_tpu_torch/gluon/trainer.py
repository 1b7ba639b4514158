"""Gluon ``Trainer`` of the port (the counterpart of
``mxnet_tpu/gluon/trainer.py``): an optimizer applied to a set of
``Parameter``s after each backward.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and updates
every parameter with a gradient in place (the optimizer's ``_rule`` through
an ``Updater``, the f32 master of ``multi_precision`` included). On one
device with one context there is nothing to reduce: ``kvstore`` "device",
"local" or None do no communication. A ``dist_*`` kvstore,
``update_on_kvstore=True`` and gradient compression are ROADMAP item P9 and
raise.
"""
from __future__ import annotations

from typing import List

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import state_from_host, state_to, state_to_host
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


class Trainer:
    """Applies ``optimizer`` (a name with ``optimizer_params``, or an
    ``Optimizer``) to ``params`` (a ``ParameterDict``, a dict or a list of
    ``Parameter``s)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if hasattr(params, "values"):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict or list of "
                             "Parameters")
        if kvstore not in _LOCAL_KVSTORES or update_on_kvstore or \
                compression_params:
            raise MXNetError(
                f"Trainer: kvstore={kvstore!r}, update_on_kvstore="
                f"{update_on_kvstore!r}, compression {compression_params!r}:"
                " distributed and kvstore-side updates are ROADMAP item P9; "
                "one device takes kvstore 'device', 'local' or None")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError("invalid parameter in Trainer")
            self._params.append(p)
        #: a parameter has a row-sparse gradient (its update is lazy)
        self._contains_sparse_grad = any(
            p._grad_stype != "default" for p in self._params)
        optimizer_params = optimizer_params or {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and list(optimizer_params) != ["rescale_grad"]:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        self._updaters = opt_mod.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients (nothing to do on one device), then update
        every parameter with gradients scaled by 1 / ``batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update()

    def allreduce_grads(self):
        """One context per parameter: no reduction."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._var is None:
                continue
            self._updaters(i, param.grad(), param.data())

    # ------------------------------------------------------------------
    def state_dict(self):
        """The optimizer side of training as host arrays: every state slot,
        the update count and the per-index counts."""
        opt = self._optimizer
        return {"kind": "Trainer", "version": 1,
                "num_update": int(opt.num_update),
                "index_counts": {str(k): int(v) for k, v in
                                 opt._index_update_count.items()},
                "slots": {str(i): state_to_host(st)
                          for i, st in self._updaters.states.items()}}

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` (same optimizer and parameters),
        each slot on its parameter's device."""
        if state.get("kind") != "Trainer":
            raise MXNetError(f"not a Trainer state: {state.get('kind')!r}")
        opt = self._optimizer
        opt.num_update = int(state["num_update"])
        opt._index_update_count = {int(k): int(v) for k, v in
                                   state.get("index_counts", {}).items()}
        self._updaters.states = {
            int(i): state_from_host(st, self._params[int(i)].data()._data
                                    .device)
            for i, st in state.get("slots", {}).items()}

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updaters.get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
        for i, st in self._updaters.states.items():
            self._updaters.states[i] = state_to(
                st, self._params[i].data()._data.device)
