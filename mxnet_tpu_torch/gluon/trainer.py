"""Gluon ``Trainer`` of the port (the counterpart of
``mxnet_tpu/gluon/trainer.py``): an optimizer applied to a set of
``Parameter``s after each backward.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and updates
every parameter with a gradient in place (the optimizer's ``_rule`` through
an ``Updater``, the f32 master of ``multi_precision`` included). The
kvstore (a type name or a ``KVStore``) is made at the first step, as the
reference's ``_init_kvstore`` does. With one context a parameter and one
worker there is nothing to reduce, so by default (``update_on_kvstore``
None or False) a step is the local update alone. With ``update_on_kvstore=True`` the store owns the
optimizer: each step pushes every gradient (through ``compression_params``'
2-bit or 1-bit roundtrip when given) and pulls every weight. A ``dist_*``
kvstore is ROADMAP item Q1.9 (P9) and raises.
"""
from __future__ import annotations

from typing import List

from .. import kvstore as kvstore_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import state_from_host, state_to, state_to_host
from .parameter import Parameter

__all__ = ["Trainer"]


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
        kvstore_mod.refuse_distributed(kvstore)
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
        self._compression_params = compression_params
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = False

    def _init_kvstore(self):
        """Make the kvstore once, at the first step or state call
        (``trainer.py`` ``_init_kvstore``): under ``update_on_kvstore`` it
        gets the optimizer and every initialized weight."""
        kv = self._kvstore_params["kvstore"]
        if kv is not None:
            self._kvstore = kv if isinstance(kv, kvstore_mod.KVStoreBase) \
                else kvstore_mod.create(kv)
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            self._update_on_kvstore = bool(
                self._kvstore_params["update_on_kvstore"])
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
                for i, p in enumerate(self._params):
                    if p._var is not None:
                        self._kvstore.init(i, p.data())
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter with gradients scaled by 1 /
        ``batch_size``. There is nothing to reduce first: a parameter has
        one context and every store here one worker (the reference's
        pushpull of several contexts or workers is ROADMAP Q1.9)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def allreduce_grads(self):
        """Make the kvstore; with one context and one worker there is
        nothing to reduce."""
        if not self._kv_initialized:
            self._init_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        if self._update_on_kvstore:
            for i, param in enumerate(self._params):
                if param.grad_req == "null" or param._var is None:
                    continue
                self._kvstore.push(i, param.list_grad(), priority=-i)
                self._kvstore.pull(i, out=param.list_data(), priority=-i)
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._var is None:
                continue
            self._updaters(i, param.grad(), param.data())

    def _refuse_kvstore_states(self, what):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError(f"{what} requires local updates "
                             "(update_on_kvstore=False); use save_states() "
                             "for kvstore-owned optimizer state")

    # ------------------------------------------------------------------
    def state_dict(self):
        """The optimizer side of training as host arrays: every state slot,
        the update count and the per-index counts."""
        self._refuse_kvstore_states("state_dict()")
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
        self._refuse_kvstore_states("load_state_dict()")
        opt = self._optimizer
        opt.num_update = int(state["num_update"])
        opt._index_update_count = {int(k): int(v) for k, v in
                                   state.get("index_counts", {}).items()}
        self._updaters.states = {
            int(i): state_from_host(st, self._params[int(i)].data()._data
                                    .device)
            for i, st in state.get("slots", {}).items()}

    def save_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters.get_states(dump_optimizer=True))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
        for i, st in self._updaters.states.items():
            self._updaters.states[i] = state_to(
                st, self._params[i].data()._data.device)
