"""``KVStoreBase`` and its plugin registry (the counterpart of
``mxnet_tpu/kvstore/base.py``; MXNet's ``KVStoreBase.register``, the hook
that plugs in other stores by name)."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """The KVStore interface."""

    OPTIMIZER = "optimizer"
    _kv_registry = {}

    # -- interface ----------------------------------------------------------
    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    @property
    def type(self):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError

    # -- registry -----------------------------------------------------------
    @staticmethod
    def register(klass):
        """Register ``klass`` under its lower-cased class name (a
        decorator)."""
        KVStoreBase._kv_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def get(name):
        key = name.lower()
        if key not in KVStoreBase._kv_registry:
            raise MXNetError(f"unknown KVStore type {name!r}; known: "
                             f"{sorted(KVStoreBase._kv_registry)}")
        return KVStoreBase._kv_registry[key]
