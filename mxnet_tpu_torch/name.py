"""``mx.name`` of the port (the counterpart of ``mxnet_tpu/name.py``):
``NameManager`` and ``Prefix``, the context managers the symbol frontend
asks for automatic names. A thread-local stack of managers;
``NameManager.current()`` is its top or None, in which case
``symbol._auto_name`` counts hints itself."""
from __future__ import annotations

import threading

_STACK = threading.local()


def _stack():
    if not hasattr(_STACK, "managers"):
        _STACK.managers = []
    return _STACK.managers


class NameManager:
    """Automatic hint-based naming: ``get(None, 'fc')`` yields fc0, fc1, ...
    per manager instance. Subclass and override ``get`` to change naming;
    activate with ``with NameManager(): ...``."""

    def __init__(self):
        self._counts = {}

    def get(self, name, hint):
        if name:
            return name
        n = self._counts.get(hint, 0)
        self._counts[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        return False

    @staticmethod
    def current():
        stack = _stack()
        return stack[-1] if stack else None


class Prefix(NameManager):
    """Auto-names with a fixed prefix prepended (name.py Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
