"""``AttrScope`` of the port (the counterpart of
``mxnet_tpu/attribute.py``): attributes scoped over graph construction,
kept on a thread-local stack; ``current_attrs()`` is the merged top."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_LOCAL = threading.local()


class AttrScope:
    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def get(self, attrs=None):
        merged = dict(self._attrs)
        if attrs:
            merged.update(attrs)
        return merged

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = [{}]
        merged = dict(stack[-1])
        merged.update(self._attrs)
        stack.append(merged)
        return self

    def __exit__(self, *exc):
        _LOCAL.stack.pop()
        return False


def current_attrs():
    stack = getattr(_LOCAL, "stack", None)
    return dict(stack[-1]) if stack else {}
