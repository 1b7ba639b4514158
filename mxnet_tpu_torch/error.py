"""``mx.error`` (the counterpart of ``mxnet_tpu/error.py``): typed
MXNetError subclasses, registered by name."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["MXNetError", "register", "InternalError", "get_error_class"]

_ERROR_TYPES = {}


def register_error(func_name=None, cls=None):
    """Register an error class under its name, or under ``func_name``;
    usable as a bare decorator or with an explicit name."""
    if callable(func_name):
        cls, func_name = func_name, None

    def deco(c):
        _ERROR_TYPES[func_name or c.__name__] = c
        return c
    return deco(cls) if cls is not None else deco


register = register_error


@register_error
class InternalError(MXNetError):
    """An internal invariant was violated."""

    def __init__(self, msg):
        if "InternalError:" not in msg:
            msg = f"InternalError: {msg}"
        super().__init__(msg)


def get_error_class(name):
    return _ERROR_TYPES.get(name, MXNetError)
