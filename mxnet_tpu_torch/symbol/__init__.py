"""``mx.sym`` / ``mx.symbol`` of the port (the counterpart of
``mxnet_tpu/symbol/__init__.py``): Symbol, Executor, and one wrapper per op,
generated from the port's registry and ``nd``'s hand-written wrappers with
the reference's skip list, so the same names build the same graphs."""
from __future__ import annotations

import sys as _sys

from .symbol import Symbol, var, Variable, Group, load, load_json
from .executor import Executor

_this = _sys.modules[__name__]

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json", "Executor"]


def _make_sym_wrapper(op_name):
    def wrapper(*args, **kwargs):
        return Symbol._create(op_name, args, kwargs)
    wrapper.__name__ = op_name
    wrapper.__qualname__ = op_name
    return wrapper


def _install_wrappers():
    from .. import ndarray as nd_mod
    from ..ops import registry as _registry
    names = set(_registry.list_ops())
    # include hand-written/aliased nd wrappers (BatchNorm, Dropout, CamelCase)
    for n in dir(nd_mod):
        if n.startswith("_"):
            continue
        obj = getattr(nd_mod, n)
        if callable(obj) and not isinstance(obj, type):
            names.add(n)
    skip = {"array", "save", "load", "zeros", "ones", "full", "empty", "arange",
            "full_like", "random"}
    for n in sorted(names):
        if n in skip or hasattr(_this, n):
            continue
        setattr(_this, n, _make_sym_wrapper(n))


_install_wrappers()
