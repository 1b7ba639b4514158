"""``mx.registry`` (the counterpart of ``mxnet_tpu/registry.py``): a
registry per base class with register, alias and create functions."""
from __future__ import annotations

import json

from .base import MXNetError

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func"]

_REGISTRY = {}


def get_registry(base_class):
    """The name -> class dict registered under ``base_class``."""
    return dict(_REGISTRY.get(base_class, {}))


def get_register_func(base_class, nickname):
    """A ``register(klass, name=None)`` function for ``base_class``."""
    registry = _REGISTRY.setdefault(base_class, {})

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise MXNetError(f"can only register subclasses of "
                             f"{base_class.__name__}")
        registry[(name or klass.__name__).lower()] = klass
        return klass
    register.__doc__ = f"Register {base_class.__name__} to the {nickname} " \
                       "factory"
    return register


def get_alias_func(base_class, nickname):
    """An ``alias(*names)`` decorator factory for ``base_class``."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """A ``create(name_or_instance, **kwargs)`` function: an instance is
    returned as it is; a name, or a JSON ``'[name, kwargs]'``, builds the
    registered class."""
    registry = _REGISTRY.setdefault(base_class, {})

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            return args[0]
        name = args[0] if args else kwargs.pop(nickname)
        if isinstance(name, str) and name.startswith("["):
            name, kw = json.loads(name)
            kwargs.update(kw)
        return registry[name.lower()](*args[1:], **kwargs)
    create.__doc__ = f"Create a {base_class.__name__} instance from the " \
                     f"{nickname} registry"
    return create
