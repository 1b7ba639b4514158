"""Seeding of the port's random samplers (the counterpart of
``mxnet_tpu/random.py``).

Each context draws from a ``torch.Generator`` of its own, made at first use
and seeded from the last :func:`seed` (0 until one is called). PyTorch's
global generator is never used. The bits are not those of the JAX
package's threefry keys: the same seed gives the same numbers within the
port, not across packages. ``normal``, ``uniform``, ``randn`` and
``randint`` are the samplers of ``nd.random``.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from .base import Context

__all__ = ["seed", "generator", "uniform", "normal", "randn", "randint"]

_SAMPLERS = ("uniform", "normal", "randn", "randint")
_lock = threading.Lock()
_seed = 0
_generators: Dict[Context, torch.Generator] = {}


def seed(seed_state: int, ctx="all"):
    """Seed every context's generator (``ctx="all"``, and those made
    later), or only the generator of ``ctx``."""
    global _seed
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            _generators.clear()
        else:
            _generator(ctx).manual_seed(int(seed_state))


def _generator(ctx: Context) -> torch.Generator:
    g = _generators.get(ctx)
    if g is None:
        g = torch.Generator(device=ctx.torch_device()).manual_seed(_seed)
        _generators[ctx] = g
    return g


def generator(ctx: Context) -> torch.Generator:
    """The generator that samplers on ``ctx`` draw from."""
    with _lock:
        return _generator(ctx)


def __getattr__(name):
    if name in _SAMPLERS:
        from .ndarray import random as _nd_random
        return getattr(_nd_random, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
