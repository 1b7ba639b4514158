"""Seeding of the port's random samplers (the counterpart of
``mxnet_tpu/random.py``).

Each context draws from a ``torch.Generator`` of its own, made at first use
and seeded from the last :func:`seed` (0 until one is called). PyTorch's
global generator is never used. The bits are not those of the JAX
package's threefry keys: the same seed gives the same numbers within the
port, not across packages. ``normal``, ``uniform``, ``randn`` and
``randint`` are the samplers of ``nd.random``.

The data path's host-side draws (the augmenters, the transforms, the
samplers and iterators' shuffles) come from a ``random.Random`` and a
``numpy.random.RandomState`` that this module owns, seeded by the same
:func:`seed`: :func:`python_rng` and :func:`numpy_rng`. Where the JAX
package draws from Python's and numpy's global generators, the port draws
the same numbers from these, so ``seed(s)`` here and ``random.seed(s)`` and
``numpy.random.seed(s)`` there give equal draws. Inside
``with sample_stream(s):`` the calling thread draws from streams of its
own seeded with ``s`` instead (the DataLoader seeds each batch this way, so
its batches do not depend on which worker thread made them).

:func:`get_state` and :func:`set_state` are the checkpoint surface: the
seed, every context's generator, :func:`python_rng` and :func:`numpy_rng`
as ``{"impl": "torch", "typed": 0, "data": uint8 array}``. The JAX
package's state is a threefry key chain, which no torch generator can take
on: :func:`set_state` refuses it.
"""
from __future__ import annotations

import base64
import contextlib
import json
import random as _pyrandom
import threading
from typing import Dict

import numpy as _np
import torch

from .base import Context, MXNetError

__all__ = ["seed", "generator", "python_rng", "numpy_rng", "sample_stream",
           "get_state", "set_state", "uniform", "normal", "randn",
           "randint"]

_SAMPLERS = ("uniform", "normal", "randn", "randint")
_lock = threading.Lock()
_seed = 0
_generators: Dict[Context, torch.Generator] = {}
_python = _pyrandom.Random(0)
_numpy = _np.random.RandomState(0)
_streams = threading.local()


def seed(seed_state: int, ctx="all"):
    """Seed every context's generator (``ctx="all"``, and those made
    later), or only the generator of ``ctx``."""
    global _seed, _python, _numpy
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            _generators.clear()
            _python = _pyrandom.Random(_seed)
            _numpy = _np.random.RandomState(_seed)
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


def python_rng() -> _pyrandom.Random:
    """The ``random.Random`` the data path draws from: the calling thread's
    :func:`sample_stream`, else the one :func:`seed` seeds."""
    own = getattr(_streams, "python", None)
    return own if own is not None else _python


def numpy_rng() -> _np.random.RandomState:
    """The ``numpy.random.RandomState`` the data path draws from: the
    calling thread's :func:`sample_stream`, else the one :func:`seed`
    seeds."""
    own = getattr(_streams, "numpy", None)
    return own if own is not None else _numpy


@contextlib.contextmanager
def sample_stream(seed_state: int):
    """Within the block, :func:`python_rng` and :func:`numpy_rng` of the
    calling thread are fresh streams seeded with ``seed_state``."""
    prev = (getattr(_streams, "python", None),
            getattr(_streams, "numpy", None))
    _streams.python = _pyrandom.Random(int(seed_state))
    _streams.numpy = _np.random.RandomState(int(seed_state) % 2 ** 32)
    try:
        yield
    finally:
        _streams.python, _streams.numpy = prev


def get_state():
    """A serializable snapshot of the module's random state: restoring it
    with :func:`set_state` makes every later draw (every context's
    generator, the data path's streams) what it would have been."""
    with _lock:
        gens = [[ctx.device_type, ctx.device_id,
                 base64.b64encode(g.get_state().numpy().tobytes()).decode()]
                for ctx, g in _generators.items()]
        name, keys, pos, has_gauss, cached = _numpy.get_state()
        payload = {"seed": _seed, "generators": gens,
                   "python": _python.getstate(),
                   "numpy": [name, keys.tolist(), int(pos), int(has_gauss),
                             float(cached)]}
    data = _np.frombuffer(json.dumps(payload).encode(), _np.uint8).copy()
    return {"impl": "torch", "typed": 0, "data": data}


def set_state(state):
    """Restore a :func:`get_state` snapshot. A state of another
    implementation (the JAX package's threefry key chain) raises."""
    impl = str(state.get("impl"))
    if impl != "torch":
        raise MXNetError(
            f"random state of implementation {impl!r} (the JAX package's "
            "key chain) cannot seed torch generators; restore with "
            "restore_rng=False and seed the port's random module instead")
    global _seed, _python, _numpy
    payload = json.loads(_np.asarray(state["data"], _np.uint8).tobytes())
    with _lock:
        _seed = int(payload["seed"])
        _generators.clear()
        for dev_type, dev_id, blob in payload["generators"]:
            ctx = Context(dev_type, int(dev_id))
            g = torch.Generator(device=ctx.torch_device())
            g.set_state(torch.frombuffer(bytearray(base64.b64decode(blob)),
                                         dtype=torch.uint8))
            _generators[ctx] = g
        version, keys, gauss = payload["python"]
        _python = _pyrandom.Random()
        _python.setstate((version, tuple(keys), gauss))
        name, keys, pos, has_gauss, cached = payload["numpy"]
        _numpy = _np.random.RandomState()
        _numpy.set_state((name, _np.asarray(keys, _np.uint32), pos,
                          has_gauss, cached))


def __getattr__(name):
    if name in _SAMPLERS:
        from .ndarray import random as _nd_random
        return getattr(_nd_random, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
