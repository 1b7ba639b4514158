"""Gluon ``Block`` and ``HybridBlock`` of the port (the counterpart of
``mxnet_tpu/gluon/block.py``).

A ``Block`` **is** a ``torch.nn.Module``: its children are the module's
submodules and each Gluon ``Parameter`` it holds registers its tensor on
the module under the attribute's name, so ``state_dict()`` keys,
``named_parameters()`` and ``_collect_params_with_prefix()`` names agree,
and ``torch.func.functional_call`` swaps what a forward reads. Names come
from the reference's name scopes (``dense0_weight``; ``_NameCounter`` and
``_BlockScope``).

Blocks take NDArrays or tensors. A block's ``_io`` says what its forward
computes on: "tensor" for the port's layers and models (PyTorch code),
"nd" (the default) for a user's ``hybrid_forward(F, x, **params)`` with
``F`` the port's ``nd`` and the parameters as NDArrays, None for the
containers, which pass either on. Called with NDArrays, a tensor block runs
by Gluon's rules — a graph only inside ``autograd.record()``, BatchNorm's
batch statistics and Dropout's masks only while ``autograd.is_training()``,
Dropout drawing from ``random.generator(ctx)`` — and returns NDArrays;
called with tensors it runs by the module's own ``train()``/``eval()``
mode and returns tensors (``ParallelTrainStep``, the serving endpoints).

``hybridize()`` records its flags and keeps the eager forward, so a
hybridized block computes bitwise what the eager one does; capturing the
block (the reference's ``CachedOp``) is ROADMAP item C1, ``export`` and
``SymbolBlock`` item P17.

``register_forward_pre_hook`` and ``register_forward_hook`` are Gluon's,
not ``torch.nn.Module``'s: the hooks live in lists of their own, get
``(block, args)`` before the forward and ``(block, args, out)`` after it
(``args`` as the caller passed them), their return values are ignored,
and registering returns the hook. Torch's own hooks stay reachable as
``torch.nn.Module.register_forward_hook(block, ...)``.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List

import torch

from .. import amp as _amp
from .. import autograd
from ..base import MXNetError, current_context
from ..ndarray.ndarray import NDArray, _context_of, _wrap
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "gluon_context"]


# ---------------------------------------------------------------------------
# naming (the reference's name.py + _BlockScope)
# ---------------------------------------------------------------------------
class _NameCounter:
    _lock = threading.Lock()
    _counts: Dict[str, int] = {}

    @classmethod
    def get(cls, hint):
        with cls._lock:
            n = cls._counts.get(hint, 0)
            cls._counts[hint] = n + 1
        return f"{hint}{n}"


class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _NameCounter.get(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return False
        _BlockScope._current.value = self._old_scope
        return False


# ---------------------------------------------------------------------------
# the Gluon call: NDArrays into tensor blocks and back
# ---------------------------------------------------------------------------
_GLUON = threading.local()


def gluon_context():
    """The context of the innermost Gluon (NDArray) call on this thread,
    else None. Dropout draws from ``random.generator`` of its input's
    context inside such a call."""
    return getattr(_GLUON, "ctx", None)


def _map(fn, obj):
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, o) for o in obj)
    return fn(obj)


class _params_on:
    """Within it, every parameter of ``block``'s tree that has a copy on
    ``ctx`` (other than its first context) computes with that copy: the
    copy's tensor swapped into each owning block's table."""

    def __init__(self, block, ctx):
        self._swapped = []
        for m in block.modules():
            if not isinstance(m, Block):
                continue
            for name, p in m._reg_params.items():
                t = p._tensor_on(ctx)
                if t is not None:
                    table = m._buffers if p._buffer else m._parameters
                    self._swapped.append((table, name, table[name]))
                    table[name] = t

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for table, name, t in reversed(self._swapped):
            table[name] = t


def _call_with_tensors(block, args, kwargs):
    """A tensor block called with NDArrays: the mode from ``autograd``,
    a graph only while recording, the parameters' copies of the inputs'
    context, NDArrays back on that context."""
    ctx = next(a.context for a in args if isinstance(a, NDArray))

    def unwrap(a):   # lists of states too
        return _map(lambda v: v._data if isinstance(v, NDArray) else v, a)
    block.train(autograd.is_training())
    prev = getattr(_GLUON, "ctx", None)
    _GLUON.ctx = ctx
    try:
        with torch.set_grad_enabled(autograd.is_recording()), \
                _params_on(block, ctx):
            out = block._dispatch([unwrap(a) for a in args],
                                  {k: unwrap(v) for k, v in kwargs.items()})
    finally:
        _GLUON.ctx = prev
    return _map(lambda t: _wrap(t, ctx) if isinstance(t, torch.Tensor)
                else t, out)


def _call_with_arrays(block, args, kwargs):
    """An NDArray block called with tensors: recording follows torch's
    grad mode, training the module's mode; tensors back. Inside a Gluon
    call the tensors keep that call's context."""
    outer = gluon_context()

    def ctx_of(v):
        ctx = _context_of(v)
        return outer if outer is not None and outer.device_type == \
            ctx.device_type else ctx

    def wrap(a):
        return _map(lambda v: _wrap(v, ctx_of(v))
                    if isinstance(v, torch.Tensor) else v, a)
    with autograd._RecordingStateScope(torch.is_grad_enabled(),
                                       block.training):
        out = block._dispatch([wrap(a) for a in args],
                              {k: wrap(v) for k, v in kwargs.items()})
    return _map(lambda a: a._data if isinstance(a, NDArray) else a, out)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
class Block(torch.nn.Module):
    """Base building block (``block.py`` ``Block``) over
    ``torch.nn.Module``."""

    #: what ``forward`` computes on: "nd", "tensor" or None (either)
    _io = "nd"
    #: the cast policy ``amp.convert_hybrid_block`` attached, active
    #: around this block's forward
    _amp_cfg = None

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._reg_params: Dict[str, Parameter] = {}
        self._gluon_pre_hooks: List = []
        self._gluon_hooks: List = []

    def _alias(self):
        return self.__class__.__name__.lower()

    # -- attribute registration ----------------------------------------
    def __setattr__(self, name, value):
        existing = self.__dict__.get(name, self.__dict__.get(
            "_modules", {}).get(name))
        if isinstance(existing, (Parameter, Block)) and not isinstance(
                value, type(existing)) and not isinstance(existing,
                                                          type(value)):
            raise MXNetError(f"Changing attribute type for {name} from "
                             f"{type(existing)} to {type(value)} is not "
                             "allowed")
        if isinstance(value, Parameter):
            self._register_param(name, value)
            return
        super().__setattr__(name, value)

    def _register_param(self, name, param, attr=None):
        """Register ``param`` under ``name`` (its structural and
        ``collect_params`` name) and hold it as the attribute ``attr``
        (default ``name``)."""
        self._reg_params[name] = param
        param._attach(self, name)
        object.__setattr__(self, attr or name, param)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    def register_forward_pre_hook(self, hook):
        """Call ``hook(block, args)`` before each forward; its return value
        is ignored. Returns ``hook``."""
        self._gluon_pre_hooks.append(hook)
        return hook

    def register_forward_hook(self, hook):
        """Call ``hook(block, args, out)`` after each forward; its return
        value is ignored. Returns ``hook``."""
        self._gluon_hooks.append(hook)
        return hook

    # -- naming / params -------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters, by full name
        (those matching the regular expression ``select``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params.update(
                {n: p for n, p in self.params.items() if pattern.match(n)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret._params.update(child.collect_params(select)._params)
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural name (``encoder.layer0.qkv.weight``),
        the ``state_dict()`` keys and the ``.params`` files' names."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    # -- persistence -----------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Write every initialized parameter under its structural name
        (the reference's ``.params`` format)."""
        from ..ndarray.utils import save as nd_save
        params = self._collect_params_with_prefix()
        nd_save(filename, {key: p.data() for key, p in params.items()
                           if p._var is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Read a ``.params`` file (either package's) into the parameters:
        in place where initialized, else initialized from it on ``ctx``
        (default :func:`current_context`)."""
        from ..ndarray.utils import read
        loaded = read(filename)
        if not isinstance(loaded, dict):
            raise MXNetError(f"{filename} holds an unnamed array list, not "
                             "parameters")
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name, p in params.items():
                if name not in loaded and p._var is not None:
                    raise MXNetError(f"Parameter {name} missing in "
                                     f"{filename}")
        for name, data in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError(f"Parameter {name} loaded from "
                                     f"{filename} is not present in the "
                                     "Block")
                continue
            params[name]._load(data, ctx)

    # -- modes / utilities -----------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter of the tree on ``ctx`` (default
        :func:`current_context`) with ``init`` (default ``Uniform()``)
        where it has no initializer of its own."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of the tree to ``dtype`` (BatchNorm keeps
        float32)."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def _t(self, name):
        """The tensor registered under ``name`` (what ``functional_call``
        swaps in), None for an absent parameter (``use_bias=False``);
        raises for one not initialized."""
        t = self._parameters.get(name)
        if t is None:
            t = self._buffers.get(name)
            if t is None and name in self._reg_params:
                self._reg_params[name]._check_initialized()
        return t

    def summary(self, *inputs):
        """Print the parameter table of ``visualization.print_summary``
        (the inputs are not run)."""
        from ..visualization import print_summary
        print_summary(self)

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for name, p in self._reg_params.items():
            t = self._buffers.get(name) if p._buffer else \
                self._parameters.get(name)
            if t is not None:
                p._sync(t)
        return self

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        # a load initializes parameters that are not yet (where the
        # tensors lie), as load_parameters does
        for name, p in self._reg_params.items():
            key = prefix + name
            if p._var is None and key in state_dict:
                t = state_dict[key]
                p._load(t, _context_of(t))
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)

    # -- call ------------------------------------------------------------
    def _finish_deferred(self, args):
        if any(p._var is None and p._deferred_init
               for p in self._reg_params.values()):
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()

    def infer_shape(self, *args):
        raise MXNetError(f"{self.__class__.__name__} has deferred-init "
                         "parameters whose shape could not be inferred; "
                         "override infer_shape()")

    def __call__(self, *args, **kwargs):
        for hook in self._gluon_pre_hooks:
            hook(self, args)
        out = self._dispatch(args, kwargs)
        for hook in self._gluon_hooks:
            hook(self, args, out)
        return out

    def _dispatch(self, args, kwargs):
        """The call without the Gluon hooks: NDArrays into a tensor block
        (or tensors into an NDArray block) and back, the deferred shapes,
        the AMP policy of ``amp.convert_hybrid_block`` around the
        forward."""
        io = self._io
        if io is not None:
            nd_in = any(isinstance(a, NDArray) for a in args)
            if nd_in and io == "tensor":
                return _call_with_tensors(self, args, kwargs)
            if not nd_in and io == "nd" and any(
                    isinstance(a, torch.Tensor) for a in args):
                return _call_with_arrays(self, args, kwargs)
        if self._reg_params:
            self._finish_deferred(args)
        cfg = self._amp_cfg
        if cfg is None:
            return super().__call__(*args, **kwargs)
        _amp._push_cfg(cfg)   # amp.convert_hybrid_block's cast policy
        try:
            return super().__call__(*args, **kwargs)
        finally:
            _amp._pop_cfg()


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------
class HybridBlock(Block):
    """A block with a ``hybrid_forward(F, x, **params)``
    (``block.py`` ``HybridBlock``). ``hybridize()`` records its flags; the
    forward stays the eager one."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = []

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None, **kwargs):
        self._active = active
        self._flags = [("static_alloc", static_alloc),
                       ("static_shape", static_shape)]
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def forward(self, *args, **kwargs):
        """Fetch the parameters as NDArrays on the input's context and
        call ``hybrid_forward`` with ``F`` the port's ``nd``."""
        from .. import ndarray as nd_mod
        ctx = args[0].context if args and isinstance(args[0], NDArray) \
            else current_context()
        params = {name: p.data(ctx) for name, p in self._reg_params.items()
                  if not name.startswith("_")}
        return self.hybrid_forward(nd_mod, *args, **params, **kwargs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
