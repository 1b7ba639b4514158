"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` of the port (the
counterpart of ``mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` owns the tensor its blocks compute with: a
``torch.nn.Parameter`` registered on each block that holds it, under the
attribute's name (a plain tensor registered as a buffer for the
non-trainable running statistics and constants). ``data()`` is an NDArray
over that very tensor, so the module's forward, autograd, ``set_data``,
the optimizer's in-place update and ``ParallelTrainStep`` all see one
tensor. Gradients reach the gradient NDArray (``grad()``) through the
tensor's post-accumulate hook, by ``grad_req``: "write" overwrites on each
backward, "add" accumulates, "null" keeps none. With
``grad_stype="row_sparse"`` (an Embedding with ``sparse_grad=True``) the
gradient is a ``RowSparseNDArray`` of the rows a backward touched.

Nothing is allocated before ``initialize()`` (or a load): ``data()`` raises
until then, and a shape with unknown (0) dimensions waits for the first
forward (deferred initialization). One context per parameter; several
contexts are ROADMAP item P9.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import List

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import Context, DTypes, MXNetError, current_context
from ..ndarray.ndarray import NDArray, _context_of, _grad_hook, _wrap

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """A parameter was read before its deferred shape was known."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


class _ParamArray(NDArray):
    """The NDArray of a parameter's tensor. MXNet writes to it
    (``p.data()[:] = v``, an initializer) copy into the tensor in place
    instead of rebinding the handle, so the registered tensor stays the
    one the blocks hold."""

    __slots__ = ()

    def _set_data(self, t: torch.Tensor):
        with torch.no_grad():
            self._data.copy_(t)


def _host(data) -> torch.Tensor:
    """A tensor from an NDArray, a tensor or an array-like."""
    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    return torch.from_numpy(np.array(np.asarray(data), copy=True))


def _one_context(ctx) -> Context:
    if ctx is None:
        return current_context()
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(f"a parameter lives on one context, got {ctx}; "
                             "several contexts are ROADMAP item P9")
        ctx = ctx[0]
    return ctx


class Parameter:
    """A trainable array with deferred initialization (``parameter.py``
    ``Parameter``): ``shape`` may hold unknown (0) dimensions until the
    first forward; ``grad_req`` is "write", "add" or "null";
    ``lr_mult``/``wd_mult`` scale the optimizer's learning rate and weight
    decay for it."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default":
            raise MXNetError(f"{name}: sparse weight storage is not ported; "
                             "grad_stype='row_sparse' is")
        if grad_stype not in ("default", "row_sparse"):
            raise MXNetError(f"{name}: grad_stype {grad_stype!r} is not "
                             "supported")
        self.name = name
        self._grad_stype = grad_stype
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = DTypes.canonical(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        #: registered as a module buffer (running statistics, constants),
        #: not as a trainable ``nn.Parameter``
        self._buffer = False
        self._ctx = None
        self._var = None            # the registered tensor
        self._nd = None             # _ParamArray over _var
        self._grad = None           # gradient NDArray
        self._deferred_init = ()
        self._owners = []           # (block, attribute name)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, " \
               f"dtype={self.dtype})"

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or any(
                o not in (0, -1) and o != n
                for o, n in zip(self._shape, new_shape)):
            raise MXNetError(f"{self.name}: shape {new_shape} does not match "
                             f"{self._shape}")
        self._shape = new_shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._var is not None:
            if not self._buffer and self._var.is_floating_point():
                self._var.requires_grad_(req != "null")
            self._init_grad()

    # ------------------------------------------------------------------
    # registration on blocks
    # ------------------------------------------------------------------
    def _attach(self, block, attr):
        """Register this parameter's tensor (None before initialization) on
        ``block`` under ``attr``."""
        self._owners.append((block, attr))
        table = block._buffers if self._buffer else block._parameters
        table[attr] = self._var

    def _bind(self, t: torch.Tensor, ctx: Context):
        """Make ``t`` this parameter's tensor on ``ctx``: a new
        ``nn.Parameter`` (or buffer) registered on every owning block, its
        NDArray, the post-accumulate hook and a zero gradient buffer."""
        t = t.detach()
        if self._buffer:
            var = t
        else:
            var = torch.nn.Parameter(t, requires_grad=(
                self._grad_req != "null" and t.is_floating_point()))
        nd = _ParamArray.__new__(_ParamArray)
        nd._data, nd._ctx, nd._grad = var, ctx, None
        nd._grad_req, nd._is_predicate = "null", False
        if isinstance(var, torch.nn.Parameter) and t.is_floating_point():
            # the hook stays when grad_req later turns gradients on
            needs_grad = var.requires_grad
            var.requires_grad_(True)
            var.register_post_accumulate_grad_hook(
                _grad_hook(weakref.ref(nd)))
            var.requires_grad_(needs_grad)
        self._var, self._nd, self._ctx = var, nd, ctx
        self.dtype = DTypes.canonical(var.dtype)
        for block, attr in self._owners:
            table = block._buffers if self._buffer else block._parameters
            table[attr] = var
        self._init_grad()

    def _sync(self, t: torch.Tensor):
        """Follow a module conversion (``block.to(...)``): ``t`` is the
        tensor now registered under this parameter's name."""
        if t is not self._var:
            self._bind(t, _context_of(t))
            return
        ctx = _context_of(t)
        if ctx != self._ctx or DTypes.canonical(t.dtype) != self.dtype:
            self._ctx, self._nd._ctx = ctx, ctx
            self.dtype = DTypes.canonical(t.dtype)
            self._init_grad()

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate on ``ctx`` (default :func:`current_context`) and fill
        with ``init``, else the parameter's own ``init``, else
        ``default_init`` (``Uniform()``); with unknown dimensions and
        ``allow_deferred_init``, wait for the first forward."""
        default_init = default_init or init_mod.Uniform()
        if self._var is not None and not force_reinit:
            return
        ctx = _one_context(ctx)
        if init is None:
            init = default_init if self.init is None else self.init
        if not _shape_known(self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise MXNetError(f"Cannot initialize Parameter {self.name} "
                             f"because it has invalid shape {self._shape}")
        self._init_impl(init, ctx, default_init)

    def _init_impl(self, init, ctx, default_init, data=None):
        ctx = _one_context(ctx)
        dev, dt = ctx.torch_device(), DTypes.torch(self.dtype)
        self._deferred_init = ()
        if data is not None:
            t = _host(data).to(device=dev, dtype=dt)
        else:
            arr = _wrap(torch.zeros(self._shape, dtype=dt, device=dev), ctx)
            init_mod.create(init if init is not None else default_init)(
                init_mod.InitDesc(self.name), arr)
            t = arr._data
        if self._var is not None and self._var.shape == t.shape and \
                self._var.dtype == t.dtype and self._var.device == t.device:
            with torch.no_grad():        # re-initialization: same tensor
                self._var.copy_(t)
            return
        self._bind(t, ctx)

    def _init_grad(self):
        if self._grad_req == "null" or self._buffer:
            self._grad = None
        elif self._grad_stype == "row_sparse":
            from ..sparse import zeros as sparse_zeros
            self._grad = sparse_zeros("row_sparse", tuple(self._var.shape),
                                      ctx=self._ctx, dtype=self._var.dtype)
        else:
            self._grad = _wrap(torch.zeros_like(self._var.detach()),
                               self._ctx)
        self._nd._grad, self._nd._grad_req = self._grad, self._grad_req

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                f"Parameter {self.name} has unknown shape {self._shape}")
        init, ctx, default_init, data = self._deferred_init
        self._init_impl(init, ctx, default_init, data)

    def _load(self, data, ctx=None):
        """Take ``data`` as this parameter's value: copied in place if it
        is initialized, else the parameter is initialized from it on
        ``ctx`` (its deferred context, else :func:`current_context`)."""
        t = _host(data)
        self.shape = tuple(t.shape)
        if self._var is None:
            if ctx is None and self._deferred_init:
                ctx = self._deferred_init[1]
            self._init_impl(None, ctx, None, data=t)
        else:
            with torch.no_grad():
                self._var.copy_(t)

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def _check_initialized(self, ctx=None):
        if self._var is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "because initialization was deferred (unknown shape)")
            raise MXNetError(f"Parameter {self.name} has not been "
                             "initialized. Call initialize()")
        if ctx is not None and ctx != self._ctx:
            raise MXNetError(f"Parameter {self.name} was not initialized on "
                             f"{ctx}; it lives on {self._ctx}")

    def data(self, ctx=None) -> NDArray:
        """The NDArray over the parameter's tensor."""
        self._check_initialized(ctx)
        return self._nd

    def list_data(self) -> List[NDArray]:
        self._check_initialized()
        return [self._nd]

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized(ctx)
        if self._grad is None:
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        return self._grad

    def list_grad(self) -> List[NDArray]:
        return [self.grad()]

    def set_data(self, data):
        """Overwrite the value in place (or, before a deferred
        initialization, keep it for then)."""
        self.shape = tuple(data.shape)
        if self._var is None:
            if self._deferred_init:
                init, ctx, default_init, _ = self._deferred_init
                self._deferred_init = (init, ctx, default_init, data)
                if _shape_known(self._shape):
                    self._finish_deferred_init()
                return
            raise MXNetError(f"Parameter {self.name} not initialized")
        with torch.no_grad():
            self._var.copy_(_host(data))

    def zero_grad(self):
        if self._grad is None:
            return
        if self._grad_stype == "row_sparse":   # no rows
            self._grad._assign(self._grad._indices[:0], self._grad._data[:0])
        else:
            self._grad._data = torch.zeros_like(self._grad._data)

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (one context)."""
        ctx = _one_context(ctx)
        if self._var is not None:
            self._bind(self._var.detach().to(ctx.torch_device()), ctx)
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)

    def cast(self, dtype):
        """Cast to ``dtype``: a new tensor, registered on every owner."""
        self.dtype = DTypes.canonical(dtype)
        if self._var is not None:
            self._bind(self._var.detach().to(DTypes.torch(dtype)), self._ctx)

    def var(self):
        """The reference's symbol accessor; the parameter itself."""
        return self


class Constant(Parameter):
    """A non-trainable parameter holding ``value`` (a buffer)."""

    def __init__(self, name, value):
        value = _host(value)
        if value.dtype == torch.float64:
            value = value.float()
        self.value = value

        class _CInit(init_mod.Initializer):
            def _init_weight(s, desc, arr):
                arr._set_data(value.to(device=arr._data.device,
                                       dtype=arr._data.dtype))
            _init_default = _init_weight
        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=DTypes.canonical(value.dtype), init=_CInit(),
                         differentiable=False)
        self._buffer = True


class ParameterDict:
    """Ordered dict of Parameters with a name prefix and a shared dict to
    look names up in (``parameter.py`` ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """The parameter named prefix + ``name``, created with ``kwargs``
        if neither this dict nor the shared one has it."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None:
                    param.shape = (v,) if isinstance(v, int) else v
                elif k == "init" and v is not None and param.init is None:
                    param.init = v
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(f"No constant named {name}")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update self with other because "
                                 "they have different Parameters with the "
                                 f"same name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter: its own ``init`` first, else
        ``init`` (default ``Uniform()``)."""
        for p in self.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, fname, strip_prefix=""):
        from ..ndarray.utils import save as nd_save
        arg = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        nd_save(fname, arg)

    def load(self, fname, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        from ..ndarray.utils import read
        loaded = read(fname)
        if isinstance(loaded, list):
            raise MXNetError("expected dict-style parameter file")
        loaded = {restore_prefix + k.replace("arg:", "").replace("aux:", ""):
                  v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError(f"Parameter {name} missing in file "
                                     f"{fname}")
        for name, data in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError(f"Parameter {name} in file but not in "
                                 "ParameterDict")
            self._params[name]._load(data, ctx)

    def __repr__(self):
        s = "\n".join(repr(p) for p in self.values())
        return f"ParameterDict (\n{s}\n)"
