"""Python custom operators of the port (the counterpart of
``mxnet_tpu/operator.py``): ``CustomOp``, ``CustomOpProp``, ``register``,
``get_all_registered_operators`` and the ``Custom`` registry op
(``nd.Custom(*data, op_type=name, **attrs)``).

A registered op runs as a ``torch.autograd.Function``: its forward calls
the user's ``CustomOp.forward(is_train, req, in_data, out_data, aux)``,
its backward the user's ``backward(req, out_grad, in_data, out_data,
in_grad, aux)``, every ``req`` "write". Output shapes and types come from
``CustomOpProp.infer_shape``/``infer_type``; attributes reach the prop as
strings, as the reference's C bridge delivers them. One function object is
cached per (op, registration version, attributes, training flag), so
re-registering a name replaces the op for later calls, and one
``CustomOp`` per context, shapes and dtypes.

The body gets NDArrays on the inputs' context and ``create_operator`` is
given that context's name, as MXNet itself does (the reference hands the
body ``cpu()`` arrays through ``jax.pure_callback``, the one way JAX
leaves it). The body runs without recording. As in the reference,
auxiliary states are passed to ``forward`` but writes to them do not reach
the caller's arrays, and storage is dense only.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]


class CustomOp:
    """Base class of operators written in Python."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Write the results into ``out_data`` (with :meth:`assign`)."""

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Write the inputs' gradients into ``in_grad``."""

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` asks ('null', 'write',
        'inplace' or 'add')."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError(f"invalid req {req!r}")


class CustomOpProp:
    """Base class of a custom operator's properties: its arguments,
    outputs, auxiliary states, shape and type inference and the operator
    it creates."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def need_top_grad(self):
        return self.need_top_grad_

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), \
            [in_shape[0]] * len(self.list_auxiliary_states())

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def infer_storage_type(self, in_stype):
        for i, stype in enumerate(in_stype):
            if stype != "default":
                raise MXNetError("custom ops support only dense storage; "
                                 f"got stype {stype!r} for input {i}")
        return in_stype, ["default"] * len(self.list_outputs()), \
            ["default"] * len(self.list_auxiliary_states())

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_REGISTRY: Dict[str, type] = {}
_VERSIONS: Dict[str, int] = {}
_LOCK = threading.Lock()


def register(reg_name):
    """Register a ``CustomOpProp`` subclass as ``reg_name``; then
    ``nd.Custom(*data, op_type=reg_name, **attrs)`` runs it. Registering
    a name again replaces the op for later calls."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        with _LOCK:
            _REGISTRY[reg_name] = prop_cls
            _VERSIONS[reg_name] = _VERSIONS.get(reg_name, 0) + 1
        return prop_cls
    return do_register


def get_all_registered_operators():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# dispatch: one _CustomFn per (op_type, version, attrs, is_train)
# ---------------------------------------------------------------------------
_FN_CACHE: Dict[Tuple, "_CustomFn"] = {}


def _make_prop(op_type, kwargs):
    if op_type not in _REGISTRY:
        raise MXNetError(f"custom op {op_type!r} is not registered")
    return _REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})


def _arrays(tensors, ctx):
    from .ndarray.ndarray import NDArray
    return [NDArray(t.detach(), ctx=ctx) for t in tensors]


class _CustomFn:
    """A registered op with its attributes and training flag: callable on
    tensors (inputs, then auxiliary states)."""

    def __init__(self, op_type, frozen_kwargs, is_train):
        self.prop = _make_prop(op_type, dict(frozen_kwargs))
        self.is_train = is_train
        self.n_in = len(self.prop.list_arguments())
        self.n_aux = len(self.prop.list_auxiliary_states())
        self.n_out = len(self.prop.list_outputs())
        self._ops: Dict[Tuple, CustomOp] = {}

    def operator(self, ctx, in_data):
        """The ``CustomOp`` for ``ctx`` and the inputs' shapes and dtypes
        (created once)."""
        shapes = [list(a.shape) for a in in_data]
        dtypes = [a.dtype for a in in_data]
        key = (str(ctx), tuple(tuple(s) for s in shapes),
               tuple(str(d) for d in dtypes))
        inst = self._ops.get(key)
        if inst is None:
            inst = self._ops[key] = self.prop.create_operator(
                str(ctx), shapes, dtypes)
        return inst

    def forward(self, tensors):
        from . import autograd
        from .ndarray import zeros
        from .ndarray.ndarray import _context_of
        ctx = _context_of(tensors[0])
        in_nd = _arrays(tensors[:self.n_in], ctx)
        aux_nd = _arrays(tensors[self.n_in:], ctx)
        out_shapes = self.prop.infer_shape([list(a.shape) for a in in_nd])[1]
        out_types = self.prop.infer_type([a.dtype for a in in_nd])[1]
        out_nd = [zeros(tuple(s), ctx=ctx, dtype=t)
                  for s, t in zip(out_shapes, out_types)]
        with autograd.pause(self.is_train):
            self.operator(ctx, in_nd).forward(
                is_train=self.is_train, req=["write"] * self.n_out,
                in_data=in_nd, out_data=out_nd, aux=aux_nd)
        return tuple(o._data for o in out_nd)

    def backward(self, out_grads, tensors, outs):
        from . import autograd
        from .ndarray.ndarray import _context_of
        ctx = _context_of(tensors[0])
        ind = _arrays(tensors[:self.n_in], ctx)
        aux = _arrays(tensors[self.n_in:], ctx)
        in_grad = _arrays([torch.zeros_like(t) for t in tensors[:self.n_in]],
                          ctx)
        with autograd.pause():
            self.operator(ctx, ind).backward(
                req=["write"] * self.n_in, out_grad=_arrays(out_grads, ctx),
                in_data=ind, out_data=_arrays(outs, ctx), in_grad=in_grad,
                aux=aux)
        return tuple(g._data for g in in_grad) + tuple(
            torch.zeros_like(t) for t in tensors[self.n_in:])

    def __call__(self, *tensors):
        out = _CustomFunction.apply(self, *tensors)
        return out if self.n_out > 1 else out[0]


class _CustomFunction(torch.autograd.Function):
    """The autograd node of a custom op: the user's forward and
    backward."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        outs = fn.forward(tensors)
        ctx.fn = fn
        ctx.save_for_backward(*tensors, *outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        fn = ctx.fn
        saved = ctx.saved_tensors
        n = len(saved) - fn.n_out
        tensors, outs = saved[:n], saved[n:]
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outs)]
        return (None,) + fn.backward(grads, tensors, outs)


def _freeze(kwargs):
    return tuple(sorted((k, str(v)) for k, v in kwargs.items()))


def _get_custom_fn(op_type, kwargs, is_train):
    """The cached callable of ``op_type`` with ``kwargs``: keyed by the
    registration version, so a re-registered name takes the new op."""
    key = (op_type, _VERSIONS.get(op_type, 0), _freeze(kwargs),
           bool(is_train))
    fn = _FN_CACHE.get(key)
    if fn is None:
        with _LOCK:
            fn = _FN_CACHE.get(key)
            if fn is None:
                fn = _FN_CACHE[key] = _CustomFn(op_type, _freeze(kwargs),
                                                bool(is_train))
    return fn


# ---------------------------------------------------------------------------
# the registry op: nd.Custom
# ---------------------------------------------------------------------------
def _install():
    from .ops import registry as _reg

    @_reg.register("Custom")
    def Custom(*data, op_type, **kwargs):
        """Apply a registered Python custom operator
        (``operator.register``)."""
        from . import autograd
        kwargs.pop("name", None)
        return _get_custom_fn(op_type, kwargs, autograd.is_training())(*data)

    from . import ndarray as _nd
    _nd._install_wrappers()


_install()
