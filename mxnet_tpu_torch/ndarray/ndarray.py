"""NDArray: the imperative tensor of the port.

The counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray is a handle
over a ``torch.Tensor`` on a :class:`~mxnet_tpu_torch.base.Context`. Writes
that MXNet does in place (``+=``, ``x[k] = v``, ``copyto``) rebind the
handle to a new tensor, as the JAX class's ``_set_data`` does, so an array
that carries a gradient stays a leaf of PyTorch's autograd graph.

Autograd follows MXNet, not PyTorch's defaults (see ``autograd.py``): an
operation builds a graph only inside ``autograd.record()``, and
``attach_grad`` keeps the gradient in an NDArray of its own that
``grad_req="write"`` overwrites and ``"add"`` accumulates.

dtype rules kept from the reference where torch's differ: a Python list
becomes float32 (int lists included), a float64 ndarray float32 and an
int64 ndarray int32; an operation with a Python scalar computes in the
array's dtype when it is floating (the scalar rounded to it first) and in
float32 otherwise; integer sums and products stay int32; ``mean`` of an
integer array and ``argmax`` are float32; a comparison returns 0/1 in the
left operand's dtype. numpy has no bfloat16: a bf16 array's ``dtype`` is the
string ``"bfloat16"`` and ``asnumpy`` returns float32.
"""
from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from .. import autograd as _ag
from ..base import Context, DTypes, MXNetError, current_context

__all__ = ["NDArray", "array"]


def _context_of(t: torch.Tensor) -> Context:
    if t.device.type == "cuda":
        return Context("gpu", t.device.index or 0)
    return Context("cpu", 0)


def _numpy_dtype(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return np.dtype(str(t.dtype).rpartition(".")[2])


def _to_tensor(data, ctx: Optional[Context], dtype) -> torch.Tensor:
    """A new tensor on ``ctx`` (default :func:`current_context`) from any
    array-like, with the reference's dtype defaults."""
    was_ndarray = isinstance(data, np.ndarray)
    if dtype is None:
        a = np.asarray(data)
        if not was_ndarray and a.dtype.kind in "iu":
            a = a.astype(np.float32)           # lists default to fp32
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        tdt = DTypes.torch(a.dtype)
    else:
        name = DTypes.canonical(dtype)
        a = np.asarray(data, dtype=np.float32 if name == "bfloat16" else name)
        tdt = DTypes.torch(name)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    dev = (ctx or current_context()).torch_device()
    return t.to(device=dev, dtype=tdt)


def _grad_hook(ref):
    """Post-accumulate hook of an attached leaf: moves the gradient PyTorch
    accumulated into the NDArray's grad buffer by its ``grad_req`` (write
    overwrites, add accumulates) and clears the leaf's own ``.grad``."""
    def hook(leaf):
        arr = ref()
        g, leaf.grad = leaf.grad, None
        if arr is None or arr._grad is None or g is None:
            return
        g = g.detach().to(arr._grad._data.dtype)
        if arr._grad_req == "add":
            g = arr._grad._data + g
        arr._grad._data = g
    return hook


class NDArray:
    """Multi-dimensional array on a context, backed by a torch tensor."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_is_predicate",
                 "__weakref__")

    # numpy defers binary operators to NDArray's reflected ones
    __array_priority__ = 1000.0
    __array_ufunc__ = None

    def __init__(self, data, ctx: Optional[Context] = None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            t = data
            if dtype is not None:
                t = t.to(DTypes.torch(dtype))
            if ctx is not None:
                t = t.to(ctx.torch_device())
        else:
            t = _to_tensor(data, ctx, dtype)
        self._data = t
        self._ctx = ctx if ctx is not None else _context_of(t)
        self._grad = None
        self._grad_req = "null"
        self._is_predicate = False

    # ------------------------------------------------------------------
    # core properties
    # ------------------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The underlying torch tensor."""
        return self._data

    def _set_data(self, t: torch.Tensor):
        """Rebind the handle (MXNet's in-place write). An array with an
        attached gradient stays a leaf that collects it."""
        if self._grad_req != "null" and t.is_floating_point():
            t = t.detach().requires_grad_(True)
            t.register_post_accumulate_grad_hook(_grad_hook(weakref.ref(self)))
        self._data = t

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return _numpy_dtype(self._data)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    # ------------------------------------------------------------------
    # reading back
    # ------------------------------------------------------------------
    def wait_to_read(self):
        """Wait for the work queued on this array's stream (not the whole
        device); errors of that work surface here."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise MXNetError("len() of 0-d array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx} {self.dtype}>")

    def __str__(self):
        return str(self.asnumpy())

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    # copies
    # ------------------------------------------------------------------
    def astype(self, dtype, copy=True) -> "NDArray":
        dt = DTypes.torch(dtype)
        if dt == self._data.dtype:
            return self.copy() if copy else self
        return _apply(lambda t: t.to(dt), self)

    def copy(self) -> "NDArray":
        return _apply(torch.clone, self)

    def copyto(self, other) -> "NDArray":
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), ctx=other)
        other._set_data(self._data.detach().to(
            device=other._data.device, dtype=other._data.dtype, copy=True))
        return other

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Allocate a zero gradient buffer; ``backward`` writes it
        (``grad_req="write"``) or adds to it (``"add"``)."""
        if stype not in (None, "default"):
            raise MXNetError(f"attach_grad: storage type {stype!r} is not "
                             "supported")
        _ag.mark_variables(self, NDArray(torch.zeros_like(self._data),
                                         ctx=self._ctx), grad_req)

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], None if out_grad is None else [out_grad],
                     retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def _mask(self, key) -> Optional[torch.Tensor]:
        """A same-shaped bool NDArray, or a comparison result (tagged
        predicate), indexes as a boolean mask; other NDArray indices gather."""
        if isinstance(key, NDArray) and key.shape == self.shape and (
                key._data.dtype == torch.bool or key._is_predicate):
            return key._data.bool()
        return None

    def _key(self, key):
        def conv(k):
            if isinstance(k, NDArray):
                return k._data.long()     # float index arrays gather too
            return k
        return tuple(conv(k) for k in key) if isinstance(key, tuple) \
            else conv(key)

    def __getitem__(self, key) -> "NDArray":
        mask = self._mask(key)
        k = mask if mask is not None else self._key(key)
        return _apply(lambda t: t[k], self)

    def __setitem__(self, key, value):
        mask = self._mask(key)
        k = mask if mask is not None else self._key(key)
        src = self._data
        if isinstance(value, NDArray):
            v = value._data.to(device=src.device, dtype=src.dtype)
        else:
            v = torch.as_tensor(np.asarray(value, dtype=np.float32)
                                if src.dtype == torch.bfloat16
                                else np.asarray(value)).to(
                device=src.device, dtype=src.dtype)
        with torch.set_grad_enabled(_ag.is_recording()):
            t = src.clone()
            t[k] = v
        self._set_data(t)

    # ------------------------------------------------------------------
    # arithmetic
    # ------------------------------------------------------------------
    def _binary(self, other, fn, reverse=False) -> "NDArray":
        if isinstance(other, (np.ndarray, list, tuple)):
            other = NDArray(other, ctx=self._ctx)
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return _apply(fn, a, b)
        # a Python scalar: in the array's dtype if floating, else float32,
        # rounded to that dtype before the operation (``_scalar_op``)
        dt = self._data.dtype if self._data.is_floating_point() \
            else torch.float32
        s = torch.tensor(float(other), dtype=dt)
        if reverse:
            return _apply(lambda t: fn(s, t.to(dt)), self)
        return _apply(lambda t: fn(t.to(dt), s), self)

    def __add__(self, o):
        return self._binary(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub)

    def __rsub__(self, o):
        return self._binary(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._binary(o, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._binary(o, torch.true_divide, reverse=True)

    def __mod__(self, o):
        return self._binary(o, torch.remainder)

    def __rmod__(self, o):
        return self._binary(o, torch.remainder, reverse=True)

    def __pow__(self, o):
        return self._binary(o, torch.pow)

    def __rpow__(self, o):
        return self._binary(o, torch.pow, reverse=True)

    def __matmul__(self, o):
        return _apply(torch.matmul, self, o)

    def __neg__(self):
        return _apply(torch.neg, self)

    def __abs__(self):
        return _apply(torch.abs, self)

    def __iadd__(self, o):
        self._set_data(self.__add__(o)._data)
        return self

    def __isub__(self, o):
        self._set_data(self.__sub__(o)._data)
        return self

    def __imul__(self, o):
        self._set_data(self.__mul__(o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data(self.__truediv__(o)._data)
        return self

    def _compare(self, other, fn) -> "NDArray":
        if not isinstance(other, NDArray):
            # the reference casts the other side to this array's dtype
            other = NDArray(np.asarray(other), ctx=self._ctx, dtype=self.dtype)
        out = _apply(lambda a, b: fn(a, b).to(a.dtype), self, other)
        out._is_predicate = True
        return out

    def __eq__(self, o):
        return self._compare(o, torch.eq)

    def __ne__(self, o):
        return self._compare(o, torch.ne)

    def __gt__(self, o):
        return self._compare(o, torch.gt)

    def __ge__(self, o):
        return self._compare(o, torch.ge)

    def __lt__(self, o):
        return self._compare(o, torch.lt)

    def __le__(self, o):
        return self._compare(o, torch.le)

    def __and__(self, o):
        return self._compare(o, torch.logical_and)

    def __or__(self, o):
        return self._compare(o, torch.logical_or)

    def __xor__(self, o):
        return self._compare(o, torch.logical_xor)

    def __invert__(self):
        out = _apply(torch.logical_not, self)
        out._is_predicate = True
        return out

    # ------------------------------------------------------------------
    # shapes
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        """Reshape with the reference's codes: 0 copies a dimension, -1
        infers one, -2 copies the rest, -3 merges two, -4 splits one into
        the next two values (``matrix_op.cc`` Reshape)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = _reshape_codes(self.shape, tuple(kwargs.get("shape", shape)))
        return _apply(lambda t: t.reshape(shape), self)

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        axes = axes or tuple(reversed(range(self.ndim)))
        return _apply(lambda t: t.permute(*axes), self)

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return _apply(lambda t: t.transpose(dim1, dim2), self)

    def flatten(self) -> "NDArray":
        return _apply(lambda t: t.reshape(t.shape[0], -1), self)

    def expand_dims(self, axis) -> "NDArray":
        return _apply(lambda t: t.unsqueeze(axis), self)

    def squeeze(self, axis=None) -> "NDArray":
        if axis is None:
            return _apply(torch.squeeze, self)
        return _apply(lambda t: t.squeeze(_axes(axis)), self)

    def broadcast_to(self, shape) -> "NDArray":
        shape = tuple(shape)
        if len(shape) == self.ndim:    # 0 keeps the dimension
            shape = tuple(d if s == 0 else s for s, d in zip(shape, self.shape))
        return _apply(lambda t: t.expand(shape), self)

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------
    def _reduce(self, fn, axis, keepdims, out_dtype):
        ax = _axes(axis)

        def run(t):
            x = t if out_dtype is None else t.to(out_dtype)
            if ax is None:
                r = fn(x)
                return r.reshape((1,) * t.dim()) if keepdims else r
            return fn(x, dim=ax, keepdim=keepdims)
        return _apply(run, self)

    def _int_acc(self):
        # integer and bool sums/products stay int32 (x64 is off in the
        # reference); torch would widen them to int64
        return None if self._data.is_floating_point() else torch.int32

    def sum(self, axis=None, keepdims=False) -> "NDArray":
        out = self._reduce(torch.sum, axis, keepdims, None)
        acc = self._int_acc()
        return out if acc is None else out.astype(acc, copy=False)

    def mean(self, axis=None, keepdims=False) -> "NDArray":
        dt = None if self._data.is_floating_point() else torch.float32
        return self._reduce(torch.mean, axis, keepdims, dt)

    def max(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce(torch.amax, axis, keepdims, None)

    def min(self, axis=None, keepdims=False) -> "NDArray":
        return self._reduce(torch.amin, axis, keepdims, None)

    def prod(self, axis=None, keepdims=False) -> "NDArray":
        out = self._reduce(_prod, axis, keepdims, None)
        acc = self._int_acc()
        return out if acc is None else out.astype(acc, copy=False)

    def argmax(self, axis=None, keepdims=False) -> "NDArray":
        """Index of the largest value, as float32 (the reference's)."""
        return _apply(lambda t: torch.argmax(
            t, dim=axis, keepdim=keepdims and axis is not None).float(), self)


def _axes(axis):
    if axis is None or isinstance(axis, int):
        return axis
    return tuple(axis)


def _prod(t, dim=None, keepdim=False):
    """torch.prod over several dimensions (it takes one at a time)."""
    if dim is None:
        return t.prod()
    for d in sorted(((dim,) if isinstance(dim, int) else dim),
                    key=lambda d: d % t.dim(), reverse=True):
        t = t.prod(dim=d, keepdim=keepdim)
    return t


def _reshape_codes(src, shape):
    if not any(s in (0, -2, -3, -4) for s in shape):
        return shape
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            a = src[i] // b if a == -1 else a
            b = src[i] // a if b == -1 else b
            out.extend([a, b])
            i += 1
            j += 2
        else:                      # a size, or -1 (inferred)
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


def _apply(fn, *arrays) -> NDArray:
    """``fn`` over the arrays' tensors, building an autograd graph only
    while recording; the result lives on the first array's context."""
    ts = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.set_grad_enabled(_ag.is_recording()):
        out = fn(*ts)
    return _wrap(out, arrays[0]._ctx)


def _wrap(t: torch.Tensor, ctx: Context) -> NDArray:
    """An NDArray over ``t``, which already lies on ``ctx``."""
    out = NDArray.__new__(NDArray)
    out._data, out._ctx, out._grad = t, ctx, None
    out._grad_req, out._is_predicate = "null", False
    return out


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray from any array-like (``ndarray.py`` ``array()``)."""
    return NDArray(source_array, ctx=ctx, dtype=dtype)
