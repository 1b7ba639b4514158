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

Operations and methods run the registered ops (``ops/registry.py``), one
implementation per op. dtype rules kept from the reference where torch's
differ: a Python list
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
from ..ops.registry import apply_op

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
    overwrites, add accumulates) and clears the leaf's own ``.grad``. A
    row-sparse buffer keeps a sparse gradient's rows, summed by id
    (``grad_req="add"`` sums the earlier rows in, so nnz stays at most the
    distinct rows touched); a dense gradient into it keeps its nonzero
    rows; a sparse gradient into a dense buffer is scattered into it."""
    def hook(leaf):
        arr = ref()
        g, leaf.grad = leaf.grad, None
        if arr is None or arr._grad is None or g is None:
            return
        g = g.detach()
        buf = arr._grad
        if buf.stype == "row_sparse":
            _write_row_sparse(buf, g, arr._grad_req == "add")
            return
        if g.is_sparse:
            g = _scatter_rows(g, buf._data.dtype)
        g = g.to(buf._data.dtype)
        if arr._grad_req == "add":
            g = buf._data + g
        buf._data = g
    return hook


def _scatter_rows(g, dtype):
    """A sparse COO gradient as a dense tensor: each row's parts added in
    their order (a dense scatter-add's order)."""
    out = torch.zeros(g.shape, dtype=dtype, device=g.device)
    return out.index_add_(0, g._indices()[0], g._values().to(dtype))


def _write_row_sparse(buf, g, add):
    """Store gradient ``g`` (sparse COO or dense) into the row-sparse
    buffer ``buf``, adding its old rows when ``add``."""
    from ..sparse import _dedup
    n = buf.shape[0]
    if g.is_sparse:
        idx, vals = g._indices()[0], g._values()
    else:
        dense = g.to(buf._data.dtype)
        idx = dense.reshape(n, -1).ne(0).any(dim=1).nonzero().reshape(-1)
        vals = dense[idx]
        if not add:   # nonzero rows are unique and sorted already
            buf._assign(idx, vals)
            return
    vals = vals.to(buf._data.dtype)
    if add and buf.nnz:
        idx, vals = torch.cat([idx, buf._indices]), torch.cat(
            [vals, buf._data])
    buf._assign(*_dedup(idx, vals, n))


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

    @property
    def stype(self) -> str:
        """The storage type: "default" (dense); the sparse subclasses'
        "row_sparse" and "csr"."""
        return "default"

    def tostype(self, stype):
        """This array in storage type ``stype`` (``cast_storage``)."""
        if stype == "default":
            return self
        from ..sparse import cast_storage
        return cast_storage(self, stype)

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
        if DTypes.torch(dtype) == self._data.dtype:
            return self.copy() if copy else self
        return apply_op("cast", self, dtype=DTypes.canonical(dtype))

    def copy(self) -> "NDArray":
        return apply_op("identity", self)

    def copyto(self, other) -> "NDArray":
        """A copy on a context, or into ``other``. From pinned host memory
        (a DataLoader's ``pin_memory=True`` batch) to the card the copy is
        asynchronous on the current stream."""
        if isinstance(other, Context):
            src = self._data.detach()
            dev = other.torch_device()
            return NDArray(src.to(dev, copy=True, non_blocking=(
                dev.type == "cuda" and src.is_pinned())), ctx=other)
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
        (``grad_req="write"``) or adds to it (``"add"``). With
        ``stype="row_sparse"`` the buffer is a ``RowSparseNDArray`` (nnz 0
        until a backward writes rows)."""
        if stype not in (None, "default"):
            from ..sparse import zeros as sparse_zeros
            buf = sparse_zeros(stype, self.shape, ctx=self._ctx,
                               dtype=self._data.dtype)
        else:
            buf = NDArray(torch.zeros_like(self._data), ctx=self._ctx)
        _ag.mark_variables(self, buf, grad_req)

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
        return apply_op("_getitem", self, key=k)

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
    # arithmetic, through the registry: an array operand takes the
    # broadcast op, a Python scalar the scalar op (``_plus_scalar``, ...)
    # ------------------------------------------------------------------
    def _binary(self, other, op, scalar_op, reverse=False) -> "NDArray":
        if isinstance(other, (np.ndarray, list, tuple)):
            other = NDArray(other, ctx=self._ctx)
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return apply_op(op, a, b)
        return apply_op(scalar_op, self, scalar=float(other),
                        reverse=reverse)

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar",
                            reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar",
                            reverse=True)

    def __matmul__(self, o):
        return apply_op("matmul", self, o)

    def __neg__(self):
        return apply_op("negative", self)

    def __abs__(self):
        return apply_op("abs", self)

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

    def _compare(self, other, op) -> "NDArray":
        if not isinstance(other, NDArray):
            # the reference casts the other side to this array's dtype
            other = NDArray(np.asarray(other), ctx=self._ctx, dtype=self.dtype)
        return apply_op(op, self, other)       # tagged as a predicate

    def __eq__(self, o):
        return self._compare(o, "broadcast_equal")

    def __ne__(self, o):
        return self._compare(o, "broadcast_not_equal")

    def __gt__(self, o):
        return self._compare(o, "broadcast_greater")

    def __ge__(self, o):
        return self._compare(o, "broadcast_greater_equal")

    def __lt__(self, o):
        return self._compare(o, "broadcast_lesser")

    def __le__(self, o):
        return self._compare(o, "broadcast_lesser_equal")

    def __and__(self, o):
        return self._compare(o, "broadcast_logical_and")

    def __or__(self, o):
        return self._compare(o, "broadcast_logical_or")

    def __xor__(self, o):
        return self._compare(o, "broadcast_logical_xor")

    def __invert__(self):
        return apply_op("logical_not", self)

    # ------------------------------------------------------------------
    # method mirrors of registered ops
    # ------------------------------------------------------------------
    def _op(self, name, **kw) -> "NDArray":
        return apply_op(name, self, **kw)

    def reshape(self, *shape, **kwargs) -> "NDArray":
        """Reshape with the reference's codes: 0 copies a dimension, -1
        infers one, -2 copies the rest, -3 merges two, -4 splits one into
        the next two values (``matrix_op.cc`` Reshape)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._op("reshape", shape=tuple(kwargs.get("shape", shape)))

    def reshape_like(self, other) -> "NDArray":
        return self._op("reshape", shape=other.shape)

    def transpose(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=tuple(axes) if axes else None)

    def swapaxes(self, dim1, dim2) -> "NDArray":
        return self._op("swapaxes", dim1=dim1, dim2=dim2)

    def flatten(self) -> "NDArray":
        return self._op("flatten")

    def expand_dims(self, axis) -> "NDArray":
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None) -> "NDArray":
        return self._op("squeeze", axis=_axes(axis))

    def broadcast_to(self, shape) -> "NDArray":
        return self._op("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other) -> "NDArray":
        return self._op("broadcast_to", shape=other.shape)

    def sum(self, axis=None, keepdims=False) -> "NDArray":
        return self._op("sum", axis=_axes(axis), keepdims=keepdims)

    def mean(self, axis=None, keepdims=False) -> "NDArray":
        return self._op("mean", axis=_axes(axis), keepdims=keepdims)

    def max(self, axis=None, keepdims=False) -> "NDArray":
        return self._op("max", axis=_axes(axis), keepdims=keepdims)

    def min(self, axis=None, keepdims=False) -> "NDArray":
        return self._op("min", axis=_axes(axis), keepdims=keepdims)

    def prod(self, axis=None, keepdims=False) -> "NDArray":
        return self._op("prod", axis=_axes(axis), keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False) -> "NDArray":
        """Index of the largest value, as float32 (the reference's)."""
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False) -> "NDArray":
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False) -> "NDArray":
        return self._op("norm", ord=ord, axis=_axes(axis), keepdims=keepdims)

    def clip(self, a_min=None, a_max=None) -> "NDArray":
        return self._op("clip", a_min=a_min, a_max=a_max)

    def abs(self) -> "NDArray":
        return self._op("abs")

    def sqrt(self) -> "NDArray":
        return self._op("sqrt")

    def square(self) -> "NDArray":
        return self._op("square")

    def exp(self) -> "NDArray":
        return self._op("exp")

    def log(self) -> "NDArray":
        return self._op("log")

    def relu(self) -> "NDArray":
        return self._op("relu")

    def sigmoid(self) -> "NDArray":
        return self._op("sigmoid")

    def tanh(self) -> "NDArray":
        return self._op("tanh")

    def softmax(self, axis=-1) -> "NDArray":
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1) -> "NDArray":
        return self._op("log_softmax", axis=axis)

    def slice(self, begin, end, step=None) -> "NDArray":
        return self._op("slice", begin=tuple(begin), end=tuple(end),
                        step=tuple(step) if step else None)

    def slice_axis(self, axis, begin, end) -> "NDArray":
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return apply_op("take", self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0) -> "NDArray":
        return self._op("one_hot", depth=depth, on_value=on_value,
                        off_value=off_value)

    def tile(self, reps) -> "NDArray":
        return self._op("tile", reps=tuple(reps) if isinstance(
            reps, (list, tuple)) else (reps,))

    def repeat(self, repeats, axis=None) -> "NDArray":
        return self._op("repeat", repeats=repeats, axis=axis)

    def flip(self, axis) -> "NDArray":
        return self._op("reverse", axis=axis)

    def zeros_like(self) -> "NDArray":
        return self._op("zeros_like")

    def ones_like(self) -> "NDArray":
        return self._op("ones_like")

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("split", num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)

    def dot(self, other) -> "NDArray":
        return apply_op("dot", self, other)


def _axes(axis):
    if axis is None or isinstance(axis, int):
        return axis
    return tuple(axis)


def _wrap(t: torch.Tensor, ctx: Context) -> NDArray:
    """An NDArray over ``t``, which already lies on ``ctx``."""
    out = NDArray.__new__(NDArray)
    out._data, out._ctx, out._grad = t, ctx, None
    out._grad_req, out._is_predicate = "null", False
    return out


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray from any array-like (``ndarray.py`` ``array()``)."""
    return NDArray(source_array, ctx=ctx, dtype=dtype)
