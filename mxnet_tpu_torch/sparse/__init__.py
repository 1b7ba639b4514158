"""Sparse storage of the port: ``RowSparseNDArray`` and ``CSRNDArray`` (the
counterpart of ``mxnet_tpu/sparse/__init__.py``, over MXNet's
``ndarray/sparse.py``).

A sparse array is an NDArray whose ``_data`` tensor holds the stored
values, beside index tensors on the same device:

- row-sparse: ``_indices`` (nnz,) int64 row ids and ``_data`` (nnz,
  *row shape) the rows;
- CSR (2-D): ``_data`` (nnz,), ``_indices`` (nnz,) int64 column ids and
  ``_indptr`` (rows + 1,) int64 row offsets.

``shape`` is the dense shape; ``data``, ``indices`` and ``indptr`` are
NDArrays, as MXNet's API has them. The port's operations keep row-sparse
storage exact: duplicate row ids are summed into sorted, unique rows
(:func:`_dedup`, the reference's sorted dedup; on the CPU each row sums
its parts in their order, as a dense scatter-add does, so sparse and
dense gradients agree bitwise there; on the card ``index_add_`` sums
with atomics, in no fixed order). Exact storage has a data-dependent nnz,
so a dedup reads it on the host (one synchronisation), where the
reference pads to a static nnz for XLA; rows with an id of ``shape[0]``
(the reference's padding, as a file it wrote may hold) are dropped
wherever the port reads rows.

A row-sparse gradient reaches autograd as PyTorch's uncoalesced sparse
COO tensor (the Embedding op's ``sparse_grad=True`` backward; PyTorch
concatenates the parts of several uses, the role of the reference's
``SparseCotangent``); :func:`from_coo` makes it a ``RowSparseNDArray``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import Context, DTypes, MXNetError, current_context
from ..ndarray.ndarray import NDArray, _context_of, _wrap

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "empty", "array",
           "cast_storage", "retain", "dot", "add_n", "elemwise_add",
           "elemwise_mul", "square_sum", "from_coo"]


def _tensor(x, ctx, dtype=None):
    """A tensor on ``ctx`` from an NDArray, a tensor or an array-like
    (float64 becomes float32, as the reference's constructors do)."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if dtype is not None:
            name = DTypes.canonical(dtype)
            a = a.astype(np.float32 if name == "bfloat16" else name)
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if dtype is not None:
        t = t.to(DTypes.torch(dtype))
    elif t.dtype == torch.float64:
        t = t.float()
    return t.to(ctx.torch_device())


def _index(x, ctx):
    return _tensor(x, ctx).reshape(-1).long()


def _dedup(idx, vals, n_rows):
    """(sorted unique row ids, their summed rows) of row-sparse parts;
    ids outside [0, n_rows) are dropped."""
    keep = (idx >= 0) & (idx < n_rows)
    if not bool(keep.all()):
        idx, vals = idx[keep], vals[keep]
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    out = vals.new_zeros((uniq.numel(),) + tuple(vals.shape[1:]))
    return uniq, out.index_add_(0, inv, vals)


class BaseSparseNDArray(NDArray):
    """What the two sparse storage types share: the dense ``shape``,
    ``data`` and ``indices`` as NDArrays, ``nnz``, ``todense``,
    ``tostype``, ``astype`` and ``copyto``."""

    __slots__ = ("_dense_shape", "_indices")

    def _init(self, values, indices, shape, ctx):
        self._data, self._indices = values, indices
        self._dense_shape = tuple(int(s) for s in shape)
        self._ctx = ctx
        self._grad, self._grad_req, self._is_predicate = None, "null", False

    @property
    def data(self) -> NDArray:
        return _wrap(self._data, self._ctx)

    @property
    def indices(self) -> NDArray:
        return _wrap(self._indices, self._ctx)

    @property
    def shape(self):
        return self._dense_shape

    @property
    def size(self):
        return math.prod(self._dense_shape)

    @property
    def ndim(self):
        return len(self._dense_shape)

    @property
    def nnz(self) -> int:
        return int(self._data.shape[0])

    def asnumpy(self):
        return self.todense().asnumpy()

    def __repr__(self):
        return (f"<{type(self).__name__} {self._dense_shape} nnz={self.nnz} "
                f"@{self._ctx}>")

    def __len__(self):
        return self._dense_shape[0]

    def astype(self, dtype, copy=True):
        out = self._clone()
        out._data = self._data.to(DTypes.torch(dtype))
        return out

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self.todense(), stype)

    def copyto(self, other):
        if isinstance(other, Context):
            return self.as_in_context(other)
        if isinstance(other, BaseSparseNDArray):
            if other.stype != self.stype:
                raise MXNetError(f"copyto: stype mismatch {self.stype} vs "
                                 f"{other.stype}")
            src = self.as_in_context(other._ctx)
            for slot in self._storage_slots():
                setattr(other, slot, getattr(src, slot))
            other._dense_shape = self._dense_shape
            return other
        other._set_data(self.todense()._data.to(
            device=other._data.device, dtype=other._data.dtype))
        return other

    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        out = self._clone()
        for slot in self._storage_slots():
            setattr(out, slot, getattr(self, slot).to(ctx.torch_device()))
        out._ctx = ctx
        return out


class RowSparseNDArray(BaseSparseNDArray):
    """A row-sparse tensor: the stored leading-axis slices (rows) of a
    dense shape, the others zero (``kRowSparseStorage``)."""

    __slots__ = ()

    def __init__(self, values, indices, shape, ctx=None):
        ctx = ctx or (values.context if isinstance(values, NDArray)
                      else current_context())
        vals = _tensor(values, ctx)
        if vals.dim() != len(shape):
            raise MXNetError(
                f"row_sparse values rank {vals.dim()} must match dense rank "
                f"{len(shape)} (values carry the row slices)")
        self._init(vals, _index(indices, ctx), shape, ctx)

    @classmethod
    def _of(cls, values, indices, shape, ctx):
        out = cls.__new__(cls)
        out._init(values, indices, shape, ctx)
        return out

    stype = property(lambda self: "row_sparse")

    def _storage_slots(self):
        return ("_data", "_indices")

    def _clone(self):
        return RowSparseNDArray._of(self._data, self._indices,
                                    self._dense_shape, self._ctx)

    def _assign(self, indices, values):
        """Swap the storage in place (a gradient buffer's new rows)."""
        self._indices, self._data = indices, values
        return self

    def todense(self) -> NDArray:
        out = self._data.new_zeros(self._dense_shape)
        keep = self._indices < self._dense_shape[0]
        idx, vals = self._indices, self._data
        if not bool(keep.all()):
            idx, vals = idx[keep], vals[keep]
        return _wrap(out.index_add_(0, idx, vals), self._ctx)

    def retain(self, indices):
        return retain(self, indices)

    def dedup(self) -> "RowSparseNDArray":
        """Sorted unique row ids with their rows summed."""
        uniq, vals = _dedup(self._indices, self._data, self._dense_shape[0])
        return RowSparseNDArray._of(vals, uniq, self._dense_shape, self._ctx)

    def __mul__(self, other):
        if isinstance(other, (int, float, np.number)):
            return RowSparseNDArray._of(self._data * other, self._indices,
                                        self._dense_shape, self._ctx)
        return self.todense() * other

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return add_n([self, other])
        return self.todense() + other

    def __radd__(self, other):
        return self.todense().__radd__(other)


class CSRNDArray(BaseSparseNDArray):
    """A 2-D compressed-sparse-row tensor (``kCSRStorage``)."""

    __slots__ = ("_indptr", "_row_ids")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        ctx = ctx or (data.context if isinstance(data, NDArray)
                      else current_context())
        if len(shape) != 2:
            raise MXNetError("csr storage is 2-D only")
        self._init(_tensor(data, ctx).reshape(-1), _index(indices, ctx),
                   shape, ctx)
        self._set_indptr(_index(indptr, ctx))

    def _set_indptr(self, indptr):
        self._indptr = indptr
        # each stored value's row, expanded from indptr once
        self._row_ids = torch.repeat_interleave(
            torch.arange(indptr.numel() - 1, device=indptr.device),
            indptr.diff())

    stype = property(lambda self: "csr")

    @property
    def indptr(self) -> NDArray:
        return _wrap(self._indptr, self._ctx)

    def _storage_slots(self):
        return ("_data", "_indices", "_indptr", "_row_ids")

    def _clone(self):
        out = CSRNDArray.__new__(CSRNDArray)
        out._init(self._data, self._indices, self._dense_shape, self._ctx)
        out._indptr, out._row_ids = self._indptr, self._row_ids
        return out

    def _with_data(self, data):
        out = self._clone()
        out._data = data
        return out

    def todense(self) -> NDArray:
        out = self._data.new_zeros(self._dense_shape)
        out.index_put_((self._row_ids, self._indices), self._data,
                       accumulate=True)
        return _wrap(out, self._ctx)

    def _same_pattern(self, other) -> bool:
        return self._data.shape == other._data.shape and \
            torch.equal(self._indptr, other._indptr) and \
            torch.equal(self._indices, other._indices)

    def __mul__(self, other):
        if isinstance(other, (int, float, np.number)):
            return self._with_data(self._data * other)
        if isinstance(other, CSRNDArray) and self._same_pattern(other):
            return self._with_data(self._data * other._data)
        if isinstance(other, CSRNDArray):
            return cast_storage(self.todense() * other.todense(), "csr")
        return self.todense() * other

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, CSRNDArray) and self._same_pattern(other):
            return self._with_data(self._data + other._data)
        if isinstance(other, CSRNDArray):
            return cast_storage(self.todense() + other.todense(), "csr")
        return self.todense() + other

    def __radd__(self, other):
        return self.todense().__radd__(other)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """``row_sparse_array((data, indices), shape=...)``, or from a dense
    array."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        ctx = ctx or current_context()
        vals = _tensor(data, ctx, dtype or (None if isinstance(
            data, (NDArray, torch.Tensor)) else "float32"))
        if shape is None:
            idx = np.asarray(indices)
            shape = (int(idx.max()) + 1 if idx.size else 0,) + \
                tuple(vals.shape[1:])
        return RowSparseNDArray(vals, indices, shape, ctx=ctx)
    if isinstance(arg1, (NDArray, np.ndarray, list)):
        dense = arg1 if isinstance(arg1, NDArray) else \
            NDArray(arg1, ctx=ctx, dtype=dtype)
        return cast_storage(dense, "row_sparse")
    raise MXNetError(f"cannot build row_sparse from {type(arg1)}")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """``csr_matrix((data, indices, indptr), shape=...)``, or from a dense
    array or a scipy matrix."""
    if isinstance(arg1, CSRNDArray):
        return arg1
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            idx = np.asarray(indices)
            shape = (len(np.asarray(indptr)) - 1,
                     int(idx.max()) + 1 if idx.size else 0)
        vals = _tensor(data, ctx, dtype or (None if isinstance(
            data, (NDArray, torch.Tensor)) else "float32"))
        return CSRNDArray(vals, indices, indptr, shape, ctx=ctx)
    if hasattr(arg1, "tocsr"):   # a scipy matrix
        m = arg1.tocsr()
        return CSRNDArray(_tensor(m.data, ctx, dtype or "float32"),
                          m.indices, m.indptr, m.shape, ctx=ctx)
    if isinstance(arg1, (NDArray, np.ndarray, list)):
        dense = arg1 if isinstance(arg1, NDArray) else \
            NDArray(arg1, ctx=ctx, dtype=dtype)
        return cast_storage(dense, "csr")
    raise MXNetError(f"cannot build csr from {type(arg1)}")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage type ``stype`` (nnz 0)."""
    ctx = ctx or current_context()
    dt = DTypes.torch(dtype or "float32")
    dev = ctx.torch_device()
    if isinstance(shape, int):
        shape = (shape,)
    no_ids = torch.zeros(0, dtype=torch.int64, device=dev)
    if stype == "row_sparse":
        return RowSparseNDArray._of(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            no_ids, shape, ctx)
    if stype == "csr":
        return CSRNDArray(torch.zeros(0, dtype=dt, device=dev), no_ids,
                          torch.zeros(shape[0] + 1, dtype=torch.int64,
                                      device=dev), shape, ctx=ctx)
    if stype == "default":
        return _wrap(torch.zeros(shape, dtype=dt, device=dev), ctx)
    raise MXNetError(f"unknown stype {stype!r}")


empty = zeros


def array(source, ctx=None, dtype=None):
    """An array that keeps the source's storage type."""
    if isinstance(source, BaseSparseNDArray):
        return source
    if hasattr(source, "tocsr"):
        return csr_matrix(source, ctx=ctx, dtype=dtype)
    return NDArray(source, ctx=ctx, dtype=dtype)


def from_coo(g, shape, ctx) -> RowSparseNDArray:
    """A ``RowSparseNDArray`` from an uncoalesced sparse COO gradient
    (row ids as its first index dimension): rows summed by id."""
    uniq, vals = _dedup(g._indices()[0], g._values(), shape[0])
    return RowSparseNDArray._of(vals, uniq, shape, ctx)


# ---------------------------------------------------------------------------
# storage casts and ops
# ---------------------------------------------------------------------------
def cast_storage(arr, stype: str):
    """Dense <-> sparse conversion (``cast_storage-inl.h``). Dense to
    sparse keeps the rows (row_sparse) or values (csr) that are nonzero."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    t, ctx = arr._data.detach(), arr.context
    if stype == "row_sparse":
        flat = t.reshape(t.shape[0], -1) if t.dim() > 1 else t.reshape(-1, 1)
        rows = flat.ne(0).any(dim=1).nonzero().reshape(-1)
        return RowSparseNDArray._of(t[rows], rows, tuple(t.shape), ctx)
    if stype == "csr":
        if t.dim() != 2:
            raise MXNetError("csr storage is 2-D only")
        rows, cols = t.ne(0).nonzero(as_tuple=True)
        indptr = torch.zeros(t.shape[0] + 1, dtype=torch.int64,
                             device=t.device)
        indptr[1:] = torch.bincount(rows, minlength=t.shape[0]).cumsum(0)
        return CSRNDArray(t[rows, cols], cols, indptr, tuple(t.shape),
                          ctx=ctx)
    raise MXNetError(f"unknown stype {stype!r}")


def retain(rsp: RowSparseNDArray, indices):
    """The rows of ``rsp`` whose ids are in ``indices`` (``sparse_retain``);
    the storage keeps exactly those rows."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    want = _index(indices, rsp._ctx)
    keep = torch.isin(rsp._indices, want) & \
        (rsp._indices < rsp._dense_shape[0])
    return RowSparseNDArray._of(rsp._data[keep], rsp._indices[keep],
                                rsp._dense_shape, rsp._ctx)


def add_n(arrays):
    """The sum of arrays: row-sparse ones stay row-sparse (their rows
    concatenated, then summed by id); with any other operand, dense."""
    arrays = [a for a in arrays if not (isinstance(a, BaseSparseNDArray)
                                        and a.nnz == 0)]
    if not arrays:
        raise MXNetError("add_n of empty/all-zero input needs a shape")
    if not all(isinstance(a, RowSparseNDArray) for a in arrays):
        out = None
        for a in arrays:
            d = a.todense() if isinstance(a, BaseSparseNDArray) else a
            out = d if out is None else out + d
        return out
    if len(arrays) == 1:
        return arrays[0]
    first = arrays[0]
    uniq, vals = _dedup(torch.cat([a._indices for a in arrays]),
                        torch.cat([a._data for a in arrays]),
                        first._dense_shape[0])
    return RowSparseNDArray._of(vals, uniq, first._dense_shape, first._ctx)


def elemwise_add(lhs, rhs):
    """Elementwise sum; same-pattern CSR and row-sparse pairs stay
    sparse, anything else is dense."""
    if isinstance(lhs, BaseSparseNDArray):
        return lhs + rhs
    if isinstance(rhs, BaseSparseNDArray):
        return rhs + lhs
    return lhs + rhs


def elemwise_mul(lhs, rhs):
    """Elementwise product; a scalar times sparse and same-pattern CSR
    pairs stay sparse."""
    if isinstance(lhs, BaseSparseNDArray):
        return lhs * rhs
    if isinstance(rhs, BaseSparseNDArray):
        return rhs * lhs
    return lhs * rhs


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse ``dot`` (``dot-inl.h``): csr . dense and csr^T . dense
    scatter each stored value's product into its output row; row-sparse .
    dense multiplies the stored rows only; csr . csr densifies the right
    operand; other combinations run dense."""
    from ..ops.tensor import dot as dense_dot
    dense_rhs = isinstance(rhs, NDArray) and \
        not isinstance(rhs, BaseSparseNDArray)
    if isinstance(lhs, CSRNDArray) and dense_rhs and not transpose_b:
        m, n = lhs._dense_shape
        src, dst = (lhs._row_ids, lhs._indices) if transpose_a else \
            (lhs._indices, lhs._row_ids)
        contrib = lhs._data[:, None] * rhs._data[src]
        out = contrib.new_zeros((n if transpose_a else m, contrib.shape[1]))
        return _wrap(out.index_add_(0, dst, contrib), rhs.context)
    if isinstance(lhs, RowSparseNDArray) and not transpose_a and dense_rhs:
        r = rhs._data.t() if transpose_b else rhs._data
        contrib = lhs._data @ r
        out = contrib.new_zeros((lhs._dense_shape[0], r.shape[1]))
        keep = lhs._indices < lhs._dense_shape[0]
        return _wrap(out.index_add_(0, lhs._indices[keep], contrib[keep]),
                     rhs.context)
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, BaseSparseNDArray) \
            and not transpose_b:
        return dot(lhs, rhs.todense(), transpose_a=transpose_a)
    lhs_d = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rhs_d = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return _wrap(dense_dot(lhs_d._data, rhs_d._data, transpose_a=transpose_a,
                           transpose_b=transpose_b), lhs_d.context)


def square_sum(data, axis=None, keepdims=False):
    """``_square_sum``: the sum of squares along ``axis`` (None, 0 or 1),
    over the stored rows only for a row-sparse input; a dense result."""
    if not isinstance(data, RowSparseNDArray):
        t = data._data if isinstance(data, NDArray) else torch.as_tensor(data)
        dims = tuple(range(t.dim())) if axis is None else axis
        return _wrap(torch.sum(torch.square(t), dim=dims, keepdim=keepdims),
                     _context_of(t))
    vals, idx, n = data._data, data._indices, data._dense_shape[0]
    valid = (idx < n).reshape((-1,) + (1,) * (vals.dim() - 1))
    sq = torch.square(vals) * valid.to(vals.dtype)
    if axis in (None, (0, 1)):
        out = torch.sum(sq)
        if keepdims:
            out = out.reshape((1,) * len(data.shape))
    elif axis in (0, (0,)):
        out = torch.sum(sq, dim=0)
        if keepdims:
            out = out[None]
    elif axis in (1, (1,)):
        per_row = torch.sum(sq.reshape(sq.shape[0], -1), dim=1)
        out = per_row.new_zeros(n + 1).index_add_(
            0, torch.where(idx < n, idx, n), per_row)[:n]
        if keepdims:
            out = out[:, None]
    else:
        raise ValueError("_square_sum(row_sparse) supports axis None/0/1")
    return _wrap(out, data.context)
