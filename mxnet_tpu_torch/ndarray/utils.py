"""Writer and reader of the ``.params`` container of
``mxnet_tpu/ndarray/utils.py`` (the reference's NDArray list format): uint64
magic 0x112 and a reserved word, a vector of NDArray records (V2 record
magic, int32 storage type, TShape as int32 ndim + int64 dims, a context of
two int32s, an int32 mshadow type flag, raw little-endian data), then a
vector of name strings.

Sparse records (``ndarray/utils.py:64-152`` of the JAX package) follow the
storage type with the storage shape, then the dense shape, the context and
the type flag, one (type flag, shape) per auxiliary array, the values and
the auxiliaries: row-sparse (storage type 1) has its int64 row ids, CSR
(2) its int64 indptr, then its int64 column ids. A row-sparse array is
written with its rows summed by id and any padding row (id = rows) left
out, as the reference writes it.

The port keeps its own copy. :func:`save` writes the bytes the JAX package
writes for the same arrays (context recorded as cpu(0)), so files cross
between the packages in both directions. :func:`load` returns NDArrays
(``RowSparseNDArray``/``CSRNDArray`` for sparse records); :func:`read`
the host tensors of a file of dense records (bf16 as ``torch.bfloat16``;
a sparse record raises).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import DTypes, MXNetError, current_context
from .ndarray import NDArray, _wrap

__all__ = ["save", "load", "read"]

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_RECORD_MAGICS = (_V2_MAGIC, 0xF993FACA)   # NDARRAY_V2_MAGIC, V3
_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
# mshadow/base.h TypeFlag
_TYPE_FLAG = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
              "int32": 4, "int8": 5, "int64": 6, "bool": 7, "int16": 8,
              "uint16": 9, "uint32": 10, "uint64": 11, "bfloat16": 12}
_FLAG_TYPE = {v: k for k, v in _TYPE_FLAG.items()}


def _unpack(f, fmt):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise MXNetError("load: truncated .params file")
    return struct.unpack(fmt, buf)


def _host_bytes(t: torch.Tensor):
    """(type name, raw little-endian bytes) of a tensor."""
    name = DTypes.canonical(t.dtype)
    t = t.detach().cpu().contiguous()
    if name == "bfloat16":
        t = t.view(torch.int16)
    return name, t.numpy().tobytes()


def _write_shape(f, dims):
    f.write(struct.pack("<i", len(dims)))
    if dims:
        f.write(struct.pack(f"<{len(dims)}q", *dims))


def _write_one(f, arr: NDArray):
    stype = arr.stype
    if stype == "row_sparse":
        arr = arr.dedup()
        aux = [arr._indices]
    elif stype == "csr":
        aux = [arr._indptr, arr._indices]
    name, raw = _host_bytes(arr._data)
    f.write(struct.pack("<I", _V2_MAGIC))
    if stype == "default":
        f.write(struct.pack("<i", _STYPE_DEFAULT))
        _write_shape(f, tuple(arr.shape))
    else:
        f.write(struct.pack("<i", _STYPE_ROW_SPARSE if stype == "row_sparse"
                            else _STYPE_CSR))
        _write_shape(f, tuple(arr._data.shape))   # storage shape
        _write_shape(f, tuple(arr.shape))
    f.write(struct.pack("<ii", 1, 0))             # context: kCPU, dev 0
    f.write(struct.pack("<i", _TYPE_FLAG[name]))
    if stype != "default":
        for a in aux:
            f.write(struct.pack("<i", _TYPE_FLAG["int64"]))
            _write_shape(f, tuple(a.shape))
    f.write(raw)
    if stype != "default":
        for a in aux:
            f.write(_host_bytes(a.long())[1])


def save(fname: str, data) -> None:
    """Save an NDArray, a list of them or a str-keyed dict of them."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        raise MXNetError("save expects NDArray, list, or dict of NDArrays")
    for i, v in enumerate(arrays):
        if not isinstance(v, NDArray):
            raise MXNetError(f"save: item {i} is not an NDArray")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for a in arrays:
            _write_one(f, a)
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def _read_shape(f):
    (ndim,) = _unpack(f, "<i")
    return _unpack(f, f"<{ndim}q") if ndim > 0 else ()


def _read_flag(f):
    (flag,) = _unpack(f, "<i")
    if flag not in _FLAG_TYPE:
        raise MXNetError(f"load: unknown type flag {flag}")
    return _FLAG_TYPE[flag]


def _read_tensor(f, name, shape) -> torch.Tensor:
    dt = np.dtype("int16" if name == "bfloat16" else name)
    n = int(np.prod(shape, dtype=np.int64))
    buf = f.read(dt.itemsize * n)
    if len(buf) != dt.itemsize * n:
        raise MXNetError("load: truncated .params file")
    t = torch.from_numpy(np.frombuffer(buf, dtype=dt).reshape(shape).copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _read_one(f):
    """A dense record's tensor, or a sparse record as a sparse array on
    ``cpu()``."""
    (magic,) = _unpack(f, "<I")
    if magic not in _RECORD_MAGICS:
        raise MXNetError(f"load: unsupported NDArray record magic {magic:#x}")
    (stype,) = _unpack(f, "<i")
    n_aux = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}.get(stype)
    if n_aux is None:
        raise MXNetError(f"load: unknown storage type {stype}")
    storage_shape = _read_shape(f) if n_aux else None
    shape = _read_shape(f)
    _unpack(f, "<ii")                        # context: placement is ours
    name = _read_flag(f)
    aux = [(_read_flag(f), _read_shape(f)) for _ in range(n_aux)]
    data = _read_tensor(f, name, storage_shape if n_aux else shape)
    if not n_aux:
        return data
    aux = [_read_tensor(f, n, sh).long() for n, sh in aux]
    from .. import sparse
    from ..base import cpu
    if stype == _STYPE_ROW_SPARSE:
        return sparse.RowSparseNDArray(data, aux[0], shape, ctx=cpu())
    return sparse.CSRNDArray(data, aux[1], aux[0], shape, ctx=cpu())


def _read_file(fname: str):
    """The file's records: dense ones as CPU tensors, sparse ones as sparse
    arrays on ``cpu()``; a dict for a named file, else a list."""
    with open(fname, "rb") as f:
        magic, _reserved = _unpack(f, "<QQ")
        if magic != _LIST_MAGIC:
            raise MXNetError(f"{fname}: not a .params file (magic "
                             f"{magic:#x})")
        (count,) = _unpack(f, "<Q")
        arrays = [_read_one(f) for _ in range(count)]
        (n_names,) = _unpack(f, "<Q")
        names = []
        for _ in range(n_names):
            (ln,) = _unpack(f, "<Q")
            names.append(f.read(ln).decode("utf-8"))
    return dict(zip(names, arrays)) if names else arrays


def read(fname: str) -> Union[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The file's arrays as CPU tensors: a dict name -> tensor for a named
    file, else a list. A sparse record is no tensor and raises
    (:func:`load` reads it)."""
    got = _read_file(fname)
    for t in (got.values() if isinstance(got, dict) else got):
        if isinstance(t, NDArray):
            raise MXNetError(f"read: {fname} holds a {t.stype} (sparse) "
                             "record, which is no tensor; ndarray.load "
                             "reads it")
    return got


def load(fname: str, ctx=None) -> Union[List[NDArray], Dict[str, NDArray]]:
    """The file's arrays as NDArrays on ``ctx`` (default
    :func:`current_context`): a dict for a named file, else a list."""
    ctx = ctx or current_context()
    dev = ctx.torch_device()

    def place(t):
        if isinstance(t, NDArray):    # a sparse record
            return t.as_in_context(ctx)
        return _wrap(t.to(dev), ctx)
    got = _read_file(fname)
    if isinstance(got, dict):
        return {k: place(t) for k, t in got.items()}
    return [place(t) for t in got]
