"""Writer and reader of the ``.params`` container of
``mxnet_tpu/ndarray/utils.py`` (the reference's NDArray list format): uint64
magic 0x112 and a reserved word, a vector of NDArray records (V2 record
magic, int32 storage type, TShape as int32 ndim + int64 dims, a context of
two int32s, an int32 mshadow type flag, raw little-endian data), then a
vector of name strings.

The port keeps its own copy and handles dense records only: a row-sparse
or CSR record raises. :func:`save` writes the bytes the JAX package writes
for the same arrays (context recorded as cpu(0)), so files cross between
the packages in both directions. :func:`load` returns NDArrays;
:func:`read` the host tensors (bf16 as ``torch.bfloat16``).
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
_STYPE_DEFAULT = 0
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


def _write_one(f, arr: NDArray):
    name, raw = _host_bytes(arr._data)
    dims = tuple(arr.shape)
    f.write(struct.pack("<I", _V2_MAGIC))
    f.write(struct.pack("<i", _STYPE_DEFAULT))
    f.write(struct.pack("<i", len(dims)))
    if dims:
        f.write(struct.pack(f"<{len(dims)}q", *dims))
    f.write(struct.pack("<ii", 1, 0))             # context: kCPU, dev 0
    f.write(struct.pack("<i", _TYPE_FLAG[name]))
    f.write(raw)


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


def _read_one(f) -> torch.Tensor:
    (magic,) = _unpack(f, "<I")
    if magic not in _RECORD_MAGICS:
        raise MXNetError(f"load: unsupported NDArray record magic {magic:#x}")
    (stype,) = _unpack(f, "<i")
    if stype != _STYPE_DEFAULT:
        raise MXNetError(f"load: storage type {stype} (sparse) is not "
                         "supported; save dense parameters")
    (ndim,) = _unpack(f, "<i")
    shape = _unpack(f, f"<{ndim}q") if ndim > 0 else ()
    _unpack(f, "<ii")                        # context: placement is ours
    (flag,) = _unpack(f, "<i")
    if flag not in _FLAG_TYPE:
        raise MXNetError(f"load: unknown type flag {flag}")
    name = _FLAG_TYPE[flag]
    dt = np.dtype("int16" if name == "bfloat16" else name)
    n = int(np.prod(shape, dtype=np.int64))
    buf = f.read(dt.itemsize * n)
    if len(buf) != dt.itemsize * n:
        raise MXNetError("load: truncated .params file")
    t = torch.from_numpy(np.frombuffer(buf, dtype=dt).reshape(shape).copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def read(fname: str) -> Union[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The file's arrays as CPU tensors: a dict name -> tensor for a named
    file, else a list."""
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


def load(fname: str, ctx=None) -> Union[List[NDArray], Dict[str, NDArray]]:
    """The file's arrays as NDArrays on ``ctx`` (default
    :func:`current_context`): a dict for a named file, else a list."""
    ctx = ctx or current_context()
    dev = ctx.torch_device()
    got = read(fname)
    if isinstance(got, dict):
        return {k: _wrap(t.to(dev), ctx) for k, t in got.items()}
    return [_wrap(t.to(dev), ctx) for t in got]
