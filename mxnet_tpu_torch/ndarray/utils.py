"""Reader of the ``.params`` container that ``mxnet_tpu/ndarray/utils.py``
writes (the reference's NDArray list format): uint64 magic 0x112 and a
reserved word, a vector of NDArray records (V2/V3 record magic, int32
storage type, TShape as int32 ndim + int64 dims, a context of two int32s,
an int32 mshadow type flag, raw little-endian data), then a vector of name
strings.

The port keeps its own copy and reads dense records only: a row-sparse or
CSR record raises. Arrays come back as numpy, bf16 as ``torch.bfloat16``
tensors (numpy has no bf16).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["load"]

_LIST_MAGIC = 0x112
_RECORD_MAGICS = (0xF993FAC9, 0xF993FACA)   # NDARRAY_V2_MAGIC, V3
_STYPE_DEFAULT = 0
# mshadow/base.h TypeFlag
_FLAG_TYPE = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
              4: "int32", 5: "int8", 6: "int64", 7: "bool", 8: "int16",
              9: "uint16", 10: "uint32", 11: "uint64", 12: "bfloat16"}


def _unpack(f, fmt):
    size = struct.calcsize(fmt)
    buf = f.read(size)
    if len(buf) != size:
        raise MXNetError("load: truncated .params file")
    return struct.unpack(fmt, buf)


def _read_one(f):
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
    arr = np.frombuffer(buf, dtype=dt).reshape(shape).copy()
    return torch.from_numpy(arr).view(torch.bfloat16) \
        if name == "bfloat16" else arr


def load(fname: str) -> Union[List, Dict[str, object]]:
    """A dict name -> array for a named file, else a list of arrays."""
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
