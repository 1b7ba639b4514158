"""TensorInspector, a tensor debugging tool (the counterpart of
``mxnet_tpu/tensor_inspector.py``, MXNet's
``src/common/tensor_inspector.h``: ``print_string``, ``check_value`` with
the CheckerType set, ``dump_to_file``).

The values are copied to the host once (an NDArray or tensor on the card
included) and every check is vectorized numpy; ``check_value`` returns the
positions where the checker fires instead of MXNet's interactive print.
"""
from __future__ import annotations

import numpy as onp
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["TensorInspector", "CheckerType"]


class CheckerType:
    """Checker names (``tensor_inspector.h:71`` CheckerType)."""
    NegativeChecker = "negative"
    PositiveChecker = "positive"
    ZeroChecker = "zero"
    NaNChecker = "nan"
    InfChecker = "inf"
    PositiveInfChecker = "positive_inf"
    NegativeInfChecker = "negative_inf"
    FiniteChecker = "finite"
    NormalChecker = "normal"
    AbnormalChecker = "abnormal"


_CHECKS = {
    "negative": lambda a: a < 0,
    "positive": lambda a: a > 0,
    "zero": lambda a: a == 0,
    "nan": onp.isnan,
    "inf": onp.isinf,
    "positive_inf": onp.isposinf,
    "negative_inf": onp.isneginf,
    "finite": onp.isfinite,
    "normal": lambda a: ~(onp.isnan(a) | onp.isinf(a)),
    "abnormal": lambda a: onp.isnan(a) | onp.isinf(a),
}
_FLOAT_CHECKS = ("nan", "inf", "positive_inf", "negative_inf", "finite",
                 "normal", "abnormal")


class TensorInspector:
    """Inspect a tensor's values (``tensor_inspector.h:103``).

    >>> ti = TensorInspector(arr)
    >>> print(ti.to_string())
    >>> bad = ti.check_value(CheckerType.AbnormalChecker)
    """

    def __init__(self, tensor, tag=""):
        if isinstance(tensor, NDArray):
            self._np = tensor.asnumpy()
        elif isinstance(tensor, torch.Tensor):
            t = tensor.detach().cpu()
            self._np = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            self._np = onp.asarray(tensor)
        self.tag = tag

    def to_string(self, max_elems=64):
        """A dtype and shape header and the (truncated) values: the
        ``print_string`` text."""
        flat = self._np.reshape(-1)
        body = onp.array2string(self._np if flat.size <= max_elems
                                else flat[:max_elems], threshold=max_elems)
        suffix = "" if flat.size <= max_elems else \
            f" ... ({flat.size - max_elems} more)"
        tag = f"[{self.tag}] " if self.tag else ""
        return f"{tag}<{self._np.dtype} {self._np.shape}> {body}{suffix}"

    def print_string(self, max_elems=64):
        print(self.to_string(max_elems))

    def check_value(self, checker, full=False):
        """Positions where ``checker`` fires: a CheckerType name or a
        callable from the numpy values to a boolean mask. A list of index
        tuples (every one with ``full``, else at most 1000, the
        reference's print cap)."""
        if callable(checker):
            mask = checker(self._np)
        elif checker in _CHECKS:
            arr = self._np
            if not onp.issubdtype(arr.dtype, onp.floating) and \
                    checker in _FLOAT_CHECKS:
                arr = arr.astype(onp.float64)
            mask = _CHECKS[checker](arr)
        else:
            raise MXNetError(f"unknown checker {checker!r}; one of "
                             f"{sorted(_CHECKS)}")
        pos = onp.argwhere(mask)
        if not full:
            pos = pos[:1000]
        return [tuple(int(v) for v in p) for p in pos]

    def dump_to_file(self, tag, rank=0):
        """Write the values to ``<tag>_<rank>.npy`` (``.npy`` in place of
        MXNet's own binary layout); the file name returned."""
        fname = f"{tag}_{rank}.npy"
        onp.save(fname, self._np)
        return fname
