"""Core substrate of the port: errors, the device model and dtype names.

The counterpart of ``mxnet_tpu/base.py``. ``Context`` keeps the reference's
``cpu(i)`` / ``gpu(i)`` surface and maps it onto a ``torch.device``. The
default context is the card, ``gpu(0)``: the port runs on the GPU unless the
caller asks for ``cpu()``, and a GPU context on a host without CUDA raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "DTypes", "Registry"]


class MXNetError(RuntimeError):
    """Framework-level error (parity with dmlc::Error surfaced as MXNetError)."""


class Context:
    """Execution device: ``cpu(i)`` or ``gpu(i)`` (the i-th visible CUDA
    card). Usable as a ``with`` scope that sets :func:`current_context`."""

    _default = threading.local()

    def __init__(self, device_type: str, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}; "
                             "expected 'cpu' or 'gpu'")
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names. Raises MXNetError for a
        GPU context when CUDA is absent or the card index does not exist."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self}: CUDA is not available; pass ctx=cpu() to run on "
                "the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"{self}: only {n} CUDA device(s) visible")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        stack = getattr(Context._default, "stack", None)
        if stack is None:
            stack = Context._default.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()
        return False


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``."""
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


class DTypes:
    """dtype names (the reference's strings) to torch and numpy dtypes."""

    _ALIASES = {"float": "float32", "double": "float64", "half": "float16",
                "bf16": "bfloat16", "fp16": "float16", "int": "int32",
                "long": "int64", "bool_": "bool"}
    _TORCH = {"float32": torch.float32, "float64": torch.float64,
              "float16": torch.float16, "bfloat16": torch.bfloat16,
              "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
              "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}

    @staticmethod
    def canonical(dtype) -> str:
        if dtype is None:
            return "float32"
        if isinstance(dtype, torch.dtype):
            name = str(dtype).rpartition(".")[2]
        elif isinstance(dtype, str):
            name = dtype
        else:
            name = np.dtype(dtype).name
        name = DTypes._ALIASES.get(name, name)
        if name not in DTypes._TORCH:
            raise MXNetError(f"unsupported dtype {dtype!r}")
        return name

    @staticmethod
    def torch(dtype) -> torch.dtype:
        return DTypes._TORCH[DTypes.canonical(dtype)]

    @staticmethod
    def numpy(dtype) -> np.dtype:
        """Host dtype for request inputs. numpy has no bfloat16, so bf16
        inputs are refused; model weights may be bf16, inputs are ids or
        f32 features cast on the host."""
        name = DTypes.canonical(dtype)
        if name == "bfloat16":
            raise MXNetError("bfloat16 has no numpy dtype; serve float32 "
                             "inputs to a bf16 model instead")
        return np.dtype(name)


class Registry:
    """Name -> class table (the reference's ``Registry``): keys are lower
    case, so ``get("SGD")`` and ``get("sgd")`` find the same entry."""

    def __init__(self, name: str):
        self.name = name
        self._entries = {}

    def register(self, name=None, override: bool = False):
        def deco(obj):
            key = (name or obj.__name__).lower()
            if key in self._entries and not override:
                raise MXNetError(f"{self.name} registry: duplicate entry "
                                 f"{key!r}")
            self._entries[key] = obj
            return obj
        return deco

    def get(self, name: str):
        key = name.lower()
        if key not in self._entries:
            raise MXNetError(f"{self.name} registry: unknown entry {name!r}; "
                             f"known: {sorted(self._entries)}")
        return self._entries[key]

    def __contains__(self, name):
        return name.lower() in self._entries
