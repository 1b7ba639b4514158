"""Runtime-compiled CUDA kernels: ``rtc.CudaModule`` and ``CudaKernel``.

K5 of the port, the counterpart of ``mxnet_tpu/rtc.py`` (``PallasModule``
and ``Kernel.launch``, whose ``pallas_call`` is ``rtc.py:64``) and of
upstream MXNet's ``python/mxnet/rtc.py:41`` ``CudaModule`` over NVRTC, whose
API it keeps. The source text is CUDA C++; it is compiled once, at
construction, for sm_90a into a cubin (``ops/_nvrtc.py``), loaded into a
card's primary context at first use there, and its kernels launch on
PyTorch's current stream of that card without synchronising::

    mod = rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float *x, const float *y, int n,
                                    float *o) {
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
             i += gridDim.x * blockDim.x)
            o[i] = 2.0f * x[i] + y[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, const float *y, int n, "
                               "float *o")
    out = k.launch([x, y, x.size], grid_dims=(64, 1, 1),
                   block_dims=(256, 1, 1), out_shapes=[x.shape])

A launch takes upstream's in-place form (output NDArrays among ``args``)
or the JAX package's allocating form (``out_shapes``/``out_dtypes``: the
outputs are made on ``ctx`` and passed after ``args``, in the signature's
order, and returned). Before the launch every argument is checked against
the signature: count, each array's dtype against its pointer type, its
device and contiguity, and each scalar's Python type. A CPU context or
array raises: a CUDA source has nothing to run on the CPU, and nothing
falls back. A launch the card refuses (too many threads, too much shared
memory) raises at the call.

``launches`` counts the kernels launched through :meth:`CudaKernel.launch`
in this process; each kernel also counts its own.
"""
from __future__ import annotations

import ctypes
import numbers
import re
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from .base import DTypes, MXNetError
from .ndarray.ndarray import NDArray, _wrap
from .ops import _nvrtc

__all__ = ["CudaModule", "CudaKernel", "Param", "parse_signature",
           "check_args", "launches"]

#: kernels launched through CudaKernel.launch in this process
launches = 0
_count_lock = threading.Lock()
_STATIC_SHARED_LIMIT = 48 * 1024   # above it, the function must opt in

# C type of a parameter -> (torch dtype, ctypes type of a scalar value)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
}
_INT_RANGE = {"int": 32, "int32_t": 32, "int64_t": 64}
_QUALIFIERS = {"const", "__restrict__", "__restrict", "restrict"}


class Param(NamedTuple):
    """One kernel parameter of a signature."""
    name: str
    ctype: str
    pointer: bool


def parse_signature(signature: str) -> List[Param]:
    """The parameters of a C signature string, e.g.
    ``"const float *x, const float *y, int n, float *o"``: pointers to, or
    scalars of, float, double, int/int32_t, int64_t, uint8_t, __half and
    __nv_bfloat16."""
    params = []
    for part in signature.split(","):
        part = part.strip()
        m = re.fullmatch(r"(.*?)([A-Za-z_]\w*)", part)
        if not part or m is None:
            raise MXNetError(f"rtc: cannot parse parameter {part!r} of "
                             f"signature {signature!r}")
        head, name = m.group(1), m.group(2)
        pointer = head.count("*")
        types = [w for w in head.replace("*", " ").split()
                 if w not in _QUALIFIERS]
        if pointer > 1 or len(types) != 1 or types[0] not in _TYPES:
            raise MXNetError(f"rtc: unsupported parameter {part!r}: a "
                             f"scalar of, or a pointer to, one of "
                             f"{sorted(_TYPES)}")
        params.append(Param(name, types[0], bool(pointer)))
    return params


def _scalar(p: Param, v):
    dtype, ctype = _TYPES[p.ctype]
    if dtype.is_floating_point:
        if isinstance(v, bool) or not isinstance(v, numbers.Real):
            raise MXNetError(f"rtc: argument {p.name!r} ({p.ctype}) must be "
                             f"a Python number, got {type(v).__name__}")
        if ctype is ctypes.c_uint16:     # __half / __nv_bfloat16 bits
            bits = torch.tensor(float(v), dtype=dtype).view(torch.int16)
            return ctype(int(bits.item()) & 0xFFFF)
        return ctype(float(v))
    if isinstance(v, bool) or not isinstance(v, numbers.Integral):
        raise MXNetError(f"rtc: argument {p.name!r} ({p.ctype}) must be a "
                         f"Python int, got {type(v).__name__}")
    v = int(v)
    bits = _INT_RANGE.get(p.ctype)
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if bits else (0, 256)
    if not lo <= v < hi:
        raise MXNetError(f"rtc: argument {p.name!r} = {v} is out of range "
                         f"for {p.ctype}")
    return ctype(v)


def check_args(params: Sequence[Param], values: Sequence,
               device: torch.device) -> list:
    """The ctypes values of one launch, after checking ``values`` (torch
    tensors and Python numbers) against ``params``: their count, each
    tensor's dtype against its pointer type, its device and contiguity, and
    each scalar's Python type. Raises MXNetError on the first mismatch."""
    if len(values) != len(params):
        raise MXNetError(f"rtc: the kernel takes {len(params)} arguments "
                         f"({', '.join(p.name for p in params)}), got "
                         f"{len(values)}")
    out = []
    for p, v in zip(params, values):
        if not p.pointer:
            out.append(_scalar(p, v))
            continue
        if not isinstance(v, torch.Tensor):
            raise MXNetError(f"rtc: argument {p.name!r} ({p.ctype} *) must "
                             f"be an NDArray, got {type(v).__name__}")
        want = _TYPES[p.ctype][0]
        if v.dtype != want:
            raise MXNetError(f"rtc: argument {p.name!r} must be "
                             f"{DTypes.canonical(want)} ({p.ctype} *), got "
                             f"{DTypes.canonical(v.dtype)}")
        if v.device != device:
            raise MXNetError(f"rtc: argument {p.name!r} lies on {v.device}, "
                             f"the launch on {device}")
        if not v.is_contiguous():
            raise MXNetError(f"rtc: argument {p.name!r} is not contiguous")
        out.append(ctypes.c_void_p(v.data_ptr()))
    return out


def _dims(d) -> tuple:
    d = tuple(d)
    if len(d) != 3:
        raise MXNetError(f"rtc: grid and block dims take (x, y, z), got {d}")
    return d


class CudaKernel:
    """A kernel of a :class:`CudaModule` with its parsed signature."""

    def __init__(self, module: "CudaModule", name: str, lowered: str,
                 signature: str):
        self.name = name
        self.params = parse_signature(signature)
        self.launches = 0      # this kernel's launches
        self._module = module
        self._lowered = lowered

    def launch(self, args, ctx=None, grid_dims=(1, 1, 1),
               block_dims=(1, 1, 1), shared_mem=0, out_shapes=None,
               out_dtypes=None):
        """Launch on ``ctx`` (default: the first NDArray's context) on
        PyTorch's current stream of that card, without synchronising.
        With ``out_shapes`` (and ``out_dtypes``, default the first
        array's dtype) the outputs are allocated, passed after ``args`` and
        returned: an NDArray, or a list of them."""
        global launches
        arrays = [a for a in args if isinstance(a, NDArray)]
        if ctx is None:
            if not arrays:
                raise MXNetError("rtc: launch needs ctx= when no argument "
                                 "is an NDArray")
            ctx = arrays[0].context
        if ctx.device_type != "gpu" or any(
                a.context.device_type != "gpu" for a in arrays):
            raise MXNetError(f"rtc: {self.name} launches on a GPU context; "
                             f"got {ctx} (a CUDA kernel has nothing to run "
                             "on the CPU)")
        device = ctx.torch_device()
        outs = []
        if out_shapes is not None:
            if out_dtypes is None:
                if not arrays:
                    raise MXNetError("rtc: out_dtypes is needed when no "
                                     "argument is an NDArray")
                out_dtypes = [arrays[0]._data.dtype] * len(out_shapes)
            outs = [_wrap(torch.empty(tuple(s), dtype=DTypes.torch(d),
                                      device=device), ctx)
                    for s, d in zip(out_shapes, out_dtypes)]
        values = check_args(self.params,
                            [a._data if isinstance(a, NDArray) else a
                             for a in args] + [o._data for o in outs],
                            device)
        fn = self._module._function(self._lowered, device.index, shared_mem)
        _nvrtc.launch(fn, device.index, _dims(grid_dims), _dims(block_dims),
                      int(shared_mem),
                      torch.cuda.current_stream(device).cuda_stream, values)
        with _count_lock:
            launches += 1
            self.launches += 1
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else outs


class CudaModule:
    """CUDA C++ source compiled at run time for sm_90a (upstream
    ``rtc.py:41``). ``options`` go to NVRTC after the architecture and the
    toolkit's include directory; ``exports``, if given, are the only names
    :meth:`get_kernel` returns, and enter as name expressions, so templated
    or C++-mangled kernels resolve through their lowered names. Without
    ``exports`` a name must be an ``extern "C"`` kernel."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        self._exports = (exports,) if isinstance(exports, str) \
            else tuple(exports)
        self._cubin, self._lowered, self.compile_seconds = \
            _nvrtc.compile_cubin(source, "rtc.cu", tuple(options),
                                 self._exports)
        self._lock = threading.Lock()
        self._cu_modules: Dict[int, ctypes.c_void_p] = {}
        self._functions: Dict[tuple, Optional[ctypes.c_void_p]] = {}
        self._shared: Dict[tuple, int] = {}

    def _function(self, lowered: str, device: int, shared_mem: int = 0):
        """The CUfunction of ``lowered`` on card ``device`` (None if the
        module has none), loading the module there first; opts the function
        in to ``shared_mem`` bytes of dynamic shared memory above 48 KB."""
        key = (lowered, device)
        with self._lock:
            if key not in self._functions:
                mod = self._cu_modules.get(device)
                if mod is None:
                    mod = _nvrtc.load_module(self._cubin, device)
                    self._cu_modules[device] = mod
                self._functions[key] = _nvrtc.get_function(mod, lowered,
                                                           device)
            fn = self._functions[key]
            if fn is not None and shared_mem > max(
                    _STATIC_SHARED_LIMIT, self._shared.get(key, 0)):
                _nvrtc.set_max_dynamic_shared(fn, shared_mem, device)
                self._shared[key] = shared_mem
        return fn

    def get_kernel(self, name: str, signature: str) -> CudaKernel:
        """The kernel ``name`` with upstream's C ``signature`` string."""
        if self._exports and name not in self._exports:
            raise MXNetError(f"kernel {name!r} not exported")
        kernel = CudaKernel(self, name, self._lowered.get(name, name),
                            signature)
        if self._function(kernel._lowered,
                          torch.cuda.current_device()) is None:
            raise MXNetError(f"kernel {name!r} not found in module source")
        return kernel
