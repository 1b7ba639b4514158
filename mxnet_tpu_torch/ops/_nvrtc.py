"""ctypes bindings to NVRTC and the CUDA driver API, for ``rtc.CudaModule``.

The role Mosaic and ``pl`` play for the JAX package's ``PallasModule``:
source text becomes a cubin for sm_90a (``nvrtcCompileProgram``), the
driver loads it into the device's primary context, the one PyTorch uses
(``cuModuleLoadData``), and a kernel launches on a stream
(``cuLaunchKernel``). A cubin and not PTX, so the driver never has to
JIT-compile a PTX newer than itself.

The libraries are loaded at the first call, never at import: NVRTC from the
CUDA toolkit (``$CUDA_HOME/lib64/libnvrtc.so.12``, the toolkit found the
way ``_build`` finds nvcc) and the driver from ``libcuda.so.1``. A host
without either raises MXNetError naming what is missing. Every call's
return code is checked; a failure raises MXNetError with the library's own
text.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["ARCH_OPTIONS", "cuda_home", "compile_cubin", "load_module",
           "get_function", "set_max_dynamic_shared", "launch"]

# cubin for the H100 with the Hopper-only instructions (wgmma, setmaxnreg)
ARCH_OPTIONS = ("--gpu-architecture=sm_90a", "-std=c++17")
CUDA_ERROR_NOT_FOUND = 500
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_contexts: Dict[int, ctypes.c_void_p] = {}

_vp = ctypes.c_void_p
_pvp = ctypes.POINTER(ctypes.c_void_p)
_cp = ctypes.c_char_p
_pcp = ctypes.POINTER(ctypes.c_char_p)
_psize = ctypes.POINTER(ctypes.c_size_t)
_NVRTC_SIGS = {
    "nvrtcVersion": [ctypes.POINTER(ctypes.c_int)] * 2,
    "nvrtcGetErrorString": [ctypes.c_int],
    "nvrtcCreateProgram": [_pvp, _cp, _cp, ctypes.c_int, _pcp, _pcp],
    "nvrtcDestroyProgram": [_pvp],
    "nvrtcAddNameExpression": [_vp, _cp],
    "nvrtcCompileProgram": [_vp, ctypes.c_int, _pcp],
    "nvrtcGetProgramLogSize": [_vp, _psize],
    "nvrtcGetProgramLog": [_vp, ctypes.c_char_p],
    "nvrtcGetLoweredName": [_vp, _cp, _pcp],
    "nvrtcGetCUBINSize": [_vp, _psize],
    "nvrtcGetCUBIN": [_vp, ctypes.c_char_p],
}
_CUDA_SIGS = {
    "cuInit": [ctypes.c_uint],
    "cuGetErrorString": [ctypes.c_int, _pcp],
    "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
    "cuDevicePrimaryCtxRetain": [_pvp, ctypes.c_int],
    "cuCtxSetCurrent": [_vp],
    "cuModuleLoadData": [_pvp, _vp],
    "cuModuleGetFunction": [_pvp, _vp, _cp],
    "cuFuncSetAttribute": [_vp, ctypes.c_int, ctypes.c_int],
    "cuLaunchKernel": [_vp] + [ctypes.c_uint] * 7 + [_vp, _pvp, _pvp],
}


def cuda_home() -> Optional[Path]:
    """The CUDA toolkit: ``$CUDA_HOME``, else the one whose nvcc is on
    PATH, else ``/usr/local/cuda``; None if none holds NVRTC."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]))
    nvcc = shutil.which("nvcc")
    if nvcc:
        cands.append(Path(nvcc).resolve().parents[1])
    cands.append(Path("/usr/local/cuda"))
    for c in cands:
        if (c / "lib64" / "libnvrtc.so.12").is_file():
            return c
    return None


def _bind(name: str, path: str, sigs) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn == "nvrtcGetErrorString" \
            else ctypes.c_int
    _libs[name] = lib
    return lib


def _nvrtc() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("nvrtc")
        if lib is None:
            home = cuda_home()
            if home is None:
                raise MXNetError(
                    "rtc: NVRTC not found (no lib64/libnvrtc.so.12 under "
                    "$CUDA_HOME, the toolkit of the nvcc on PATH, or "
                    "/usr/local/cuda); CudaModule compiles CUDA source at "
                    "run time and needs the CUDA toolkit")
            lib = _bind("nvrtc", str(home / "lib64" / "libnvrtc.so.12"),
                        _NVRTC_SIGS)
        return lib


def _driver() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("cuda")
        if lib is None:
            if ctypes.util.find_library("cuda") is None:
                raise MXNetError("rtc: the CUDA driver (libcuda.so.1) is "
                                 "not installed")
            lib = _bind("cuda", "libcuda.so.1", _CUDA_SIGS)
            _check(lib.cuInit(0), "cuInit")
        return lib


def _check(rc: int, what: str):
    if rc != 0:
        msg = ctypes.c_char_p()
        _libs["cuda"].cuGetErrorString(rc, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise MXNetError(f"rtc: {what} failed: {text} (CUresult {rc})")


def _check_nvrtc(lib, rc: int, what: str):
    if rc != 0:
        raise MXNetError(f"rtc: {what} failed: "
                         f"{lib.nvrtcGetErrorString(rc).decode()}")


def nvrtc_version() -> Tuple[int, int]:
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _strings(items: Sequence[str]):
    return (ctypes.c_char_p * max(1, len(items)))(
        *[s.encode() for s in items])


def compile_cubin(source: str, name: str, options: Sequence[str] = (),
                  name_expressions: Sequence[str] = ()):
    """``(cubin bytes, {name expression: lowered name}, seconds)`` for
    ``source`` compiled for sm_90a with ``options``. A source that does
    not compile raises MXNetError with "failed to compile" and the log."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), name.encode(), 0, None, None),
        "nvrtcCreateProgram")
    try:
        for expr in name_expressions:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, expr.encode()),
                         f"nvrtcAddNameExpression({expr!r})")
        opts = [*ARCH_OPTIONS, f"-I{cuda_home() / 'include'}", *options]
        t0 = time.perf_counter()
        rc = lib.nvrtcCompileProgram(prog, len(opts), _strings(opts))
        seconds = time.perf_counter() - t0
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetProgramLog(prog, buf),
                     "nvrtcGetProgramLog")
        if rc != 0:
            raise MXNetError(f"CudaModule: kernel source failed to compile "
                             f"({lib.nvrtcGetErrorString(rc).decode()}):\n"
                             f"{buf.value.decode(errors='replace')}")
        lowered = {}
        for expr in name_expressions:
            out = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, expr.encode(), ctypes.byref(out)),
                f"nvrtcGetLoweredName({expr!r})")
            lowered[expr] = out.value.decode()
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered, seconds
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(device: int):
    """Make the device's primary context (PyTorch's) current on this
    thread; the driver API acts on the thread's current context."""
    lib = _driver()
    with _lock:
        ctx = _contexts.get(device)
        if ctx is None:
            dev = ctypes.c_int()
            _check(lib.cuDeviceGet(ctypes.byref(dev), device), "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev.value),
                   "cuDevicePrimaryCtxRetain")
            _contexts[device] = ctx
    _check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return lib


def load_module(cubin: bytes, device: int) -> ctypes.c_void_p:
    """Load ``cubin`` into card ``device``'s primary context."""
    lib = _make_current(device)
    mod = ctypes.c_void_p()
    _check(lib.cuModuleLoadData(ctypes.byref(mod), cubin), "cuModuleLoadData")
    return mod


def get_function(module: ctypes.c_void_p, name: str, device: int):
    """The kernel ``name`` of a loaded module, or None if it has none."""
    lib = _make_current(device)
    fn = ctypes.c_void_p()
    rc = lib.cuModuleGetFunction(ctypes.byref(fn), module, name.encode())
    if rc == CUDA_ERROR_NOT_FOUND:
        return None
    _check(rc, f"cuModuleGetFunction({name!r})")
    return fn


def set_max_dynamic_shared(fn: ctypes.c_void_p, nbytes: int, device: int):
    """Allow ``fn`` ``nbytes`` of dynamic shared memory (needed above 48 KB)."""
    lib = _make_current(device)
    _check(lib.cuFuncSetAttribute(
        fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
        "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")


def launch(fn: ctypes.c_void_p, device: int, grid: Sequence[int],
           block: Sequence[int], shared_mem: int, stream: int,
           values: Sequence):
    """``cuLaunchKernel`` on ``stream`` (not synchronised). ``values`` are
    ctypes objects, one per kernel parameter; the driver copies them at the
    call. A refused launch (too many threads, too much shared memory)
    raises here: it never runs, and no later synchronise reports it."""
    lib = _make_current(device)
    params = (ctypes.c_void_p * max(1, len(values)))(
        *[ctypes.addressof(v) for v in values])
    _check(lib.cuLaunchKernel(fn, *grid, *block, shared_mem, stream, params,
                              None), "cuLaunchKernel")
