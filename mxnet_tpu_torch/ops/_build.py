"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled from ``mxnet_tpu_torch/csrc`` with ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The library lands in
``build/mxnet_tpu_torch/`` at the repository root, named by a hash of its
sources, the headers they include by quoted name (``#include "hopper.cuh"``,
found beside the including file or in ``csrc/``, which is on nvcc's include
path) and the flags: a changed source or header builds anew, an unchanged
one is reused.
Nothing is built when a module is imported; the first call that launches a
kernel builds it. Different libraries build in parallel when first used from
different threads (one nvcc each).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

from ..base import MXNetError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "build_log",
           "source_hash"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"

# sm_90a (not sm_90): wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_LOCK = threading.Lock()              # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, dict] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the port's CUDA kernels are built from source at first "
                     "use")


def _with_includes(paths: Sequence[Path]) -> List[Path]:
    """``paths`` and every file they include by quoted name, recursively,
    each once: a header is looked up beside the file that includes it, then
    in ``csrc/`` (nvcc's order for ``-I csrc``)."""
    out: List[Path] = []
    todo = list(paths)
    while todo:
        p = todo.pop(0)
        if p in out:
            continue
        out.append(p)
        for inc in _INCLUDE.findall(p.read_text()):
            cands = [p.parent / inc, CSRC / inc]
            found = next((c for c in cands if c.is_file()), None)
            if found is None:
                raise MXNetError(f"{p}: included file {inc!r} not found "
                                 f"beside it or in {CSRC}")
            todo.append(found.resolve())
    return out


def source_hash(sources: Sequence[str]) -> str:
    """sha256 (hex) over the nvcc flags and the name and bytes of every
    source in ``sources`` (file names under csrc/, or absolute paths) and of
    every header they include: the key of a built library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _with_includes([(CSRC / s).resolve() for s in sources]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (file names under csrc/, or absolute paths) into
    ``build/mxnet_tpu_torch/lib<name>-<hash>.so`` unless that file exists;
    returns its path. ``-Xptxas -v`` reports (registers, shared memory,
    spills per kernel) are kept for :func:`build_log`."""
    paths = [CSRC / s for s in sources]
    out = BUILD_DIR / f"lib{name}-{source_hash(sources)[:16]}.so"
    if out.exists():
        _LOGS.setdefault(name, {"path": str(out), "seconds": 0.0,
                                "cached": True, "ptxas": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v",
           "-o", str(tmp),
           *[str(p) for p in paths]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    _LOGS[name] = {"path": str(out), "seconds": seconds, "cached": False,
                   "ptxas": proc.stdout + proc.stderr}
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded library for ``name``, building it on first use."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, sources)))
            _LIBS[name] = lib
        return lib


def build_log(name: str) -> dict:
    """Path, build seconds and ptxas report of the library ``name`` built
    (or found) in this process."""
    return dict(_LOGS.get(name, {}))
