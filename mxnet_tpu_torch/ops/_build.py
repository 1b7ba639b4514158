"""Build and load the port's hand-written CUDA kernels.

Each kernel library is compiled from ``mxnet_tpu_torch/csrc`` with ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The library lands in
``build/mxnet_tpu_torch/`` at the repository root, named by a hash of its
sources, the headers they include by quoted name (``#include "hopper.cuh"``,
found beside the including file or in ``csrc/``, which is on nvcc's include
path) and the flags: a changed source or header builds anew, an unchanged
one is reused. A file lock per library serializes its build across
processes (the ranks of a job that start with nothing built), so the
first builds it and the others find it.

With the executable cache on (``MXNET_EXEC_CACHE_DIR``), :func:`load`
first looks the library up there under a key that also covers the
toolkit's nvcc release (read from its ``version.json``, so a hit runs no
nvcc), the runtime versions and the card (``cache/executable_cache.py``):
a hit loads the verified bytes, a miss builds as above (or finds
``build/``'s file). The library is stored under the release of the nvcc
that built it, which :func:`_compile` notes beside it
(``lib<name>-<hash>.nvcc``); a file in ``build/`` without that note is
loaded but not stored. A build that fails raises; the cache's only
fallback is to build the library again.
Nothing is built when a module is imported; the first call that launches a
kernel builds it. Different libraries build in parallel when first used from
different threads (one nvcc each). A library may also be given as several
translation units, each a ``(source, defines)`` pair (one source compiled
with different ``-D`` macros, as K1's head dims are): then one ``nvcc -c``
a unit runs, all started together, and one more links the objects, so the
library takes about as long as its slowest unit.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..base import MXNetError
from ..cache import executable_cache as _xcache

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "build_log",
           "source_hash", "nvcc_version", "note_release", "built_by",
           "cache_key"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"

# sm_90a (not sm_90): wgmma and setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# a unit's object, and the link of a library's objects
_OBJECT_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)
_LINK_FLAGS = NVCC_FLAGS[:2] + ("-shared",)

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_LOCK = threading.Lock()              # guards _NAME_LOCKS
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, dict] = {}
_TOOLKIT: List[Optional[str]] = []    # nvcc_version(), resolved once


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _find_nvcc() -> Optional[str]:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(_cuda_home() / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _nvcc() -> str:
    nvcc = _find_nvcc()
    if nvcc is not None:
        return nvcc
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


def _units(sources) -> List[tuple]:
    """``(path, defines)`` of each entry of ``sources``: a file name under
    csrc/ or an absolute path (no defines), or a ``(source, defines)``
    pair whose defines are ``NAME=VALUE`` strings."""
    out = []
    for s in sources:
        src, defines = s if isinstance(s, tuple) else (s, ())
        out.append(((CSRC / src).resolve(), tuple(defines)))
    return out


def source_hash(sources: Sequence) -> str:
    """sha256 (hex) over the nvcc flags and the name and bytes of every
    source in ``sources`` (file names under csrc/, absolute paths, or
    ``(source, defines)`` units) and of every header they include, and
    each unit's defines: the key of a built library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    units = _units(sources)
    for p in _with_includes([p for p, _ in units]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for p, defines in units:
        if defines:
            h.update(" ".join([p.name, *defines]).encode())
    return h.hexdigest()


def build(name: str, sources: Sequence) -> Path:
    """Compile ``sources`` (file names under csrc/, absolute paths, or
    ``(source, defines)`` units) into
    ``build/mxnet_tpu_torch/lib<name>-<hash>.so`` unless that file exists;
    returns its path. ``-Xptxas -v`` reports (registers, shared memory,
    spills per kernel) are kept for :func:`build_log`."""
    out = BUILD_DIR / f"lib{name}-{source_hash(sources)[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)    # released when it closes
            if not out.exists():                # no other process built it
                return _compile(name, sources, out)
    _LOGS.setdefault(name, {"path": str(out), "seconds": 0.0,
                            "cached": True, "source": "build_dir",
                            "ptxas": ""})
    return out


def _nvcc_run(name: str, cmd: List[str]):
    """Run one nvcc command; its output and seconds, or MXNetError."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise MXNetError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    _xcache.note_compile("nvcc")
    return proc.stdout + proc.stderr, seconds


def _compile(name: str, sources: Sequence, out: Path) -> Path:
    units = _units(sources)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    nvcc = _nvcc()
    if not any(defines for _, defines in units):    # one nvcc, as ever
        ptxas, seconds = _nvcc_run(name, [
            nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-Xptxas", "-v",
            "-o", str(tmp), *[str(p) for p, _ in units]])
        objects = []
    else:
        ptxas, seconds, objects = _compile_units(name, nvcc, units, tmp)
    note_release(out, _nvcc_release(nvcc))      # before the library appears
    os.replace(tmp, out)
    _LOGS[name] = {"path": str(out), "seconds": seconds, "cached": False,
                   "source": "nvcc", "ptxas": ptxas, "objects": objects}
    return out


def _compile_units(name: str, nvcc: str, units, tmp: Path):
    """One ``nvcc -c`` a unit, all started together, then the link into
    ``tmp``: (the ptxas reports, the wall seconds, one ``{"unit",
    "seconds"}`` a unit)."""
    objs = [tmp.with_name(f"{tmp.stem}.{i}.o") for i in range(len(units))]
    cmds = [[nvcc, *_OBJECT_FLAGS, "-I", str(CSRC), "-Xptxas", "-v",
             *[f"-D{d}" for d in defines], "-o", str(obj), str(path)]
            for (path, defines), obj in zip(units, objs)]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            runs = [pool.submit(_nvcc_run, name, cmd) for cmd in cmds]
            done = [r.result() for r in runs]
        _nvcc_run(name, [nvcc, *_LINK_FLAGS, "-o", str(tmp),
                         *[str(o) for o in objs]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    labels = [" ".join([path.name, *[f"-D{d}" for d in defines]])
              for path, defines in units]
    ptxas = "".join(f"unit {label}:\n{text}"
                    for label, (text, _) in zip(labels, done))
    return (ptxas, time.perf_counter() - t0,
            [{"unit": label, "seconds": sec}
             for label, (_, sec) in zip(labels, done)])


def _nvcc_release(nvcc: str) -> str:
    """The release ``nvcc --version`` of the binary ``nvcc`` prints
    (``12.9.86``)."""
    proc = subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, timeout=60)
    m = re.search(r"\bV(\d+(?:\.\d+)+)", proc.stdout)
    if proc.returncode != 0 or m is None:
        raise MXNetError(f"{nvcc} --version gave no release (exit "
                         f"{proc.returncode}): {proc.stdout}{proc.stderr}")
    return m.group(1)


def nvcc_version() -> Optional[str]:
    """The toolkit's nvcc release (``12.9.86``), resolved once a process:
    ``cuda_nvcc`` in the ``version.json`` of ``CUDA_HOME`` (else
    ``/usr/local/cuda``), read without running nvcc; else ``nvcc
    --version``; None with neither. A toolkit other than the nvcc that
    builds only makes the cache miss: what is stored is keyed by the
    release of the nvcc that built it (:func:`built_by`)."""
    if not _TOOLKIT:
        meta = _cuda_home() / "version.json"
        m = re.search(r'"cuda_nvcc"\s*:\s*\{[^}]*"version"\s*:\s*"([^"]+)"',
                      meta.read_text()) if meta.is_file() else None
        nvcc = None if m else _find_nvcc()
        _TOOLKIT.append(m.group(1) if m else
                        _nvcc_release(nvcc) if nvcc else None)
    return _TOOLKIT[0]


def note_release(lib: Path, release: str):
    """Write beside ``build/``'s ``lib`` the nvcc release that built it."""
    _xcache._atomic_write(str(lib.with_suffix(".nvcc")), release.encode())


def built_by(lib: Path) -> Optional[str]:
    """The nvcc release noted beside ``lib`` by :func:`note_release`, or
    None for a library without a note."""
    note = lib.with_suffix(".nvcc")
    return note.read_text().strip() or None if note.is_file() else None


def cache_key(name: str, sources: Sequence,
              release: Optional[str] = None) -> Optional[dict]:
    """The executable-cache key of library ``name``: its sources' and
    flags' digest, the nvcc ``release`` (default :func:`nvcc_version`),
    the runtimes and the card; None where the release is unknown."""
    release = release or nvcc_version()
    if release is None:
        return None
    return _xcache.build_key(source_hash(sources), {"nvcc": release},
                             {"library": name})


def _from_cache(name: str, key: dict):
    """The library stored under ``key`` in the executable cache, loaded
    from its verified bytes (written beside the builds), or None."""
    def dlopen(blob: bytes) -> ctypes.CDLL:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"lib{name}-x{_xcache.key_digest(key)[:16]}.so"
        _xcache._atomic_write(str(path), blob)
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        _LOGS[name] = {"path": str(path), "cached": True,
                       "source": "exec_cache", "ptxas": "",
                       "seconds": time.perf_counter() - t0}
        return lib
    return _xcache.load(key, loader=dlopen)


def load(name: str, sources: Sequence) -> ctypes.CDLL:
    """The loaded library for ``name``, building it on first use."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            cached = _xcache.enabled()
            key = cache_key(name, sources) if cached else None
            if key is not None:
                lib = _from_cache(name, key)
            if lib is None:
                path = build(name, sources)
                lib = ctypes.CDLL(str(path))
                release = built_by(path) if cached else None
                if release is not None:
                    _xcache.store(cache_key(name, sources, release),
                                  path.read_bytes())
            _LIBS[name] = lib
        return lib


def build_log(name: str) -> dict:
    """Path, build seconds, ptxas report, ``source`` (``nvcc``,
    ``build_dir`` or ``exec_cache``) and, for a library built from units,
    each unit's seconds (``objects``) of the library ``name`` built (or
    found) in this process."""
    return dict(_LOGS.get(name, {}))
