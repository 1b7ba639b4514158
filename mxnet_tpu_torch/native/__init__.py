"""Native host components of the port: the dependency engine, RecordIO and
the image pipeline (the counterpart of ``mxnet_tpu/native``).

The C++ sources are the JAX package's, copied here: ``engine.cc`` (per-var
FIFO read/write dependencies on worker pools, exceptions at the sync
points), ``recordio.cc`` (dmlc RecordIO framing) and ``image_pipeline.cc``
(ImageRecordIter's decode, augment, batch and prefetch threads over
OpenCV). They are compiled with ``g++`` (the JAX package's Makefile flags)
into ``build/mxnet_tpu_torch/libmxtpu_native-<hash>.so`` at the
repository root, named by a hash of the sources and the flags, at first
use, never at import; an unchanged build is reused. The image pipeline is
compiled in only where ``pkg-config`` finds OpenCV 4's headers
(:func:`has_image_pipeline` says whether it was); engine and RecordIO
always are. The JAX package's own library is never loaded.

:func:`available` keeps the reference's API: False when the build failed
(:func:`build_error` has the compiler's output). Callers that need the
library (``NativeEngine``) raise then; ``engine.Engine`` and ``io``'s
``ImageRecordIter`` choose their Python path only where the library or
its image pipeline is absent, and say which through
``engine.get_engine()``'s type and the type ``io.ImageRecordIter``
returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

__all__ = ["available", "build", "build_error", "get_lib", "has_image_pipeline",
           "lib_path", "NativeEngine", "SOURCES", "CXXFLAGS"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "mxnet_tpu_torch"
SOURCES = ("engine.cc", "recordio.cc")
IMAGE_SOURCE = "image_pipeline.cc"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread")
_OPENCV_LIBS = ("opencv_core", "opencv_imgproc", "opencv_imgcodecs")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_build_error: Optional[str] = None


def _pkg_config(*args) -> Optional[List[str]]:
    exe = shutil.which("pkg-config")
    if exe is None:
        return None
    proc = subprocess.run([exe, *args, "opencv4"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout.split() if proc.returncode == 0 else None


def _opencv():
    """(cflags, libs) of OpenCV 4 from pkg-config, or None."""
    cflags = _pkg_config("--cflags")
    if not cflags:
        return None
    libs = [f for f in (_pkg_config("--libs-only-l") or [])
            if f[2:] in _OPENCV_LIBS]
    return cflags, libs


def _command(out: Path, opencv) -> List[str]:
    srcs = [str(_DIR / s) for s in SOURCES]
    flags = list(CXXFLAGS)
    libs: List[str] = []
    if opencv is not None:
        srcs.append(str(_DIR / IMAGE_SOURCE))
        flags += [*opencv[0], "-DMXTPU_WITH_OPENCV"]
        libs = list(opencv[1])
    return [os.environ.get("CXX", "g++"), *flags, "-shared", "-o", str(out),
            *srcs, *libs]


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile the library into ``build_dir`` (default
    ``build/mxnet_tpu_torch``) unless a build of the same sources and
    flags is there; returns its path. Raises RuntimeError with the
    compiler's output when g++ fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    opencv = _opencv()
    probe = _command(Path("lib.so"), opencv)
    h = hashlib.sha256(" ".join(probe[1:]).encode())
    for s in (*SOURCES, IMAGE_SOURCE):
        h.update(s.encode())
        h.update((_DIR / s).read_bytes())
    out = build_dir / f"libmxtpu_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = _command(tmp, opencv)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if the build
    failed (see :func:`build_error`)."""
    global _lib, _lib_path, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = build()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_error = str(e)
            return None
        lib = ctypes.CDLL(str(path))
        _configure(lib)
        _lib, _lib_path = lib, path
        return _lib


def available() -> bool:
    return get_lib() is not None


def has_image_pipeline() -> bool:
    """Whether the library holds the OpenCV image pipeline."""
    lib = get_lib()
    return lib is not None and hasattr(lib, "mxtpu_impipe_create")


def lib_path() -> Optional[Path]:
    """The file the library was loaded from (None before it is)."""
    return _lib_path


def build_error() -> Optional[str]:
    return _build_error


def _configure(lib):
    c = ctypes
    lib.mxtpu_engine_create.restype = c.c_void_p
    lib.mxtpu_engine_create.argtypes = [c.c_int]
    lib.mxtpu_engine_destroy.argtypes = [c.c_void_p]
    lib.mxtpu_engine_new_var.restype = c.c_int64
    lib.mxtpu_engine_new_var.argtypes = [c.c_void_p]
    lib.mxtpu_engine_push.argtypes = [
        c.c_void_p, c.CFUNCTYPE(None, c.c_void_p), c.c_void_p,
        c.POINTER(c.c_int64), c.c_int, c.POINTER(c.c_int64), c.c_int]
    lib.mxtpu_engine_push_ex.argtypes = [
        c.c_void_p, c.CFUNCTYPE(None, c.c_void_p), c.c_void_p,
        c.POINTER(c.c_int64), c.c_int, c.POINTER(c.c_int64), c.c_int,
        c.c_int, c.c_int, c.c_int]
    lib.mxtpu_engine_wait_for_var.argtypes = [c.c_void_p, c.c_int64]
    lib.mxtpu_engine_wait_all.argtypes = [c.c_void_p]
    lib.mxtpu_engine_stats.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.mxtpu_engine_last_error.restype = c.c_char_p
    lib.mxtpu_engine_last_error.argtypes = [c.c_void_p]
    lib.mxtpu_engine_set_error.argtypes = [c.c_void_p, c.c_char_p]
    lib.mxtpu_engine_clear_error.argtypes = [c.c_void_p]

    lib.mxtpu_recio_writer_open.restype = c.c_void_p
    lib.mxtpu_recio_writer_open.argtypes = [c.c_char_p]
    lib.mxtpu_recio_write.restype = c.c_int64
    lib.mxtpu_recio_write.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.mxtpu_recio_writer_close.argtypes = [c.c_void_p]
    lib.mxtpu_recio_reader_open.restype = c.c_void_p
    lib.mxtpu_recio_reader_open.argtypes = [c.c_char_p]
    lib.mxtpu_recio_read.restype = c.c_int64
    lib.mxtpu_recio_read.argtypes = [c.c_void_p, c.POINTER(c.c_char_p)]
    lib.mxtpu_recio_seek.argtypes = [c.c_void_p, c.c_int64]
    lib.mxtpu_recio_tell.restype = c.c_int64
    lib.mxtpu_recio_tell.argtypes = [c.c_void_p]
    lib.mxtpu_recio_reader_close.argtypes = [c.c_void_p]

    if hasattr(lib, "mxtpu_impipe_create"):
        lib.mxtpu_impipe_create.restype = c.c_void_p
        lib.mxtpu_impipe_create.argtypes = [
            c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_int, c.c_int, c.POINTER(c.c_float), c.POINTER(c.c_float),
            c.c_int, c.c_int, c.c_int]
        lib.mxtpu_impipe_next.restype = c.c_int
        lib.mxtpu_impipe_next.argtypes = [c.c_void_p,
                                          c.POINTER(c.c_float),
                                          c.POINTER(c.c_float)]
        lib.mxtpu_impipe_reset.argtypes = [c.c_void_p]
        lib.mxtpu_impipe_destroy.argtypes = [c.c_void_p]


class NativeEngine:
    """Host-side dependency engine (``Engine::PushAsync``/``WaitForVar``/
    ``WaitForAll``): Python callables run on the C++ worker threads; a
    callable's exception is raised as RuntimeError at the next sync
    point."""

    LANE_NORMAL, LANE_COPY, LANE_PRIORITY = 0, 1, 2  # FnProperty

    def __init__(self, num_workers=4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.mxtpu_engine_create(num_workers)
        self._cbs = {}          # callbacks kept alive until they have run
        self._cb_lock = threading.Lock()
        self._next_id = 0
        self._cb_type = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

    def new_var(self):
        return self._lib.mxtpu_engine_new_var(self._h)

    def push(self, fn, read_vars=(), write_vars=(), device=0, lane=0,
             priority=0):
        """Push ``fn`` after the writes before it to ``read_vars`` and
        every access before it to ``write_vars``. ``device``/``lane``
        pick a worker pool of its own; ``priority`` orders dispatch within
        a pool."""
        with self._cb_lock:
            cb_id = self._next_id
            self._next_id += 1

        def trampoline(_arg, _id=cb_id):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — raised at the sync point
                self._lib.mxtpu_engine_set_error(self._h, str(e).encode())
            finally:
                with self._cb_lock:
                    self._cbs.pop(_id, None)

        cfunc = self._cb_type(trampoline)
        with self._cb_lock:
            self._cbs[cb_id] = cfunc
        reads = (ctypes.c_int64 * len(read_vars))(*read_vars)
        writes = (ctypes.c_int64 * len(write_vars))(*write_vars)
        if device == 0 and lane == 0 and priority == 0:
            self._lib.mxtpu_engine_push(self._h, cfunc, None, reads,
                                        len(read_vars), writes,
                                        len(write_vars))
        else:
            self._lib.mxtpu_engine_push_ex(self._h, cfunc, None, reads,
                                           len(read_vars), writes,
                                           len(write_vars), device, lane,
                                           priority)

    def _check_error(self):
        err = self._lib.mxtpu_engine_last_error(self._h)
        if err:
            self._lib.mxtpu_engine_clear_error(self._h)
            raise RuntimeError(err.decode())

    def wait_for_var(self, var):
        self._lib.mxtpu_engine_wait_for_var(self._h, var)
        self._check_error()

    def wait_all(self):
        self._lib.mxtpu_engine_wait_all(self._h)
        self._check_error()

    def stats(self):
        """pushed/completed totals, the pending gauge and the worker-pool
        count."""
        buf = (ctypes.c_int64 * 4)()
        self._lib.mxtpu_engine_stats(self._h, buf)
        return {"pushed": buf[0], "completed": buf[1], "pending": buf[2],
                "pools": buf[3]}

    def close(self):
        if self._h:
            self._lib.mxtpu_engine_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
