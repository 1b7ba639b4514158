"""The engine surface of the port (the counterpart of ``mxnet_tpu/engine.py``):
``Engine``, ``get_engine``, ``wait_all``, ``bulk`` and ``set_bulk_size``.

Device work runs on CUDA streams, which order it themselves; ``bulk`` is a
no-op kept for the API. The host-side dependency engine
(``native/engine.cc``: per-var FIFO read/write dependencies, asynchronous
push, exceptions at the sync points) schedules host tasks such as
``io.PrefetchingIter``'s batch fetches. ``MXNET_ENGINE_TYPE=NaiveEngine``
selects the synchronous Python engine; so does a failed native build, which
``native.build_error()`` then explains.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["Engine", "get_engine", "wait_all", "bulk", "set_bulk_size"]

_engine = None
_lock = threading.Lock()


class _PythonEngine:
    """Synchronous engine with the same API: a task runs at its push, and
    its first exception is raised at the next sync point."""

    def __init__(self, num_workers=0):
        self._err = None
        self._n = 0

    def new_var(self):
        self._n += 1
        return self._n

    def push(self, fn, read_vars=(), write_vars=()):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — raised at the sync point
            if self._err is None:
                self._err = e

    def _raise(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(str(err))

    def wait_for_var(self, var):
        self._raise()

    def wait_all(self):
        self._raise()

    def close(self):
        pass


def Engine(num_workers=None):
    """A host-task dependency engine: a ``NativeEngine`` unless
    ``MXNET_ENGINE_TYPE`` is ``NaiveEngine`` or the native build failed.
    ``num_workers`` defaults to ``MXNET_CPU_WORKER_NTHREADS``."""
    from . import config, native
    if num_workers is None:
        num_workers = config.get("MXNET_CPU_WORKER_NTHREADS")
    if config.get("MXNET_ENGINE_TYPE") == "NaiveEngine":
        return _PythonEngine(num_workers)
    if native.available():
        return native.NativeEngine(num_workers)
    return _PythonEngine(num_workers)


def get_engine():
    """The process-wide engine (``Engine::Get``)."""
    global _engine
    with _lock:
        if _engine is None:
            _engine = Engine()
        return _engine


def wait_all():
    """Block until every pushed host task has run; device work syncs
    through ``NDArray.wait_to_read``."""
    get_engine().wait_all()


@contextlib.contextmanager
def bulk(size):
    """Op bulking (``engine.py`` ``bulk``): a no-op, kept for the API."""
    yield


def set_bulk_size(size):
    return 0
