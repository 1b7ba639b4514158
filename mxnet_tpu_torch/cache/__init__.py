"""mxnet_tpu_torch.cache — persistent, content-addressed compiled-artifact
caches (the port of ``mxnet_tpu/cache``).

Its member :mod:`executable_cache` stores what the port compiles and a new
process would otherwise compile again: the nvcc libraries of the
hand-written kernels (``ops/_build.py``) and the NVRTC cubins of
``rtc.CudaModule``, keyed by sources, flags, toolchain, runtime versions and
device, on disk under ``MXNET_EXEC_CACHE_DIR``, so a restarted or
scaled-out replica loads them instead of building them.
"""
from __future__ import annotations

from . import executable_cache

__all__ = ["executable_cache"]
