"""``mx.libinfo`` (the counterpart of ``mxnet_tpu/libinfo.py``): the
port's version and its native libraries. The port's libraries are built at
first use (``ops/_build.py``: the CUDA kernels; ``native``: the host C++)
into ``build/mxnet_tpu_torch/`` beside the package."""
from __future__ import annotations

import os

from .ops import _build

__all__ = ["__version__", "find_lib_path", "find_include_path"]

__version__ = "2.0.0"


def find_lib_path(prefix="libmxtpu"):
    """Paths of the built libraries whose names start with ``prefix``
    (default: the native runtime's; ``"lib"`` lists the kernels' too)."""
    d = str(_build.BUILD_DIR)
    if not os.path.isdir(d):
        return []
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.startswith(prefix) and f.endswith(".so")]


def find_include_path():
    """The directory of the kernels' C sources and headers (``csrc/``)."""
    return str(_build.CSRC)
