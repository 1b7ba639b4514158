"""Runtime feature detection (the counterpart of
``mxnet_tpu/runtime.py``, itself MXNet's ``python/mxnet/runtime.py`` over
the ``libinfo.h`` feature enum). The features are the port's: CUDA, cuDNN
and NCCL as this PyTorch build and host have them, no TPU, XLA or Pallas;
``Features().card`` names the card (None without one)."""
from __future__ import annotations

import functools
import importlib.util
from collections import namedtuple

import torch

__all__ = ["Feature", "Features", "feature_list", "libinfo_features"]

Feature = namedtuple("Feature", ["name", "enabled"])


@functools.lru_cache(maxsize=None)
def _detect():
    from . import native
    from .parallel import collectives
    cuda = torch.cuda.is_available()
    feats = {
        "TPU": False,
        "CUDA": cuda,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and collectives.nccl_available(),
        "XLA": False,
        "PALLAS": False,
        "MKLDNN": torch.backends.mkldnn.is_available(),
        "OPENCV": importlib.util.find_spec("cv2") is not None,
        "BLAS_OPEN": True,
        "DIST_KVSTORE": True,        # torch.distributed jobs (parallel/)
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
        "F16C": True,
        "BF16": True,
        "PROFILER": True,
        "NATIVE_ENGINE": native.available(),
    }
    return {k: Feature(k, v) for k, v in feats.items()}


class Features(dict):
    """The features by name; ``card`` is the name of CUDA device 0, None
    when there is none."""

    def __init__(self):
        super().__init__(_detect())
        self.card = torch.cuda.get_device_name(0) \
            if torch.cuda.is_available() else None

    def is_enabled(self, name):
        return self[name.upper()].enabled

    def __repr__(self):
        return "[" + ", ".join(f"✔ {k}" if v.enabled else f"✖ {k}"
                               for k, v in self.items()) + "]"


def feature_list():
    return list(_detect().values())


libinfo_features = feature_list
