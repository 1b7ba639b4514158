"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
neither it nor JAX. Plain tensor code is PyTorch; each Pallas kernel that a
ported path runs is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use. The imperative API (``nd``, ``autograd``, ``random``)
and ``rtc.CudaModule``, which compiles a user's CUDA source at run time
with NVRTC, sit beside them. Entry points (``serving.ModelEndpoint``,
``parallel.make_mesh`` for ``ParallelTrainStep``) run on the card
(``gpu(0)``) unless the caller passes ``cpu()``.
"""
__version__ = "2.0.0"

import torch as _torch

# MXNet float32 means float32 (the JAX package pins
# jax_default_matmul_precision=highest for the same reason): no TF32 in
# float32 matrix products or cuDNN convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .base import Context, MXNetError, cpu, current_context, gpu
from . import (autograd, base, gluon, ndarray, ops, optimizer, parallel,
               random, rtc, serving)
from . import ndarray as nd

__all__ = ["Context", "MXNetError", "cpu", "gpu", "current_context",
           "autograd", "base", "gluon", "nd", "ndarray", "ops", "optimizer",
           "parallel", "random", "rtc", "serving"]
