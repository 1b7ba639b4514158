"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays the reference; this package imports
neither it nor JAX. Plain tensor code is PyTorch; each Pallas kernel that a
ported path runs is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use. The imperative API (``nd``, ``autograd``, ``random``)
and ``rtc.CudaModule``, which compiles a user's CUDA source at run time
with NVRTC, sit beside them. Entry points (``serving.ModelEndpoint``,
``parallel.make_mesh`` for ``ParallelTrainStep``) run on the card
(``gpu(0)``) unless the caller passes ``cpu()``. The data path
(``gluon.data``, ``io``, ``recordio``, ``image``) runs on the host and
makes ``cpu()`` batches, which the training loop moves to the card; its
host C++ (``native``) is built with g++ at first use. ``metric``,
``callback``, ``visualization`` and ``gluon.contrib.estimator`` are the
training utilities, ``operator`` (``nd.Custom``) and ``library`` the custom
ops and external op libraries. ``contrib.quantization.quantize_net``
converts a Gluon net to int8 inference; ``kvstore`` (``kv``) holds the
KVStores, one-process and distributed, with gradient compression, and
``parallel`` the meshes, collectives, ``ParallelTrainStep`` and ring
attention of jobs that ``tools/launch.py`` starts, one process a rank;
``embedding`` the vocab-sharded tables and the DLRM step over them.
``runtime``, ``error``, ``libinfo``, ``log``, ``registry``, ``resource``,
``context``, ``tensor_inspector`` and ``util`` are the reference's thin
top-level modules. ``symbol`` (``sym``), ``module`` (``mod``), ``model``,
``subgraph``, ``monitor``, ``name`` and ``attribute`` are the symbolic API:
graphs over the same ops, bound and trained through ``Module``.
"""
__version__ = "2.0.0"

import torch as _torch

# MXNet float32 means float32 (the JAX package pins
# jax_default_matmul_precision=highest for the same reason): no TF32 in
# float32 matrix products or cuDNN convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# fp16 products sum in f32, as the JAX package's do: cuBLAS may not reduce
# them in fp16. (The bf16 flag stays at PyTorch's default.)
_torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

from .base import Context, MXNetError, cpu, current_context, gpu
from . import (amp, autograd, base, config, engine, gluon, image, init,
               initializer, io, ndarray, ops, optimizer, parallel, random,
               recordio, rtc, serving)
from . import ndarray as nd
from .optimizer import lr_scheduler
from . import callback, library, metric, operator, visualization
from . import contrib, kvstore
from . import kvstore as kv
from . import embedding
from . import (context, error, libinfo, log, registry, resource, runtime,
               tensor_inspector, util)
from .tensor_inspector import TensorInspector
from . import attribute, name, symbol, subgraph, model, module, monitor
from . import symbol as sym
from . import module as mod
from .symbol import executor
from .monitor import Monitor
from .attribute import AttrScope

library.initialize()   # fork handlers and the crash logger

from . import profiler, telemetry
if config.get("MXNET_PROFILER_AUTOSTART"):
    profiler.set_config(profile_all=True)
    profiler.start()
# MXNET_TELEMETRY_DUMP_PATH: start the background metrics reporter
telemetry.reporter._autostart()
# MXNET_FLIGHT_DIR: arm the flight recorder's unhandled-exception hooks
telemetry.flight._autostart()
# MXNET_DEBUG_PORT: start the localhost HTTP introspection server
telemetry.debug_server._autostart()

__all__ = ["Context", "MXNetError", "cpu", "gpu", "current_context",
           "amp", "autograd", "base", "callback", "config", "context",
           "contrib", "embedding", "engine", "error", "gluon", "image",
           "init", "initializer", "io", "kv", "kvstore", "libinfo",
           "library", "log", "lr_scheduler", "metric", "nd", "ndarray",
           "operator", "ops", "optimizer", "parallel", "profiler", "random",
           "recordio", "registry", "resource", "rtc", "runtime", "serving",
           "telemetry", "tensor_inspector", "TensorInspector", "util",
           "visualization", "AttrScope", "Monitor", "attribute",
           "executor", "mod", "model", "module", "monitor", "name", "subgraph",
           "sym", "symbol"]
