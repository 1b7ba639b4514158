"""Environment flag registry of the port (the counterpart of
``mxnet_tpu/config.py``).

``get("MXNET_...")`` reads a :func:`set` override, else the process
environment coerced to the flag's type, else the flag's default;
``describe()`` lists every flag. Names, defaults and types are the
reference's. Only flags that the port reads are registered, and the ones
the reference uses to tune XLA (its jit cache, op bulking, remat, PRNG
implementation and Pallas block sizes) are registered as not applicable:
``get`` and ``set`` refuse them, since nothing in the port compiles through
XLA and they have no PyTorch meaning.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

from .base import MXNetError

__all__ = ["register", "get", "set", "describe", "list_flags"]

_REGISTRY: Dict[str, dict] = {}
_OVERRIDES: Dict[str, Any] = {}
_LOCK = threading.Lock()


def register(name, default, type_=None, doc="", applicable=True):
    """Register a flag with its default, type and documentation; a flag
    that is not ``applicable`` is listed but cannot be read or set."""
    if type_ is None:
        type_ = type(default) if default is not None else str
    with _LOCK:
        _REGISTRY[name] = {"default": default, "type": type_, "doc": doc,
                           "applicable": applicable}
    return name


def _spec(name):
    spec = _REGISTRY.get(name)
    if spec is None:
        raise MXNetError(f"unknown flag {name!r}")
    if not spec["applicable"]:
        raise MXNetError(f"{name} tunes XLA in the JAX package and has no "
                         "meaning in the port")
    return spec


def _coerce(name, raw, type_):
    if type_ is bool:
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    try:
        return type_(raw)
    except (TypeError, ValueError) as e:
        raise MXNetError(f"{name}={raw!r}: expected {type_.__name__}") from e


def get(name: str):
    """A flag's value: a :func:`set` override, else the process
    environment's coerced to the flag's type, else its default."""
    spec = _spec(name)
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(name)
    if raw is None:
        return spec["default"]
    return _coerce(name, raw, spec["type"])


def set(name: str, value):  # noqa: A001  (the reference's name)
    """Override a flag for this process (over the environment); ``None``
    removes the override."""
    _spec(name)
    with _LOCK:
        if value is None:
            _OVERRIDES.pop(name, None)
        else:
            _OVERRIDES[name] = value


def list_flags():
    return sorted(_REGISTRY)


def describe() -> str:
    """One line per flag: default, current value and what it does."""
    lines = []
    for name in list_flags():
        spec = _REGISTRY[name]
        if spec["applicable"]:
            lines.append(f"{name} (default {spec['default']!r}, current "
                         f"{get(name)!r}): {spec['doc']}")
        else:
            lines.append(f"{name}: not applicable in the port "
                         f"({spec['doc']})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# flags the port reads
# ---------------------------------------------------------------------------
register("MXNET_SAFE_ACCUMULATION", True, bool,
         "Accumulate reductions over bf16/fp16 inputs in fp32.")
register("MXNET_BN_ONEPASS", "auto", str,
         "BatchNorm batch moments: 'auto' takes the one-pass E[x^2] - "
         "E[x]^2 form for bf16/fp16 input only, 1/0 forces one-pass/"
         "two-pass for every dtype.")
register("MXNET_BN_BF16_REDUCE", True, bool,
         "BatchNorm and LayerNorm on bf16 input: one-pass f32 moments and "
         "an f32 scale/shift applied to x, every materialized tensor bf16.")
register("MXNET_OPT_BF16_MOMENTS", False, bool,
         "Adam/AdamW: store the moments in bfloat16 (f32 arithmetic).")
register("MXNET_SUPERVISOR_POLL_S", 0.05, float,
         "Decode scheduler: how often the monitor thread checks that the "
         "decode worker thread is alive (failover on its death).")
register("MXNET_SERVING_DRAIN_TIMEOUT_S", 30.0, float,
         "DecodeScheduler.stop(drain=True): longest wait for the drain; "
         "past it the remaining sequences fail with ServerClosedError.")
register("MXNET_KV_PAGE_SIZE", 16, int,
         "Paged KV cache: token positions per page.")
register("MXNET_KV_POOL_PAGES", 256, int,
         "Paged KV cache: pages per pool (page 0 is the scratch page).")
register("MXNET_KV_DEFRAG_RATIO", 0.0, float,
         "Paged KV cache: free() compacts the pool when the spread (highest "
         "live page id / pages in use) exceeds this; 0 never.")
register("MXNET_DECODE_MAX_BATCH", 8, int,
         "Decode scheduler: most sequences a decode step advances (the top "
         "of the pow2 decode-bucket ladder).")
register("MXNET_DECODE_MAX_TOKENS", 64, int,
         "Decode scheduler: submit()'s default max_new_tokens.")
register("MXNET_DECODE_STREAM_BUFFER", 64, int,
         "TokenStream: tokens buffered per stream before backpressure "
         "pauses the sequence.")
register("MXNET_DECODE_SLO_MS", 100.0, float,
         "Decode scheduler: default inter-token SLO (ms) of a tenant, "
         "priced into EDF admission; 0 means FIFO admission.")

register("MXNET_ENGINE_TYPE", "ThreadedEngine", str,
         "Engine for host tasks: ThreadedEngine (the native C++ pool) or "
         "NaiveEngine (synchronous, in Python).")
register("MXNET_CPU_WORKER_NTHREADS", 4, int,
         "Worker threads of the host-task dependency engine.")
register("MXNET_CPU_PRIORITY_NTHREADS", 4, int,
         "ImageRecordIter's default decode and augment threads.")
register("MXNET_HOME", os.path.join("~", ".mxnet"), str,
         "Root of the vision datasets' files (nothing is downloaded).")

# ---------------------------------------------------------------------------
# flags that tune XLA in the JAX package: listed, not applicable
# ---------------------------------------------------------------------------
for _name, _default, _doc in (
        ("MXNET_JIT_CACHE_SIZE", 4096,
         "capacity of the eager per-op jax.jit executable cache"),
        ("MXNET_EXEC_BULK_EXEC_TRAIN", True,
         "op bulking, subsumed by XLA fusion"),
        ("MXNET_TRAIN_REMAT", "none",
         "jax.checkpoint policy of ParallelTrainStep"),
        ("MXNET_PRNG_IMPL", "auto", "the JAX PRNG implementation"),
        ("MXNET_FLASH_BWD_BLOCK_Q", 0,
         "q-block size of the Pallas flash-attention backward"),
        ("MXNET_FLASH_BWD_BLOCK_K", 0,
         "k-block size of the Pallas flash-attention backward")):
    register(_name, _default, doc=_doc, applicable=False)
del _name, _default, _doc
