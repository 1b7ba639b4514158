"""ModelEndpoint: a loaded model served in shape buckets on one device (the
port of ``mxnet_tpu/serving/endpoint.py``).

The JAX endpoint AOT-compiles one executable per batch bucket. PyTorch runs
eagerly, so "compiling" a bucket is a no-op here; ``warmup`` still runs
every bucket once, so the first request of each size pays no first-use cost
(kernel build, library heuristics, allocator growth). Inputs are cast on
the host, padded to the bucket and moved to the endpoint's device; the
forward runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import Context, DTypes, MXNetError, current_context
from . import bucketing
from .batcher import now_us
from .stats import EndpointStats

__all__ = ["ModelEndpoint"]


class ModelEndpoint:
    """A named, servable model.

    Parameters
    ----------
    name : str
        The endpoint's name; ``InferenceServer.submit`` addresses it.
    block : torch.nn.Module
        The model, moved to the endpoint's device and put in eval mode.
        Cast it (``block.to(torch.bfloat16)``) before serving in bf16.
    input_shapes : shape | sequence of shapes
        Per-example shape (without the batch axis) of each model input.
    dtype : str | sequence of str
        Host dtype of each input; requests are cast on the host.
    max_batch_size : int
        Largest served batch; also the largest bucket.
    buckets : sequence of int, optional
        Ascending batch-size buckets (default: powers of two).
    ctx : Context, optional
        Device to serve from; default :func:`current_context`, which is
        ``gpu(0)``. A GPU context without CUDA raises MXNetError.
    """

    def __init__(self, name: str, block, input_shapes, dtype="float32",
                 max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 ctx: Optional[Context] = None):
        self.name = name
        self.ctx = ctx if ctx is not None else current_context()
        self.device = self.ctx.torch_device()
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise MXNetError("max_batch_size must be >= 1")
        self.buckets = bucketing.validate_buckets(
            buckets if buckets is not None
            else bucketing.pow2_buckets(self.max_batch_size),
            self.max_batch_size)
        if input_shapes and isinstance(input_shapes[0], int):
            input_shapes = (input_shapes,)
        self.input_shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(d) for d in s) for s in input_shapes)
        dts = tuple(dtype) if isinstance(dtype, (list, tuple)) \
            else (dtype,) * len(self.input_shapes)
        if len(dts) != len(self.input_shapes):
            raise MXNetError("one dtype per input required")
        self.np_dtypes = tuple(DTypes.numpy(d) for d in dts)
        self.block = block.to(self.device).eval()
        self.stats = EndpointStats(name)
        self._warm = set()
        self._probe()

    # ------------------------------------------------------------------
    def _zeros_batch(self, rows: int):
        return tuple(np.zeros((rows,) + s, dt)
                     for s, dt in zip(self.input_shapes, self.np_dtypes))

    def _forward(self, device_inputs) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode():
            out = self.block(*device_inputs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _probe(self):
        """One forward of a one-row zero batch: validates the input
        signature and records the output arity for per-request slicing."""
        outs = self._forward(self._place(self._zeros_batch(1)))
        self._sync()
        self.stats.bump("warmup_batches")
        for o in outs:
            if not (isinstance(o, torch.Tensor) and o.dim() and o.shape[0] == 1):
                raise MXNetError(
                    f"endpoint {self.name!r}: every model output must be "
                    "batch-major (leading axis = batch) so per-request rows "
                    f"can be sliced back out; got {getattr(o, 'shape', o)}")
        self.num_outputs = len(outs)

    def _place(self, arrays):
        """Host -> device transfer of one batch's input arrays."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

    def warmup(self) -> int:
        """Run every not-yet-warm bucket once; returns how many ran."""
        n = 0
        for b in self.buckets:
            if b in self._warm:
                continue
            self._forward(self._place(self._zeros_batch(b)))
            self._sync()
            self.stats.bump("warmup_batches")
            self._warm.add(b)
            n += 1
        return n

    # ------------------------------------------------------------------
    def prepare(self, host_inputs: Sequence[np.ndarray], rows: int):
        """Host half of a batch step: pad concatenated host inputs to their
        bucket and move them to the device. Returns
        ``(device_inputs, bucket)``."""
        bucket = bucketing.bucket_for(rows, self.buckets)
        return self._place(tuple(bucketing.pad_rows(a, bucket)
                                 for a in host_inputs)), bucket

    def execute(self, device_inputs, bucket: int, rows: int):
        """Device half: one forward over a prepared bucket, waited for.
        Returns the outputs with ``bucket`` rows each."""
        t0 = now_us()
        outs = self._forward(device_inputs)
        self._sync()
        self.stats.record_step(now_us() - t0)
        self.stats.bump("batches")
        self.stats.bump("real_rows", rows)
        self.stats.bump("padded_rows", bucket - rows)
        return outs

    def run_batch(self, host_inputs: Sequence[np.ndarray], rows: int):
        """Serial prepare-then-execute; returns ``(outputs, bucket)``."""
        ins, bucket = self.prepare(host_inputs, rows)
        return self.execute(ins, bucket, rows), bucket

    def __repr__(self):
        return (f"ModelEndpoint({self.name!r}, inputs={self.input_shapes}, "
                f"buckets={self.buckets}, device={self.device})")
