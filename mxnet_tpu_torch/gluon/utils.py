"""``gluon.utils`` of the port (the counterpart of
``mxnet_tpu/gluon/utils.py``): ``split_data``, ``split_and_load`` and
``clip_global_norm``. ``download`` and ``check_sha1`` are not ported (the
port fetches nothing)."""
from __future__ import annotations

import math
import warnings

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops.registry import apply_op

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last one
    takes the remainder unless ``even_split``, which requires none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(apply_op("slice_axis", data, axis=batch_axis,
                               begin=begin, end=end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch along ``batch_axis`` and load one slice per
    context."""
    if not isinstance(data, NDArray):
        data = NDArray(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale the arrays in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before scaling (a float). A row-sparse
    array (an Embedding's ``sparse_grad`` gradient) contributes its stored
    rows, which are unique, so its dense norm, and has them scaled (the
    JAX package's function raises TypeError on one: ROADMAP Queue 3)."""
    if not arrays:
        raise MXNetError("arrays must not be empty")
    total = sum(float(torch.sum(a._data.float().square())) for a in arrays)
    total_norm = math.sqrt(total)
    if check_isfinite and not math.isfinite(total_norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a._set_data(a._data * scale)
    return total_norm
