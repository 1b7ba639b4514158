"""Batch-size bucket policy (a copy of ``mxnet_tpu/serving/bucketing.py``).

Batch sizes round up to a small fixed ladder (powers of two by default): on
the card this bounds the distinct shapes the kernels and the matrix-product
heuristics see, while padding waste per step stays below 2x.
:func:`seq_buckets` is the sequence-length ladder of the decode path's
prefill.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["pow2_buckets", "seq_buckets", "validate_buckets", "bucket_for",
           "pad_rows"]


def validate_buckets(buckets: Sequence[int], max_batch_size: int
                     ) -> Tuple[int, ...]:
    """Integers >= 1, strictly ascending, the largest equal to
    ``max_batch_size``; returns the ladder as a tuple or raises."""
    ladder = tuple(buckets)
    if not ladder:
        raise MXNetError("bucket list must be non-empty")
    prev = 0
    for b in ladder:
        ib = int(b)
        if ib != b or ib < 1:
            raise MXNetError(
                f"buckets must be integers >= 1, got {b!r} in {ladder}")
        if ib <= prev:
            raise MXNetError(
                "buckets must be strictly ascending with no duplicates "
                f"(got {ladder}: {ib} after {prev})")
        prev = ib
    ladder = tuple(int(b) for b in ladder)
    if ladder[-1] != max_batch_size:
        raise MXNetError("largest bucket must equal max_batch_size "
                         f"(got buckets={ladder}, "
                         f"max_batch_size={max_batch_size})")
    return ladder


def pow2_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-two ladder 1, 2, 4, ... capped at and including max_batch_size."""
    if max_batch_size < 1:
        raise MXNetError(f"max_batch_size must be >= 1, got {max_batch_size}")
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


def seq_buckets(max_seq_len: int, min_bucket: int = 16,
                ladder: Sequence[int] = None) -> Tuple[int, ...]:
    """Sequence-length ladder for prefill bucketing: doubles from
    ``min_bucket`` (a one-token prefill is what a decode step does already)
    and is capped at (and always includes) ``max_seq_len``. An explicit
    ``ladder`` skips generation and gets :func:`validate_buckets`' checks."""
    if max_seq_len < 1:
        raise MXNetError(f"max_seq_len must be >= 1, got {max_seq_len}")
    if ladder is not None:
        return validate_buckets(ladder, max_seq_len)
    if min_bucket < 1:
        raise MXNetError(f"min_bucket must be >= 1, got {min_bucket}")
    out = []
    b = min(min_bucket, max_seq_len)
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return validate_buckets(out, max_seq_len)


def bucket_for(rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``rows`` real rows."""
    for b in buckets:
        if b >= rows:
            return b
    raise MXNetError(f"{rows} rows exceed the largest bucket {buckets[-1]}")


def pad_rows(batch: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``batch`` along axis 0 up to ``bucket`` rows (no copy when
    already exact)."""
    rows = batch.shape[0]
    if rows == bucket:
        return batch
    if rows > bucket:
        raise MXNetError(f"batch of {rows} rows does not fit bucket {bucket}")
    pad = np.zeros((bucket - rows,) + batch.shape[1:], dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0)
