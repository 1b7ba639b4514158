"""Gradient compression (the counterpart of
``mxnet_tpu/kvstore/gradient_compression.py``; MXNet's
``gradient_compression.{h,cc,cu}``): 2-bit and 1-bit quantization of a
pushed gradient with an error-feedback residual per key and device.

``quantize`` adds the key's residual to the gradient and packs it into the
uint8 wire tensor: 2-bit codes (0 -> 0, 1 -> +threshold, 2 -> -threshold),
four to a byte, or 1-bit signs, eight to a byte, with the mean |value| as
the scale. The new residual is what the codes lose. ``dequantize`` unpacks
a wire tensor; ``roundtrip`` is both, the lossy gradient a peer would
rebuild, which is what a single-process store applies. The bytes, scales
and residuals are the reference's bit for bit, but for the 1-bit scale:
a mean over every value, summed here in float64 and rounded once to
float32, so that the card and the CPU agree whatever their summation
order; XLA's float32 sum on the CPU lands within a few float32 ulps of it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..base import MXNetError
from ..ops.quantization import _const

__all__ = ["GradientCompression"]


def _tensor(g):
    return g._data if hasattr(g, "_data") else g


def _pack(codes, per_byte, bits):
    """``codes`` (uint8, each < 2^bits) ``per_byte`` to a byte, the first
    in the lowest bits; the tail padded with zeros."""
    rem = (-codes.numel()) % per_byte
    if rem:
        codes = torch.cat([codes, codes.new_zeros(rem)])
    c = codes.reshape(-1, per_byte)
    out = c[:, 0].clone()
    for i in range(1, per_byte):
        out |= c[:, i] << (bits * i)
    return out


def _unpack(packed, per_byte, bits, n):
    mask = (1 << bits) - 1
    return torch.stack([(packed >> (bits * i)) & mask
                        for i in range(per_byte)], dim=1).reshape(-1)[:n]


class GradientCompression:
    def __init__(self, type: str = "2bit", threshold: float = 0.5):
        if type not in ("2bit", "1bit"):
            raise MXNetError("gradient compression supports '2bit' and '1bit'")
        self.type = type
        self.threshold = threshold
        self._residuals: Dict = {}

    def get_params(self):
        return {"type": self.type, "threshold": str(self.threshold)}

    def _levels(self, codes, scale):
        """The values the codes stand for (float32)."""
        if self.type == "2bit":
            th = _const(self.threshold, codes.device)
            zero = _const(0.0, codes.device)
            return torch.where(codes == 1, th,
                               torch.where(codes == 2, -th, zero))
        return torch.where(codes == 1, scale, -scale)

    # -- wire format ---------------------------------------------------------
    def quantize(self, key, grad):
        """``(packed uint8, scale)`` of the gradient plus the residual of
        ``key``; the residual becomes what this packing loses."""
        g = _tensor(grad)
        res = self._residuals.get(key)
        acc = g.to(torch.float32) + (0.0 if res is None else res)
        flat = acc.reshape(-1)
        if self.type == "2bit":
            th = self.threshold
            codes = torch.where(flat >= th, 1, torch.where(
                flat <= -th, 2, 0)).to(torch.uint8)
            scale = _const(th, flat.device).clone()
            packed = _pack(codes, 4, 2)
        else:
            scale = (flat.abs().sum(dtype=torch.float64)
                     / max(flat.numel(), 1)).to(torch.float32)
            codes = (flat >= 0).to(torch.uint8)
            packed = _pack(codes, 8, 1)
        self._residuals[key] = (flat - self._levels(codes, scale)).reshape(
            g.shape)
        from . import _count_compression
        _count_compression(flat.numel() * 4, packed.numel())
        return packed, scale

    def dequantize(self, packed, scale, shape, dtype):
        """One wire tensor back to a dense gradient of ``shape`` and
        ``dtype``."""
        n = math.prod(shape)
        if self.type == "2bit":
            codes = _unpack(packed, 4, 2, n)
        else:
            codes = _unpack(packed, 8, 1, n)
        return self._levels(codes, scale).reshape(shape).to(dtype)

    def roundtrip(self, key, grad):
        """Quantize then dequantize: the lossy gradient a peer rebuilds,
        the residual of ``key`` updated."""
        g = _tensor(grad)
        packed, scale = self.quantize(key, g)
        return self.dequantize(packed, scale, tuple(g.shape), g.dtype)

    def reset(self):
        self._residuals.clear()
