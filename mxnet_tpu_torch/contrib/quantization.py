"""Post-training int8 quantization of a Gluon net (the counterpart of
``mxnet_tpu/contrib/quantization.py``; MXNet's ``quantize_net``).

``quantize_net`` calibrates the float32 net on ``calib_data`` with Gluon
forward pre-hooks collecting each quantizable layer's input statistics
(min/max and a histogram), then swaps every ``Dense`` and ``Conv2D`` child
in place for a :class:`QuantizedDense` or :class:`QuantizedConv2D` that
shares its ``Parameter`` s. A quantized layer quantizes its input with the
calibrated range and its weight by the weight's own min/max at every
forward, multiplies in int8 with int32 accumulation
(``ops/quantization.py``), dequantizes, adds the bias and applies the
activation. Its ranges stay 0-d tensors on the device: a forward reads
nothing back to the host.

Calibration modes: ``naive`` (the observed min/max), ``percentile`` and
``entropy`` (KL divergence, ``calibrate_entropy``), the latter two over
the collected histogram. Histograms of later batches combine as MXNet's
``_LayerHistogramCollector.combine_histogram`` does: a batch no wider than
the running range is binned over that range; a wider one widens the
histogram by whole bins of the old width on each side.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as onp
import torch

from .. import amp as _amp
from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import NDArray
from ..ops import quantization as Q

__all__ = ["quantize_net", "LayerInputCollector", "QuantizedDense",
           "QuantizedConv2D"]

_NUM_BINS = 8001  # MXNet's _LayerHistogramCollector default


def _host(x) -> onp.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return onp.asarray(x)


def combine_histogram(old, arr, new_th):
    """MXNet's ``combine_histogram``: ``old`` is (hist, edges, th); the
    batch ``arr`` with |max| ``new_th`` joins it."""
    old_hist, old_edges, old_th = old
    if new_th <= old_th:
        hist, _ = onp.histogram(arr, bins=len(old_hist),
                                range=(-old_th, old_th))
        return old_hist + hist, old_edges, old_th
    old_num_bins = len(old_hist)
    old_step = 2 * old_th / old_num_bins
    half_increased_bins = int((new_th - old_th) // old_step + 1)
    new_num_bins = half_increased_bins * 2 + old_num_bins
    new_th = half_increased_bins * old_step + old_th
    hist, edges = onp.histogram(arr, bins=new_num_bins,
                                range=(-new_th, new_th))
    hist = hist.astype(onp.float64)
    hist[half_increased_bins:new_num_bins - half_increased_bins] += old_hist
    return hist, edges, new_th


class LayerInputCollector:
    """Per-layer input min/max and histograms during calibration, through
    Gluon forward pre-hooks on the quantizable layers. ``hists[name]`` is
    ``[hist, edges]`` (``edges[-1]`` the histogram's range)."""

    def __init__(self):
        self.min_max: Dict[str, List[float]] = {}
        self.hists: Dict[str, List] = {}
        self._handles = []

    def hook(self, name):
        def _pre(block, args):
            a = _host(args[0])
            mn, mx = float(a.min()), float(a.max())
            if name in self.min_max:
                self.min_max[name][0] = min(self.min_max[name][0], mn)
                self.min_max[name][1] = max(self.min_max[name][1], mx)
            else:
                self.min_max[name] = [mn, mx]
            th = max(abs(mn), abs(mx), 1e-12)
            prev = self.hists.get(name)
            if prev is None:
                hist, edges = onp.histogram(a, bins=_NUM_BINS,
                                            range=(-th, th))
                self.hists[name] = [hist.astype(onp.float64), edges, th]
            else:
                self.hists[name] = list(combine_histogram(prev, a, th))
        return _pre

    def attach(self, block, name):
        self._handles.append((block, block.register_forward_pre_hook(
            self.hook(name))))

    def detach(self):
        for blk, h in self._handles:
            blk._gluon_pre_hooks.remove(h)
        self._handles = []


def _threshold(collector, name, mode, percentile):
    mn, mx = collector.min_max[name]
    if mode == "naive":
        amax = max(abs(mn), abs(mx))
    elif mode == "percentile":
        hist, edges = collector.hists[name][:2]
        total = hist.sum()
        centers_abs = onp.abs((edges[:-1] + edges[1:]) / 2)
        order = onp.argsort(centers_abs)
        cum = onp.cumsum(hist[order]) / max(total, 1)
        idx = onp.searchsorted(cum, percentile)
        idx = min(idx, order.size - 1)
        amax = float(centers_abs[order[idx]])
    elif mode == "entropy":
        hist, edges = collector.hists[name][:2]
        amax, _ = Q.calibrate_entropy(hist, edges)
    else:
        raise MXNetError(f"unknown calib_mode {mode!r}")
    return max(float(amax), 1e-12)


def _quantized_product(x, weight, amax, product):
    """quantize x by the calibrated range and the weight by its own,
    ``product(xq, wq, ranges...)`` -> int32, dequantize."""
    xq, xmn, xmx = Q.quantize_v2(x, min_calib_range=-amax,
                                 max_calib_range=amax)
    wq, wmn, wmx = Q.quantize_v2(weight)
    acc = product(xq, wq, xmn, xmx, wmn, wmx)[0]
    return Q.dequantize_accum(acc, xmn, xmx, wmn, wmx)


class QuantizedDense(HybridBlock):
    """int8 ``Dense`` sharing the float layer's parameters, with the input
    range from calibration."""

    _io = "tensor"

    def __init__(self, orig: "nn.Dense", calib_amax: float, **kwargs):
        super().__init__(**kwargs)
        object.__setattr__(self, "_src", orig)
        self.weight = orig.weight
        self.bias = orig.bias
        self._units = orig._units
        self._flatten = orig._flatten
        self._act_type = orig._act_type
        self._amax = float(calib_amax)

    def forward(self, x):
        with torch.no_grad():
            out = _quantized_product(
                x, self._t("weight"), self._amax,
                lambda *a: Q.quantized_fully_connected(
                    *a, num_hidden=self._units, flatten=self._flatten))
            b = self._t("bias")
            if b is not None:
                out = out + b
            if self._act_type:
                out = _amp.call("Activation", out, act_type=self._act_type)
        return out

    def __repr__(self):
        return f"QuantizedDense({self._units}, amax={self._amax:.4g})"


class QuantizedConv2D(HybridBlock):
    """int8 ``Conv2D`` sharing the float layer's parameters."""

    _io = "tensor"

    def __init__(self, orig, calib_amax: float, **kwargs):
        super().__init__(**kwargs)
        object.__setattr__(self, "_src", orig)
        self.weight = orig.weight
        self.bias = orig.bias
        self._conv_kwargs = dict(orig._kwargs, kernel=orig._kernel,
                                 num_filter=orig._channels)
        self._act_type = orig._act_type
        self._amax = float(calib_amax)

    def forward(self, x):
        kw = self._conv_kwargs
        with torch.no_grad():
            out = _quantized_product(
                x, self._t("weight"), self._amax,
                lambda *a: Q.quantized_conv(
                    *a, kernel=kw["kernel"], stride=kw["stride"],
                    dilate=kw["dilate"], pad=kw["pad"],
                    num_filter=kw["num_filter"], num_group=kw["num_group"]))
            b = self._t("bias")
            if b is not None:
                out = out + b.reshape((1, -1) + (1,) * (out.dim() - 2))
            if self._act_type:
                out = _amp.call("Activation", out, act_type=self._act_type)
        return out

    def __repr__(self):
        return f"QuantizedConv2D(amax={self._amax:.4g})"


def _quantizable(blk):
    return isinstance(blk, (nn.Dense, nn.Conv2D))


def quantize_net(network, quantized_dtype="int8", calib_data=None,
                 calib_mode="entropy", percentile=0.9999,
                 exclude_layers=None, exclude_layers_match=None, logger=None):
    """Calibrate and convert a Gluon net to int8 inference (MXNet's
    ``quantize_net``).

    Mutates and returns ``network``: its quantizable ``Dense`` and
    ``Conv2D`` children (those not named in ``exclude_layers`` and whose
    names hold none of ``exclude_layers_match``) are replaced in place by
    quantized blocks sharing the same ``Parameter`` s. ``calib_data`` is an
    iterable of input batches (NDArrays, tensors or tuples of them), run
    through the net without a graph; NDArray batches follow Gluon's
    inference mode, tensor batches the module's own ``train()``/
    ``eval()`` mode."""
    if quantized_dtype != "int8":
        raise MXNetError("quantization supports int8 (cuBLASLt's int8 "
                         f"product); got {quantized_dtype!r}")
    if calib_data is None:
        raise MXNetError("calib_data is required (naive/entropy/percentile "
                         "calibration all observe real activations)")
    exclude_layers = set(exclude_layers or ())
    patterns = list(exclude_layers_match or ())

    # quantizable leaf blocks with their parent and child-registry name
    targets = []

    def walk(parent):
        for name, child in list(parent._modules.items()):
            if _quantizable(child):
                full = child.name
                if full in exclude_layers or any(p in full for p in patterns):
                    continue
                targets.append((parent, name, child))
            elif child is not None:
                walk(child)

    walk(network)
    if not targets:
        return network

    collector = LayerInputCollector()
    for _, _, child in targets:
        collector.attach(child, child.name)
    was_active = getattr(network, "_active", False)
    if was_active:
        network.hybridize(False)
    with torch.no_grad():
        for batch in calib_data:
            args = batch if isinstance(batch, (tuple, list)) else (batch,)
            network(*args)
    collector.detach()

    for parent, name, child in targets:
        amax = _threshold(collector, child.name, calib_mode, percentile)
        q = QuantizedConv2D(child, amax) if isinstance(child, nn.Conv2D) \
            else QuantizedDense(child, amax)
        parent._modules[name] = q
    if was_active:
        network.hybridize(True)
    return network
