"""SSD of the port: the counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
ssd.py`` (``SSD`` over the VGG16-reduced backbone, ``ssd_300_vgg16``,
the small ``ssd_96_tiny``, ``SSDMultiBoxLoss`` and the VOC07 ``MApMetric``).

The blocks are Gluon ``HybridBlock`` s computing on tensors, built under
the reference's name scopes, so ``_collect_params_with_prefix()`` names
(the ``state_dict()`` keys, for example ``backbone.stage1.0.weight``) and
``collect_params()`` names (``ssd0_vgg16reduced0_conv2d0_weight``) equal
the JAX package's; every convolution is given its input channels, so all
shapes are known at construction. ``state_from_jax`` carries the
reference's weights across.

The forward returns ``(anchors (1, N, 4), cls_preds (B, classes + 1, N),
loc_preds (B, N * 4))``, N = 8732 at 300 x 300: the anchors from the
``MultiBoxPrior`` op of each feature map, the heads' 3 x 3 convolutions
reordered to anchor-major. The loss matches anchors with
``MultiBoxTarget`` and mines hard negatives 3:1 with a double stable
argsort; ``detect`` decodes and runs NMS with ``MultiBoxDetection``. The
convolutions are library convolutions (cuDNN), as they are XLA's in the
JAX package: no hand-written kernel lies on this model's path.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ....base import MXNetError
from ....initializer import Constant
from ....ndarray.ndarray import NDArray
from ....ops import contrib, tensor
from ....ops import nn as nn_ops
from ...block import HybridBlock
from ...loss import Loss
from ...nn import Conv2D, HybridSequential, MaxPool2D
from ..carrier import check_against, to_tensor

__all__ = ["SSD", "ssd_300_vgg16", "ssd_96_tiny", "SSDMultiBoxLoss",
           "MApMetric", "state_from_jax"]

_IMAGE_CHANNELS = 3
# per-scale anchor config (example/ssd symbol_factory.py, vgg16_reduced 300)
_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
          (0.71, 0.79), (0.88, 0.961)]
_RATIOS = [(1.0, 2.0, 0.5), (1.0, 2.0, 0.5, 3.0, 1.0 / 3),
           (1.0, 2.0, 0.5, 3.0, 1.0 / 3), (1.0, 2.0, 0.5, 3.0, 1.0 / 3),
           (1.0, 2.0, 0.5), (1.0, 2.0, 0.5)]


def _vgg_block(out, n, channels, in_channels, pool=True):
    for _ in range(n):
        out.add(Conv2D(channels, 3, padding=1, activation="relu",
                       in_channels=in_channels))
        in_channels = channels
    if pool:
        out.add(MaxPool2D(2, strides=2, ceil_mode=True))
    return channels


class _VGG16Reduced(HybridBlock):
    """VGG16 with fc6/fc7 as dilated convolutions; returns the conv4_3
    (38 x 38) and fc7 (19 x 19) features at 300 x 300."""

    _io = "tensor"
    channels = (512, 1024)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stage1 = HybridSequential()
            c = _vgg_block(self.stage1, 2, 64, _IMAGE_CHANNELS)
            c = _vgg_block(self.stage1, 2, 128, c)
            c = _vgg_block(self.stage1, 3, 256, c)
            _vgg_block(self.stage1, 3, 512, c, pool=False)
            self.stage2 = HybridSequential()
            self.stage2.add(MaxPool2D(2, strides=2, ceil_mode=True))
            _vgg_block(self.stage2, 3, 512, 512, pool=False)
            self.stage2.add(MaxPool2D(3, strides=1, padding=1))
            self.stage2.add(Conv2D(1024, 3, padding=6, dilation=6,
                                   activation="relu", in_channels=512))
            self.stage2.add(Conv2D(1024, 1, activation="relu",
                                   in_channels=1024))

    def forward(self, x):
        c4 = self.stage1(x)
        return c4, self.stage2(c4)


class _ExtraLayer(HybridBlock):
    _io = "tensor"

    def __init__(self, mid, out, stride, padding, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = HybridSequential()
            self.body.add(Conv2D(mid, 1, activation="relu",
                                 in_channels=in_channels),
                          Conv2D(out, 3, strides=stride, padding=padding,
                                 activation="relu", in_channels=mid))

    def forward(self, x):
        return self.body(x)


class SSD(HybridBlock):
    """SSD heads over multi-scale features: forward(x) -> (anchors
    (1, N, 4), cls_preds (B, num_classes + 1, N), loc_preds (B, N * 4)).
    A backbone with a ``channels`` attribute (its features' channels)
    gives the heads their input channels; another leaves them to the
    first input."""

    _io = "tensor"

    def __init__(self, num_classes=20, backbone=None, extras_spec=None,
                 sizes=None, ratios=None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        vgg = backbone is None
        self._sizes = _SIZES if sizes is None else sizes
        self._ratios = _RATIOS if ratios is None else ratios
        if len(self._sizes) != len(self._ratios):
            raise ValueError(
                f"sizes ({len(self._sizes)} scales) and ratios "
                f"({len(self._ratios)}) must have one entry per feature scale")
        if extras_spec is None:
            # (mid, out, stride, padding) per extra scale (symbol_builder.py)
            extras_spec = [(256, 512, 2, 1),    # 10x10
                           (128, 256, 2, 1),    # 5x5
                           (128, 256, 1, 0),    # 3x3
                           (128, 256, 1, 0)] if vgg else []
        with self.name_scope():
            self.backbone = _VGG16Reduced() if vgg else backbone
            chans = list(getattr(self.backbone, "channels", ()))
            self.extras = HybridSequential()
            for mid, out, stride, padding in extras_spec:
                self.extras.add(_ExtraLayer(mid, out, stride, padding,
                                            in_channels=chans[-1]
                                            if chans else 0))
                chans = chans + [out] if chans else []
            self.cls_heads = HybridSequential()
            self.loc_heads = HybridSequential()
            for i, (sizes_i, ratios_i) in enumerate(zip(self._sizes,
                                                        self._ratios)):
                na = len(sizes_i) + len(ratios_i) - 1
                c_in = chans[i] if i < len(chans) else 0
                self.cls_heads.add(Conv2D(na * (num_classes + 1), 3,
                                          padding=1, in_channels=c_in))
                self.loc_heads.add(Conv2D(na * 4, 3, padding=1,
                                          in_channels=c_in))
            if vgg:
                # the conv4_3 scale (symbol_builder.py L2Normalization,
                # scale 20); custom backbones skip the normalization
                self.conv4_3_scale = self.params.get(
                    "conv4_3_scale", shape=(1, 512, 1, 1),
                    init=Constant(20.0))

    def forward(self, x):
        feats = list(self.backbone(x))
        if "conv4_3_scale" in self._reg_params:
            feats[0] = nn_ops.l2_normalization(feats[0], mode="channel") \
                * self._t("conv4_3_scale")
        f = feats[-1]
        for blk in self.extras:
            f = blk(f)
            feats.append(f)
        if len(feats) != len(self._sizes):
            raise ValueError(
                f"anchor config has {len(self._sizes)} scales but the "
                f"backbone+extras produce {len(feats)} feature maps; pass "
                "matching sizes=/ratios= when using a custom backbone")
        anchors, cls_preds, loc_preds = [], [], []
        for i, (f, sizes, ratios) in enumerate(zip(feats, self._sizes,
                                                   self._ratios)):
            anchors.append(contrib.multibox_prior(f, sizes=sizes,
                                                  ratios=ratios, clip=False))
            # (B, A*(C+1), H, W) -> (B, H*W*A, C+1)
            c = self.cls_heads[i](f).permute(0, 2, 3, 1)
            loc = self.loc_heads[i](f).permute(0, 2, 3, 1)
            cls_preds.append(c.reshape(c.shape[0], -1,
                                       self.num_classes + 1))
            loc_preds.append(loc.reshape(loc.shape[0], -1))
        return (torch.cat(anchors, dim=1),
                torch.cat(cls_preds, dim=1).transpose(1, 2),
                torch.cat(loc_preds, dim=1))

    def detect(self, x, threshold=0.01, nms_threshold=0.45, nms_topk=400):
        """Forward, softmax, decode and NMS -> (B, N, 6) rows [cls, score,
        x1, y1, x2, y2], suppressed rows -1; NDArrays in, an NDArray out
        (through ``nd``), or tensors in, a tensor out."""
        kw = dict(threshold=threshold, nms_threshold=nms_threshold,
                  nms_topk=nms_topk)
        if isinstance(x, NDArray):
            from .... import ndarray as nd
            anchors, cls_preds, loc_preds = self(x)
            return nd.contrib.MultiBoxDetection(
                nd.softmax(cls_preds, axis=1), loc_preds, anchors, **kw)
        with torch.no_grad():
            anchors, cls_preds, loc_preds = self(x)
            return contrib.multibox_detection(
                nn_ops.softmax(cls_preds, axis=1), loc_preds, anchors, **kw)

    def jax_names(self) -> Dict[str, str]:
        """{state-dict key: its ``collect_params()`` name with the net
        counters of its top scopes dropped (``ssd_conv2d0_weight``,
        ``_tinyfeatures_conv2d0_weight``)}."""
        return {k: _canonical(p.name)[0]
                for k, p in self._collect_params_with_prefix().items()}


class SSDMultiBoxLoss(Loss):
    """The classification cross-entropy with hard-negative mining (the
    ``negative_mining_ratio`` x positives highest-loss negatives, plus one)
    and the smooth-L1 box loss on matched anchors, over max(1, positives),
    per image."""

    def __init__(self, negative_mining_ratio=3.0, lambd=1.0, **kwargs):
        super().__init__(None, 0, **kwargs)
        self._ratio = negative_mining_ratio
        self._lambd = lambd

    def forward(self, anchors, cls_preds, loc_preds, label):
        box_t, box_m, cls_t = contrib.multibox_target(anchors, label,
                                                      cls_preds)
        logp = nn_ops.log_softmax(cls_preds, axis=1)
        pos = cls_t > 0
        ce = -tensor.pick(logp, cls_t.to(torch.int32), axis=1)   # (B, N)
        posf = pos.to(torch.float32)
        neg_loss = torch.where(pos, torch.zeros_like(ce), ce)
        n_pos = posf.sum(dim=1)
        rank = tensor.argsort(tensor.argsort(neg_loss, axis=1,
                                             is_ascend=False),
                              axis=1, is_ascend=True)
        n_neg = torch.minimum(n_pos * self._ratio + 1,
                              torch.ones_like(n_pos) * ce.shape[1])
        negf = (rank < n_neg.reshape(-1, 1)).to(torch.float32)
        keep = torch.maximum(posf, negf)
        cls_loss = (ce * keep).sum(dim=1)
        diff = (loc_preds - box_t) * box_m
        ad = diff.abs()
        loc_loss = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5) \
            .sum(dim=1)
        denom = torch.maximum(n_pos, torch.ones_like(n_pos))
        return (cls_loss + self._lambd * loc_loss) / denom


class MApMetric:
    """VOC07 11-point mean average precision over detection rows, on the
    host with numpy."""

    def __init__(self, ovp_thresh=0.5, class_names=None):
        self.ovp_thresh = ovp_thresh
        self.class_names = class_names
        self.reset()

    def reset(self):
        self._records = {}   # cls -> list of (score, tp)
        self._npos = {}

    @staticmethod
    def _iou(a, b):
        ix1 = np.maximum(a[0], b[:, 0])
        iy1 = np.maximum(a[1], b[:, 1])
        ix2 = np.minimum(a[2], b[:, 2])
        iy2 = np.minimum(a[3], b[:, 3])
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
        ua = (a[2] - a[0]) * (a[3] - a[1]) + \
            (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter
        return inter / np.maximum(ua, 1e-12)

    @staticmethod
    def _numpy(a):
        if hasattr(a, "asnumpy"):
            return a.asnumpy()
        if isinstance(a, torch.Tensor):
            return a.detach().float().cpu().numpy()
        return np.asarray(a)

    def update(self, det, labels):
        """det: (B, N, 6) rows [cls, score, x1..y2] (-1 = suppressed);
        labels: (B, M, 5) [cls, x1, y1, x2, y2] (-1 padding)."""
        det, labels = self._numpy(det), self._numpy(labels)
        for b in range(det.shape[0]):
            gts = labels[b][labels[b][:, 0] >= 0]
            for c in set(gts[:, 0].astype(int)):
                self._npos[c] = self._npos.get(c, 0) + int(
                    (gts[:, 0] == c).sum())
            rows = det[b][det[b][:, 0] >= 0]
            used = np.zeros(len(gts), bool)
            for row in rows[np.argsort(-rows[:, 1])]:
                c = int(row[0])
                cand = np.where((gts[:, 0] == c) & ~used)[0]
                tp = 0
                if len(cand):
                    ious = self._iou(row[2:6], gts[cand][:, 1:5])
                    j = int(np.argmax(ious))
                    if ious[j] >= self.ovp_thresh:
                        used[cand[j]] = True
                        tp = 1
                self._records.setdefault(c, []).append((float(row[1]), tp))

    def get(self):
        aps = []
        for c, npos in self._npos.items():
            recs = sorted(self._records.get(c, []), reverse=True)
            if not recs or npos == 0:
                aps.append(0.0)
                continue
            tps = np.cumsum([tp for _, tp in recs])
            fps = np.cumsum([1 - tp for _, tp in recs])
            rec = tps / npos
            prec = tps / np.maximum(tps + fps, 1e-12)
            ap = 0.0
            for t in np.arange(0.0, 1.01, 0.1):   # VOC07 11-point
                p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                ap += p / 11
            aps.append(ap)
        return "mAP", float(np.mean(aps)) if aps else 0.0


def ssd_300_vgg16(classes=20, **kwargs):
    """SSD-300 over VGG16-reduced (BASELINE config 4): 8732 anchors."""
    return SSD(num_classes=classes, **kwargs)


class _TinyFeatures(HybridBlock):
    """A small two-scale feature extractor for 96 x 96 inputs (12 x 12 and
    6 x 6)."""

    _io = "tensor"
    channels = (64, 128)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stage1 = HybridSequential()          # 96 -> 12
            c = _IMAGE_CHANNELS
            for ch in (16, 32, 64):
                self.stage1.add(
                    Conv2D(ch, 3, padding=1, activation="relu",
                           in_channels=c),
                    Conv2D(ch, 3, padding=1, activation="relu",
                           in_channels=ch),
                    MaxPool2D(2, strides=2))
                c = ch
            self.stage2 = HybridSequential()          # 12 -> 6
            self.stage2.add(Conv2D(128, 3, padding=1, activation="relu",
                                   in_channels=64),
                            MaxPool2D(2, strides=2))

    def forward(self, x):
        f1 = self.stage1(x)
        return f1, self.stage2(f1)


_TINY_SIZES = [(0.1, 0.16), (0.25, 0.35), (0.45, 0.6), (0.75, 0.9)]


def ssd_96_tiny(classes=3, **kwargs):
    """A small SSD for 96 x 96 inputs over the same MultiBox machinery:
    four scales (12, 6, 3, 1), 760 anchors."""
    return SSD(num_classes=classes, backbone=_TinyFeatures(),
               extras_spec=[(64, 128, 2, 1),    # 6 -> 3
                            (64, 128, 1, 0)],   # 3 -> 1
               sizes=_TINY_SIZES, ratios=[(1.0, 2.0, 0.5)] * 4, **kwargs)


# ---------------------------------------------------------------------------
# weight carrier
# ---------------------------------------------------------------------------
# the top scopes a process numbers: the net's, and the tiny backbone's,
# which the reference builds outside the net's scope
_SCOPE = re.compile(r"^(ssd|_tinyfeatures)(\d*)_")


def _canonical(name):
    """(name with its top scope's counter dropped, (scope, counter)); a
    name of no SSD scope comes back as it is, scope None."""
    m = _SCOPE.match(name)
    if m is None:
        return name, (None, None)
    return f"{m.group(1)}_{name[m.end():]}", (m.group(1), m.group(2))


def state_from_jax(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``carrier.params_from_jax`` for an SSD's ``collect_params()`` names:
    the state dict of the ``ssd_300_vgg16`` or ``ssd_96_tiny`` (any class
    count) whose parameters these are (``ssd0_...``, and
    ``_tinyfeatures0_...`` for the tiny net's backbone, which the
    reference builds outside the net's scope). Raises MXNetError unless
    the names and shapes are exactly that net's."""
    by_name, scopes = {}, {}
    for k, v in named.items():
        canon, (scope, count) = _canonical(k)
        if scope is None:
            raise MXNetError(f"parameters do not match an SSD: {k!r} is no "
                             "ssd_300_vgg16 or ssd_96_tiny name")
        scopes.setdefault(scope, set()).add(count)
        by_name[canon] = v
    if any(len(v) > 1 for v in scopes.values()):
        raise MXNetError(f"parameters do not match an SSD: names of several "
                         f"nets {sorted(scopes.items())}")
    tiny = "_tinyfeatures" in scopes
    make = ssd_96_tiny if tiny else ssd_300_vgg16
    probe = make(classes=1)
    w = by_name.get(probe.jax_names()["cls_heads.0.weight"])
    if w is None:
        raise MXNetError("parameters do not match an SSD: no class head")
    na = len(probe._sizes[0]) + len(probe._ratios[0]) - 1
    net = make(classes=np.shape(w)[0] // na - 1)
    to_key = {v: k for k, v in net.jax_names().items()}
    keyed = {to_key.get(c, c): v for c, v in by_name.items()}
    what = "an ssd_96_tiny" if tiny else "an ssd_300_vgg16"
    check_against({k: p.shape for k, p in
                   net._collect_params_with_prefix().items()},
                  {k: tuple(np.shape(v)) for k, v in keyed.items()}, what)
    return {k: to_tensor(v) for k, v in keyed.items()}
