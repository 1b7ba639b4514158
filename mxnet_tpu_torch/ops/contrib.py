"""Contrib operators of the port: the counterparts of the functions in
``mxnet_tpu/ops/contrib.py`` (box geometry and NMS, the MultiBox (SSD)
family, ROIAlign/ROIPooling/RROIAlign, the multi-tensor helpers, FFT,
count sketch, the Hawkes log-likelihood, deformable convolution, the RPN
Proposal, the graph ops, the straight-through estimators and the rest),
plain PyTorch functions over tensors registered under the JAX package's
names and signatures. ``SyncBatchNorm`` waits for the multi-GPU slice.

Static shapes as in the reference: NMS marks suppressed rows with -1
instead of compacting, and ``box_nms`` suppresses greedily over a
pairwise-IoU matrix, row by row. It computes that matrix and runs the loop
over the first K sorted rows only, K = 1 + the last sorted index that is
valid in any batch row: a row at or past K is not valid, so it is never
kept and never suppresses, and the output equals the reference's over
all N rows. Finding K is one host sync (``.item()``).

Index ties are broken as the JAX package breaks them: ``argmax`` takes the
first index (PyTorch's too), sorts are stable. ``MultiBoxTarget``'s forced
matches are the reference's scatters with duplicate indices (a padding
label's best anchor is anchor 0; two labels can share a best anchor); the
JAX package's CPU scatter lets the last label win, and this computes that
winner deterministically, as the largest label index per anchor
(``scatter_reduce`` amax).

The reference's ``custom_vjp``s are ``torch.autograd.Function`` s
(``gradientmultiplier``, ``IdentityAttachKLSparseReg``, ``round_ste``,
``sign_ste``); ops registered ``differentiable=False`` carry no gradient.
The graph samplers and the subgraph ops run on the host with numpy (the
samplers draw from ``numpy.random.RandomState(seed)``, as the reference
does, so the draws are equal) and return tensors on their input's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .registry import register

__all__ = ["box_iou", "box_nms", "box_encode", "box_decode",
           "multibox_prior", "multibox_target", "multibox_detection",
           "roi_align", "roi_pooling", "bilinear_sample_nchw"]


#: the K of the last ``box_nms`` call: the sorted rows its suppression
#: loop ran over (chip_smoke.py prints it)
nms_rows = 0


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# box geometry helpers
# ---------------------------------------------------------------------------
def _corner_iou(a, b):
    """IoU of corner-format boxes: a (..., N, 4), b (..., M, 4) ->
    (..., N, M)."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    area_a = (ax2 - ax1).clamp_min(0) * (ay2 - ay1).clamp_min(0)
    area_b = (bx2 - bx1).clamp_min(0) * (by2 - by1).clamp_min(0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _center_to_corner(box):
    x, y, w, h = box.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _corner_to_center(box):
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def _encode(g, a, var):
    """Box regression targets of centers ``g`` against anchors ``a``, over
    ``var``."""
    t = torch.stack([(g[..., 0] - a[..., 0]) / a[..., 2],
                     (g[..., 1] - a[..., 1]) / a[..., 3],
                     torch.log(torch.clamp_min(g[..., 2] / a[..., 2], 1e-12)),
                     torch.log(torch.clamp_min(g[..., 3] / a[..., 3], 1e-12))],
                    dim=-1)
    return t / var


@register("_contrib_box_iou")
def box_iou(lhs, rhs, *, format="corner"):
    """Pairwise IoU (``bounding_box.cc`` box_iou)."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    return _corner_iou(lhs, rhs)


@register("_contrib_box_nms")
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=0, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS with static shapes (``bounding_box.cc`` BoxNMS): rows by
    descending score (a stable sort), suppressed and invalid rows set to
    -1 in every field.

    The suppression runs over the first K sorted rows, K = 1 + the last
    index valid in any batch row (one host sync): a row past it is not
    valid (its score is at most ``valid_thresh``, it is background, or it
    lies past ``topk``), so it neither is kept nor suppresses, and the
    result equals the loop over all N rows. With ``topk`` > 0, K <= topk."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    B, N, _ = data.shape
    scores = data[..., score_index]
    ids = data[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    boxes = data[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)

    order = torch.argsort(-scores, dim=1, stable=True)
    data_s = torch.gather(data, 1, order[..., None].expand_as(data))
    scores_s = torch.gather(scores, 1, order)
    ids_s = torch.gather(ids, 1, order)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))

    valid = scores_s > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid &= ids_s != background_id
    if topk > 0:
        valid &= torch.arange(N, device=data.device)[None, :] < topk
    pos = torch.arange(1, N + 1, device=data.device)
    k = int(torch.where(valid.any(0), pos, 0).max().item()) if N else 0
    global nms_rows
    nms_rows = k
    if k:
        iou = _corner_iou(boxes_s[:, :k], boxes_s[:, :k])       # (B, K, K)
        suppress = iou > overlap_thresh
        if not force_suppress:
            suppress &= ids_s[:, :k, None] == ids_s[:, None, :k]
        suppress &= torch.ones(k, k, dtype=torch.bool,
                               device=data.device).triu(1)
        keep = valid[:, :k].clone()
        for i in range(k):
            keep &= ~(keep[:, i:i + 1] & suppress[:, i, :])
        keep = torch.cat([keep, torch.zeros(B, N - k, dtype=torch.bool,
                                            device=data.device)], 1)
    else:
        keep = torch.zeros_like(valid)
    out = torch.where(keep[..., None], data_s, -torch.ones_like(data_s))
    return out[0] if squeeze else out


@register("_contrib_box_encode")
def box_encode(samples, matches, anchors, refs, *, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Encode matched boxes against anchors (``bounding_box.cc``
    BoxEncode): (targets, masks)."""
    a = _corner_to_center(anchors)
    idx = matches.long()[..., None].expand(matches.shape + (refs.shape[-1],))
    g = _corner_to_center(torch.gather(refs, 1, idx))
    dev = anchors.device
    t = _encode(g, a, 1.0)
    t = (t - _f32(means).to(dev)) / _f32(stds).to(dev)
    mask = (samples > 0.5)[..., None]
    return torch.where(mask, t, torch.zeros_like(t)), mask.to(t.dtype)


@register("_contrib_box_decode")
def box_decode(data, anchors, *, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """Decode box regressions against anchors (``bounding_box.cc``
    BoxDecode)."""
    a = _corner_to_center(anchors) if format == "corner" else anchors
    d = data * _f32([std0, std1, std2, std3]).to(data.device)
    x = d[..., 0] * a[..., 2] + a[..., 0]
    y = d[..., 1] * a[..., 3] + a[..., 1]
    dw, dh = d[..., 2], d[..., 3]
    if clip > 0:
        dw = torch.clamp_max(dw, clip)
        dh = torch.clamp_max(dh, clip)
    w = torch.exp(dw) * a[..., 2]
    h = torch.exp(dh) * a[..., 3]
    return _center_to_corner(torch.stack([x, y, w, h], dim=-1))


# ---------------------------------------------------------------------------
# MultiBox (SSD): multibox_prior.cc, multibox_target.cc,
# multibox_detection.cc
# ---------------------------------------------------------------------------
@register("MultiBoxPrior", differentiable=False)
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a (..., H, W) feature map: (1, H*W*(S+R-1), 4) corner
    boxes in [0, 1] coordinates, float32 (only the shape of ``data`` is
    read). Each f32 operation rounds, as the JAX package's function does
    op by op; under ``jax.jit`` XLA's CPU backend may fuse a corner's
    (i + offset) * step +- size / 2 into one multiply-add, one rounding,
    and so differ from this by an f32 ulp, by its choice of fusion."""
    H, W = data.shape[-2], data.shape[-1]
    sizes, ratios = tuple(sizes), tuple(ratios)
    step_y = steps[1] if steps[1] > 0 else 1.0 / H
    step_x = steps[0] if steps[0] > 0 else 1.0 / W
    dev = data.device
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    wh = [(s, s) for s in sizes]
    for r in ratios[1:]:
        sr = math.sqrt(r)
        wh.append((sizes[0] * sr, sizes[0] / sr))
    out = torch.stack([torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2], dim=-1) for w, h in wh],
                      dim=2).reshape(1, -1, 4)
    return out.clamp(0.0, 1.0) if clip else out


@register("MultiBoxTarget", differentiable=False)
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor matching and target encoding. label (B, M, 5) rows [cls, x1,
    y1, x2, y2], cls -1 for padding. Returns (box_target (B, N*4),
    box_mask (B, N*4), cls_target (B, N)).

    Each label forces a match at its best anchor. Where several labels
    name the same anchor (a padding label's IoUs are all 0, so its best
    anchor is anchor 0), the last label decides, as the JAX package's
    scatter does on the CPU: a padding label after a valid one whose best
    anchor is 0 undoes that forced match (ROADMAP Queue 3)."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    dev = label.device
    gt_valid = label[..., 0] >= 0                            # (B, M)
    gt_boxes = label[..., 1:5]
    iou = _corner_iou(anchors[None], gt_boxes)               # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))

    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)                       # first of ties
    matched = best_iou >= overlap_threshold
    best_anchor = torch.argmax(iou, dim=1)                   # (B, M)
    # the last label whose best anchor is n, per anchor (-1: none)
    last = torch.full((B, N), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(1, best_anchor, torch.arange(
        M, device=dev).expand(B, M).contiguous(), reduce="amax")
    forced = (last >= 0) & torch.gather(gt_valid, 1, last.clamp_min(0))
    gt_idx = torch.where(forced, last, best_gt)
    matched = matched | forced

    matched_boxes = torch.gather(gt_boxes, 1,
                                 gt_idx[..., None].expand(B, N, 4))
    a = _corner_to_center(anchors)[None]
    g = _corner_to_center(matched_boxes)
    t = _encode(g, a, _f32(variances).to(dev))
    box_target = torch.where(matched[..., None], t,
                             torch.zeros_like(t)).reshape(B, N * 4)
    box_mask = torch.where(matched[..., None], torch.ones_like(t),
                           torch.zeros_like(t)).reshape(B, N * 4)
    matched_cls = torch.gather(label[..., 0], 1, gt_idx) + 1
    cls_target = torch.where(matched, matched_cls,
                             torch.zeros_like(matched_cls))
    return box_target, box_mask, cls_target


@register("MultiBoxDetection", differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode and NMS. cls_prob (B, C, N), loc_pred (B, N*4), anchor
    (1, N, 4) -> (B, N, 6) rows [cls_id, score, x1, y1, x2, y2],
    suppressed rows -1."""
    B, C, N = cls_prob.shape
    d = loc_pred.reshape(B, N, 4) * _f32(variances).to(loc_pred.device)
    a = _corner_to_center(anchor.reshape(-1, 4))[None]
    x = d[..., 0] * a[..., 2] + a[..., 0]
    y = d[..., 1] * a[..., 3] + a[..., 1]
    w = torch.exp(d[..., 2]) * a[..., 2]
    h = torch.exp(d[..., 3]) * a[..., 3]
    boxes = _center_to_corner(torch.stack([x, y, w, h], dim=-1))
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    probs = cls_prob.transpose(1, 2)                         # (B, N, C)
    bg = torch.arange(C, device=cls_prob.device) == background_id
    cls_id = torch.argmax(probs.masked_fill(bg, -math.inf), dim=-1)
    score = torch.gather(probs, -1, cls_id[..., None])[..., 0]
    cls_out = cls_id.to(boxes.dtype) - (cls_id > background_id).to(
        boxes.dtype)
    valid = score > threshold
    neg = torch.full_like(score, -1.0)
    rows = torch.cat([torch.where(valid, cls_out, neg)[..., None],
                      torch.where(valid, score, neg)[..., None], boxes],
                     dim=-1)
    return box_nms(rows, overlap_thresh=nms_threshold,
                   valid_thresh=threshold, topk=nms_topk, coord_start=2,
                   score_index=1, id_index=0, background_id=-1,
                   force_suppress=force_suppress)


# ---------------------------------------------------------------------------
# ROIAlign / ROIPooling (roi_align.cc, roi_pooling.cc)
# ---------------------------------------------------------------------------
def _bilinear_sample(feat, ys, xs):
    """The reference's ROIAlign sampling: feat (R, C, H, W), ys/xs
    (R, *shape) -> (R, C, *shape). Corners are clamped into the image;
    a point outside [-1, H] x [-1, W] gives 0."""
    H, W = feat.shape[-2:]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    y0i = y0.long().clamp(0, H - 1)
    x0i = x0.long().clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    r = torch.arange(feat.shape[0], device=feat.device).reshape(
        (-1,) + (1,) * (ys.dim() - 1))

    def at(yi, xi):                                          # (R, *shape, C)
        return feat[r, :, yi, xi]
    out = (at(y0i, x0i) * ((1 - wy1) * (1 - wx1))[..., None]
           + at(y0i, x1i) * ((1 - wy1) * wx1)[..., None]
           + at(y1i, x0i) * (wy1 * (1 - wx1))[..., None]
           + at(y1i, x1i) * (wy1 * wx1)[..., None])
    oob = (ys < -1) | (ys > H) | (xs < -1) | (xs > W)
    out = torch.where(oob[..., None], torch.zeros_like(out), out)
    return out.movedim(-1, 1)


def _roi_grid(x1, y1, rw, rh, PH, PW, sr, dev):
    """(R, PH, PW, sr, sr) sample ys and xs: bin i's origin i * (rh / PH)
    + y1, plus (s + 0.5) * (rh / PH) / sr for sub-bin s (the reference's
    order of operations)."""
    bh, bw = (rh / PH)[:, None, None], (rw / PW)[:, None, None]
    s = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5)[None, :]
    iy = (torch.arange(PH, dtype=torch.float32, device=dev)[:, None] * bh
          + y1[:, None, None] + s * bh / sr)                 # (R, PH, sr)
    ix = (torch.arange(PW, dtype=torch.float32, device=dev)[:, None] * bw
          + x1[:, None, None] + s * bw / sr)                 # (R, PW, sr)
    R = x1.shape[0]
    ys = iy[:, :, None, :, None].expand(R, PH, PW, sr, sr)
    xs = ix[:, None, :, None, :].expand(R, PH, PW, sr, sr)
    return ys, xs


@register("_contrib_ROIAlign")
def roi_align(data, rois, *, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """ROIAlign (``roi_align.cc``). data (B, C, H, W); rois (R, 5) rows
    [b, x1, y1, x2, y2] -> (R, C, PH, PW), each bin the mean of
    sample_ratio^2 bilinear samples."""
    PH, PW = pooled_size
    sr = max(int(sample_ratio), 1)
    off = 0.5 if aligned else 0.0
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale - off for i in range(1, 5))
    lo = 1e-6 if aligned else 1.0
    rw = torch.clamp_min(x2 - x1, lo)
    rh = torch.clamp_min(y2 - y1, lo)
    ys, xs = _roi_grid(x1, y1, rw, rh, PH, PW, sr, data.device)
    return _bilinear_sample(data[b], ys, xs).mean(dim=(-1, -2))


@register("ROIPooling")
def roi_pooling(data, rois, *, pooled_size=(7, 7), spatial_scale=1.0):
    """Max ROI pooling (``roi_pooling.cc``) over 4 x 4 bilinear samples a
    bin, as the reference computes it."""
    PH, PW = pooled_size
    b = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      for i in range(1, 5))
    rw = torch.clamp_min(x2 - x1 + 1, 1.0)
    rh = torch.clamp_min(y2 - y1 + 1, 1.0)
    sr = 4
    dev = data.device
    s = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5)[None, :]
    ar_h = torch.arange(PH, dtype=torch.float32, device=dev)[:, None]
    ar_w = torch.arange(PW, dtype=torch.float32, device=dev)[:, None]
    rh, rw = rh[:, None, None], rw[:, None, None]
    iy = y1[:, None, None] + ar_h * rh / PH + s * rh / (PH * sr)
    ix = x1[:, None, None] + ar_w * rw / PW + s * rw / (PW * sr)
    R = rois.shape[0]
    ys = iy[:, :, None, :, None].expand(R, PH, PW, sr, sr)
    xs = ix[:, None, :, None, :].expand(R, PH, PW, sr, sr)
    return _bilinear_sample(data[b], ys, xs).amax(dim=(-1, -2))


# ---------------------------------------------------------------------------
# multi-tensor helpers (multi_sum_sq.cc, all_finite.cc, reset_arrays.cc)
# ---------------------------------------------------------------------------
@register("multi_sum_sq", differentiable=False)
def multi_sum_sq(*arrays, num_arrays=0):
    """The f32 sum of squares of each array, stacked: (len(arrays),)."""
    return torch.stack([a.float().square().sum() for a in arrays])


@register("all_finite", differentiable=False)
def all_finite(data, *, init_output=True):
    return torch.isfinite(data).all().reshape(1)


@register("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays=0, init_output=True):
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.reshape(1)


@register("reset_arrays", differentiable=False)
def reset_arrays(*arrays, num_arrays=0):
    return tuple(torch.zeros_like(a) for a in arrays)


# ---------------------------------------------------------------------------
# FFT (fft.cc / ifft.cc): interleaved re/im on the last axis
# ---------------------------------------------------------------------------
@register("_contrib_fft", differentiable=False)
def contrib_fft(data, *, compute_size=128):
    """Real (..., d) -> interleaved re/im (..., 2d), in the input dtype."""
    out = torch.fft.fft(data.float(), dim=-1)
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        data.shape[:-1] + (2 * data.shape[-1],)).to(data.dtype)


@register("_contrib_ifft", differentiable=False)
def contrib_ifft(data, *, compute_size=128):
    """Interleaved re/im (..., 2d) -> the real part of the inverse FFT,
    times d (unnormalized, as the reference)."""
    d = data.shape[-1] // 2
    c = data.reshape(data.shape[:-1] + (d, 2)).float()
    comp = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(data.dtype) * d


# ---------------------------------------------------------------------------
# count_sketch.cc / hawkes_ll.cc
# ---------------------------------------------------------------------------
@register("_contrib_count_sketch", differentiable=False)
def count_sketch(data, h, s, *, out_dim=0, processing_batch_size=32):
    """out[b, h[i]] += s[i] * data[b, i]."""
    B, D = data.shape
    idx = h.reshape(-1).long()[:D]
    sign = s.reshape(-1)[:D]
    out = torch.zeros((B, out_dim), dtype=data.dtype, device=data.device)
    return out.index_add(1, idx, data * sign[None, :])


def hawkes_ll(lda, alpha, beta, state, lags, marks, valid_length, max_time):
    """Hawkes process log-likelihood (``hawkes_ll.cc``) as the reference
    computes it: a loop over the T steps, vectorized over the batch;
    (ll (B,), final state (B, K)). Its expressions broadcast as the
    reference's do: ``lda`` is added whole to the (B,) marked intensity,
    not at the mark (ROADMAP Queue 3)."""
    B, T = lags.shape
    K = lda.shape[-1]
    m = marks.long()
    rows = torch.arange(B, device=lags.device)
    rem = state if state is not None else torch.zeros(
        (B, K), dtype=lags.dtype, device=lags.device)
    ll = torch.zeros(B, dtype=lags.dtype, device=lags.device)
    alpha_b = alpha[None].expand(B, K)
    for t in range(T):
        mark = m[:, t]
        valid = t < valid_length
        rem = rem * torch.exp(-beta * lags[:, t, None])
        intensity = lda + torch.gather(rem, 1, mark[:, None])[:, 0] * \
            torch.gather(alpha_b, 1, mark[:, None])[:, 0]
        ll = ll + torch.where(valid, torch.log(torch.clamp_min(
            intensity, 1e-20)), torch.zeros((), dtype=lags.dtype,
                                            device=lags.device))
        rem = rem.index_put((rows, mark), torch.where(
            valid, 1.0, 0.0).to(rem.dtype), accumulate=True)
    if lda.dim() > 1:
        ll0 = -torch.sum(lda * max_time, dim=-1)
    else:
        ll0 = -lda.sum() * torch.ones(B, dtype=lda.dtype,
                                      device=lda.device) * max_time
    return ll + ll0, rem


register("_contrib_hawkes_ll")(hawkes_ll)


# ---------------------------------------------------------------------------
# the rest of the contrib ops
# ---------------------------------------------------------------------------
@register("_contrib_quadratic")
def quadratic(data, *, a=0.0, b=0.0, c=0.0):
    """a x^2 + b x + c (the tutorial op, ``quadratic_op.cc``)."""
    return a * data.square() + b * data + c


@register("_contrib_index_copy")
def index_copy(old, index, new):
    return old.index_copy(0, index.long(), new)


@register("_contrib_index_array", differentiable=False)
def index_array(data, *, axes=None):
    """The index of every element along ``axes`` (all by default):
    data.shape[axes] + (len(axes),), int32."""
    if axes is None:
        axes = tuple(range(data.dim()))
    grids = torch.meshgrid(*[torch.arange(data.shape[a], device=data.device)
                             for a in axes], indexing="ij")
    return torch.stack(grids, dim=-1).to(torch.int32)


@register("_contrib_getnnz", differentiable=False)
def getnnz(data, *, axis=None):
    return (data != 0).sum(dim=axis).to(torch.int32)


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradientmultiplier")
def gradient_multiplier(data, *, scalar=1.0):
    """The identity, its gradient multiplied by ``scalar``."""
    return _GradientMultiplier.apply(data, scalar)


@register("BatchNormWithReLU")
def batch_norm_with_relu(x, gamma, beta, moving_mean, moving_var, **attrs):
    """BatchNorm then ReLU (``batch_norm_relu.cc``): (out, new moving
    mean, new moving var)."""
    from .nn import batch_norm
    out, nm, nv = batch_norm(x, gamma, beta, moving_mean, moving_var,
                             **attrs)
    return torch.relu(out), nm, nv


@register("AdaptiveAvgPooling2D")
def adaptive_avg_pooling2d(data, *, output_size=1):
    """NCHW average pool onto an output grid; bin i of n over h spans
    [floor(i h / n), ceil((i + 1) h / n))."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    h, w = data.shape[2], data.shape[3]
    rows = []
    for i in range(oh):
        h0, h1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = [data[:, :, h0:h1, (j * w) // ow:-(-((j + 1) * w) // ow)]
                .mean(dim=(2, 3)) for j in range(ow)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@register("allclose", differentiable=False)
def allclose(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 or 0.0 (float32, shape ()) on the arrays' device, no host
    sync: every |a - b| <= atol + rtol |b|."""
    return torch.isclose(a, b, rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all().to(torch.float32)


@register("bipartite_matching", differentiable=False)
def bipartite_matching(dist, *, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching (``bipartite_matching.cc``): min(N, M)
    (or topk) rounds, each taking the best unmatched (row, col) pair of
    every batch row while it is at or past ``threshold``. Returns
    (row_assign, col_assign), float32, -1 where unmatched."""
    squeeze = dist.dim() == 2
    d = dist[None] if squeeze else dist
    b, n, m = d.shape
    sign = -1.0 if is_ascend else 1.0
    s = d * sign
    thr = threshold * sign
    iters = min(n, m) if topk < 0 else min(topk, n, m)
    dev = d.device
    row_asn = torch.full((b, n), -1.0, dtype=torch.float32, device=dev)
    col_asn = torch.full((b, m), -1.0, dtype=torch.float32, device=dev)
    ar_n = torch.arange(n, device=dev)
    ar_m = torch.arange(m, device=dev)
    for _ in range(iters):
        flat = torch.argmax(s.reshape(b, -1), dim=1)
        r, c = flat // m, flat % m
        best = torch.gather(s.reshape(b, -1), 1, flat[:, None])[:, 0]
        ok = best >= thr
        row_asn = torch.where(ok[:, None] & (ar_n[None] == r[:, None]),
                              c[:, None].to(row_asn.dtype), row_asn)
        col_asn = torch.where(ok[:, None] & (ar_m[None] == c[:, None]),
                              r[:, None].to(col_asn.dtype), col_asn)
        hit = ok[:, None, None] & ((ar_n[None, :, None] == r[:, None, None])
                                   | (ar_m[None, None, :] == c[:, None, None]))
        s = s.masked_fill(hit, -math.inf)
    if squeeze:
        return row_asn[0], col_asn[0]
    return row_asn, col_asn


# ---------------------------------------------------------------------------
# graph ops (dgl_graph.cc, edge_id.cc): CSR graphs as index arrays
# ---------------------------------------------------------------------------
@register("edge_id", differentiable=False)
def edge_id(indptr, indices, data, u, v):
    """The edge id (``data`` of the edge, float32) of each (u, v) pair of a
    CSR adjacency, -1 where absent."""
    ui, vi = u.long(), v.long()
    starts = indptr[ui].long()
    ends = indptr[ui + 1].long()
    idx = torch.arange(indices.shape[0], device=indices.device)
    inwin = (idx[None, :] >= starts[:, None]) & (idx[None, :] < ends[:, None])
    hit = inwin & (indices.long()[None, :] == vi[:, None])
    first = torch.argmax(hit.to(torch.int32), dim=1)
    return torch.where(hit.any(1), data[first].float(),
                       torch.full_like(first, -1, dtype=torch.float32))


@register("dgl_adjacency", differentiable=False)
def dgl_adjacency(indptr, indices):
    """Dense {0, 1} float32 adjacency (n, n) of a CSR graph."""
    n = indptr.shape[0] - 1
    ip = indptr.to(torch.int32).contiguous()
    idx = torch.arange(indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    row_of = torch.searchsorted(ip, idx, right=True) - 1
    out = torch.zeros((n, n), dtype=torch.float32, device=indices.device)
    out[row_of, indices.long()] = 1.0
    return out


def _host(a, dtype):
    return np.asarray(a.detach().cpu().numpy(), dtype=dtype)


def _sampled(picked, max_num_vertices, dev):
    picked = picked[:max_num_vertices]
    out = np.full((max_num_vertices,), -1, np.float32)
    out[:len(picked)] = picked
    return (torch.from_numpy(out).to(dev),
            torch.tensor([len(picked)], dtype=torch.float32, device=dev))


@register("dgl_csr_neighbor_uniform_sample", differentiable=False)
def dgl_csr_neighbor_uniform_sample(indptr, indices, seeds, *,
                                    num_neighbor=2, max_num_vertices=64,
                                    seed=0):
    """Uniform neighbor sampling on a CSR graph, on the host with
    ``numpy.random.RandomState(seed)`` (the reference's draws): the seeds
    then up to ``num_neighbor`` distinct neighbors of each, padded with -1
    to ``max_num_vertices``; and the count."""
    rng = np.random.RandomState(seed)
    ip, ind = _host(indptr, np.int64), _host(indices, np.int64)
    sds = _host(seeds, np.int64)
    picked = list(dict.fromkeys(sds.tolist()))
    for s in sds.tolist():
        nbrs = ind[ip[s]:ip[s + 1]]
        if len(nbrs) == 0:
            continue
        for nb in rng.choice(nbrs, size=min(num_neighbor, len(nbrs)),
                             replace=False):
            if nb not in picked:
                picked.append(int(nb))
    return _sampled(picked, max_num_vertices, indptr.device)


@register("dgl_csr_neighbor_non_uniform_sample", differentiable=False)
def dgl_csr_neighbor_non_uniform_sample(probability, indptr, indices, seeds,
                                        *, num_neighbor=2,
                                        max_num_vertices=64, seed=0):
    """Neighbor sampling with draw probabilities proportional to each
    vertex's ``probability``, on the host as the uniform sampler."""
    rng = np.random.RandomState(seed)
    prob = _host(probability, np.float64)
    ip, ind = _host(indptr, np.int64), _host(indices, np.int64)
    sds = _host(seeds, np.int64)
    picked = list(dict.fromkeys(sds.tolist()))
    for s in sds.tolist():
        nbrs = ind[ip[s]:ip[s + 1]]
        if len(nbrs) == 0:
            continue
        p = prob[nbrs]
        if p.sum() > 0:
            p = p / p.sum()
            k = min(num_neighbor, int((p > 0).sum()))
        else:
            p = None
            k = min(num_neighbor, len(nbrs))
        for nb in rng.choice(nbrs, size=k, replace=False, p=p):
            if nb not in picked:
                picked.append(int(nb))
    return _sampled(picked, max_num_vertices, indptr.device)


def _csr_out(dev, ip, ind, dat, extra=None):
    outs = (torch.tensor(np.asarray(ip, np.int32), device=dev),
            torch.tensor(np.asarray(ind, np.int32), device=dev),
            torch.tensor(np.asarray(dat, np.float32), device=dev))
    if extra is None:
        return outs
    return outs + (torch.tensor(np.asarray(extra, np.int32), device=dev),)


@register("dgl_subgraph", differentiable=False)
def dgl_subgraph(indptr, indices, data, vids, *, return_mapping=False):
    """The subgraph induced by ``vids`` (edges with both ends in it,
    vertices renumbered by their position in ``vids``), on the host:
    (indptr, indices, data[, edge ids]) as int32, int32, float32[, int32]."""
    ip, ind = _host(indptr, np.int64), _host(indices, np.int64)
    dat = _host(data, np.float64)
    vs = _host(vids, np.int64).reshape(-1)
    pos = {int(v): i for i, v in enumerate(vs)}
    new_ip, new_ind, new_dat, mapping = [0], [], [], []
    for v in vs:
        for eid in range(int(ip[v]), int(ip[v + 1])):
            dst = int(ind[eid])
            if dst in pos:
                new_ind.append(pos[dst])
                new_dat.append(dat[eid])
                mapping.append(eid)
        new_ip.append(len(new_ind))
    return _csr_out(indptr.device, new_ip, new_ind, new_dat,
                    mapping if return_mapping else None)


@register("dgl_graph_compact", differentiable=False)
def dgl_graph_compact(indptr, indices, data, *, graph_sizes=None,
                      return_mapping=False):
    """A padded sampled graph cut to its first ``graph_sizes`` vertices,
    edges to padding (negative or past the size) dropped, on the host."""
    ip, ind = _host(indptr, np.int64), _host(indices, np.int64)
    dat = _host(data, np.float64)
    n = len(ip) - 1
    size = min(n if graph_sizes is None else int(graph_sizes), n)
    new_ip, new_ind, new_dat = [0], [], []
    for v in range(size):
        for eid in range(int(ip[v]), int(ip[v + 1])):
            dst = int(ind[eid])
            if 0 <= dst < size:
                new_ind.append(dst)
                new_dat.append(dat[eid])
        new_ip.append(len(new_ind))
    return _csr_out(indptr.device, new_ip, new_ind, new_dat,
                    np.arange(size) if return_mapping else None)


# ---------------------------------------------------------------------------
# deformable convolution (deformable_convolution.cc) and the RPN Proposal
# (proposal.cc)
# ---------------------------------------------------------------------------
def bilinear_sample_nchw(img, py, px):
    """img (N, C, H, W) at fractional (py, px) of shape (N, P) -> (N, P, C),
    each of the four corners zero outside the image (the sampling of
    DeformableConvolution, RROIAlign and BilinearSampler)."""
    n, c, h, w = img.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy1 = py - y0
    wx1 = px - x0
    rows = torch.arange(n, device=img.device)[:, None]
    vals = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yy = y0 + dy
            xx = x0 + dx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yc = yy.clamp(0, h - 1).long()
            xc = xx.clamp(0, w - 1).long()
            g = img[rows, :, yc, xc]                          # (N, P, C)
            vals = vals + torch.where(inb[..., None], g, torch.zeros_like(
                g)) * (wy * wx)[..., None]
    return vals


@register("DeformableConvolution")
def deformable_convolution(data, offset, weight, bias=None, *, kernel,
                           num_filter, stride=(1, 1), dilate=(1, 1),
                           pad=(0, 0), num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=0, layout=None):
    """Deformable convolution v1: the input sampled bilinearly at the
    offset kernel points (offset (N, 2 kh kw groups, OH, OW), (y, x)
    pairs), then one product of the patches with the filter per group."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    n, c, h, w = data.shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw
    ndg = num_deformable_group
    dev = data.device
    oy = torch.arange(oh, device=dev) * sh - ph
    ox = torch.arange(ow, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = oy[None, :, None] + ky.repeat_interleave(kw)[:, None, None]
    base_x = ox[None, None, :] + kx.repeat(kh)[:, None, None]
    off = offset.reshape(n, ndg, k, 2, oh, ow)
    py = base_y[None, None] + off[:, :, :, 0]                  # (n,ndg,k,oh,ow)
    px = base_x[None, None] + off[:, :, :, 1]
    cg = c // ndg
    col = torch.cat([
        bilinear_sample_nchw(data[:, g * cg:(g + 1) * cg],
                             py[:, g].reshape(n, -1), px[:, g].reshape(n, -1))
        .reshape(n, k, oh * ow, cg).permute(0, 3, 1, 2) for g in range(ndg)],
        dim=1)                                                 # (n, c, k, P)
    fg = num_filter // num_group
    cgrp = c // num_group
    outs = [torch.einsum("fk,nkp->nfp",
                         weight[g * fg:(g + 1) * fg].reshape(fg, cgrp * k),
                         col[:, g * cgrp:(g + 1) * cgrp].reshape(
                             n, cgrp * k, oh * ow))
            for g in range(num_group)]
    out = torch.cat(outs, dim=1).reshape(n, num_filter, oh, ow)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register("Proposal", differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals (``proposal.cc``): anchors on the feature grid, the
    deltas decoded and clipped to the image, boxes under the scaled minimum
    size dropped, the ``rpn_pre_nms_top_n`` best by score (ties by the
    lower index), then ``rpn_post_nms_top_n`` rounds of greedy NMS (the
    best live box, then every box over ``threshold`` IoU with it dies).
    Returns rois (N * post, 5) rows [b, x1, y1, x2, y2] (and the scores)."""
    n, a2, fh, fw = cls_prob.shape
    na = a2 // 2
    dev = cls_prob.device
    base = float(feature_stride)
    anchors = []
    cxy = (base - 1) / 2
    for r in ratios:                    # f32 arithmetic, as the reference
        ws = torch.sqrt(_f32(base * base / r))
        hs = ws * r
        for s in scales:
            w2, h2 = ws * s / 2, hs * s / 2
            anchors.append(torch.stack([cxy - w2 + 0.5, cxy - h2 + 0.5,
                                        cxy + w2 - 0.5, cxy + h2 - 0.5]))
    base_anchors = torch.stack(anchors[:na]).to(dev)           # (na, 4)
    shift_x = torch.arange(fw, device=dev) * feature_stride
    shift_y = torch.arange(fh, device=dev) * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                          sy.reshape(-1)], dim=1).float()
    all_anchors = (base_anchors[None] + shifts[:, None]).reshape(-1, 4)

    scores = cls_prob[:, na:].permute(0, 2, 3, 1).reshape(n, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(n, -1, 4)
    aw = all_anchors[:, 2] - all_anchors[:, 0] + 1
    ah = all_anchors[:, 3] - all_anchors[:, 1] + 1
    acx = all_anchors[:, 0] + aw / 2
    acy = all_anchors[:, 1] + ah / 2
    px = deltas[..., 0] * aw + acx
    py = deltas[..., 1] * ah + acy
    pw = torch.exp(deltas[..., 2].clamp(-10, 10)) * aw
    ph = torch.exp(deltas[..., 3].clamp(-10, 10)) * ah
    imh, imw = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros((), dtype=px.dtype, device=dev)
    x1 = torch.minimum(torch.maximum(px - pw / 2, zero), imw - 1)
    y1 = torch.minimum(torch.maximum(py - ph / 2, zero), imh - 1)
    x2 = torch.minimum(torch.maximum(px + pw / 2, zero), imw - 1)
    y2 = torch.minimum(torch.maximum(py + ph / 2, zero), imh - 1)
    min_size = rpn_min_size * im_info[:, 2:3]
    keep = ((x2 - x1 + 1) >= min_size) & ((y2 - y1 + 1) >= min_size)
    scores = scores.masked_fill(~keep, -math.inf)

    pre = min(rpn_pre_nms_top_n, scores.shape[1])
    top_scores, order = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :pre], order[:, :pre]
    boxes = torch.stack([torch.gather(t, 1, order)
                         for t in (x1, y1, x2, y2)], dim=-1)   # (n, pre, 4)
    post = min(rpn_post_nms_top_n, pre)
    iou = _corner_iou(boxes, boxes)                            # (n, pre, pre)
    rows = torch.arange(n, device=dev)
    alive = top_scores > -math.inf
    sel = torch.full((n, post), -1, dtype=torch.long, device=dev)
    for i in range(post):
        cand = top_scores.masked_fill(~alive, -math.inf)
        j = torch.argmax(cand, dim=1)
        ok = cand[rows, j] > -math.inf
        sel[:, i] = torch.where(ok, j, torch.full_like(j, -1))
        alive = alive & (iou[rows, j] <= threshold) & ok[:, None]
        alive[rows, j] = False
    valid = sel >= 0
    selc = sel.clamp_min(0)
    rb = torch.gather(boxes, 1, selc[..., None].expand(n, post, 4))
    rb = torch.where(valid[..., None], rb, torch.zeros_like(rb))
    sb = torch.gather(top_scores, 1, selc)
    sb = torch.where(valid, sb, torch.zeros_like(sb))
    batch_col = rows.float()[:, None, None].expand(n, post, 1)
    rois = torch.cat([batch_col, rb], dim=2).reshape(n * post, 5)
    if output_score:
        return rois, sb.reshape(n * post, 1)
    return rois


# ---------------------------------------------------------------------------
# KL sparsity regularizer (identity_attach_KL_sparse_reg.cc)
# ---------------------------------------------------------------------------
class _KLSparseReg(torch.autograd.Function):
    """Identity; the backward adds the gradient of KL(target || rho_hat)
    per unit, broadcast over the batch."""

    @staticmethod
    def forward(ctx, x, rho_hat, target, penalty):
        ctx.save_for_backward(rho_hat)
        ctx.target, ctx.penalty = target, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        rho_hat, = ctx.saved_tensors
        t, p = (torch.tensor(v, dtype=torch.float32, device=rho_hat.device)
                for v in (ctx.target, ctx.penalty))
        grad_unit = p * (-(t / rho_hat) + (1 - t) / (1 - rho_hat))
        return g + grad_unit.expand_as(g), None, None, None


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, moving_avg=None, *,
                                  sparseness_target=0.1, penalty=0.001,
                                  momentum=0.9):
    """Identity forward whose backward adds the KL sparsity penalty
    gradient (sparse autoencoders); rho_hat is the moving average of each
    unit's mean activation. Returns (out, new_moving_avg), the write-back
    left to the caller."""
    batch_rho = data.mean(dim=0).clamp(1e-6, 1 - 1e-6)
    if moving_avg is None:
        rho_hat = new_avg = batch_rho
    else:
        new_avg = momentum * moving_avg + (1 - momentum) * batch_rho
        rho_hat = new_avg.clamp(1e-6, 1 - 1e-6)
    out = _KLSparseReg.apply(data, rho_hat.detach(), float(sparseness_target),
                             float(penalty))
    return out, new_avg.detach()


@register("_contrib_RROIAlign", differentiable=False)
def rroi_align(data, rois, *, pooled_size, spatial_scale, sampling_ratio=2):
    """Rotated ROIAlign (``rroi_align.cc``): rois (R, 6) rows [b, cx, cy,
    w, h, angle in degrees]; each bin the mean of a sampling_ratio^2 grid
    rotated by -theta (x = lx cos + ly sin + cx, y = ly cos - lx sin +
    cy), sampled with the corners zero outside the image."""
    ph, pw = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(pooled_size)
    sr = max(int(sampling_ratio), 1)
    R, c = rois.shape[0], data.shape[1]
    dev = data.device
    b = rois[:, 0].long()
    cx = rois[:, 1] * spatial_scale
    cy = rois[:, 2] * spatial_scale
    w = torch.clamp_min(rois[:, 3] * spatial_scale, 1.0)
    h = torch.clamp_min(rois[:, 4] * spatial_scale, 1.0)
    theta = rois[:, 5] * (math.pi / 180.0)
    gy, gx = torch.meshgrid(
        (torch.arange(ph * sr, dtype=torch.float32, device=dev) + 0.5)
        / (ph * sr) - 0.5,
        (torch.arange(pw * sr, dtype=torch.float32, device=dev) + 0.5)
        / (pw * sr) - 0.5, indexing="ij")
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    lx = gx[None] * w[:, None, None]
    ly = gy[None] * h[:, None, None]
    px = cx[:, None, None] + lx * cos_t + ly * sin_t
    py = cy[:, None, None] - lx * sin_t + ly * cos_t
    got = bilinear_sample_nchw(data[b], py.reshape(R, -1), px.reshape(R, -1))
    return got.reshape(R, ph, sr, pw, sr, c).mean(dim=(2, 4)) \
        .permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# straight-through estimators (stes_op.cc)
# ---------------------------------------------------------------------------
class _STE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@register("_contrib_round_ste")
def round_ste(data):
    """round(x) forward, the identity's gradient."""
    return _STE.apply(data, torch.round)


@register("_contrib_sign_ste")
def sign_ste(data):
    """sign(x) forward, the identity's gradient."""
    return _STE.apply(data, torch.sign)


@register("_npx_constraint_check", differentiable=False)
def constraint_check(data, *, msg="Constraint violated."):
    """True (a 0-d bool) if every element is nonzero; raises
    MXNetError(msg) otherwise (one host sync)."""
    ok = (data != 0).all()
    if not bool(ok):
        raise MXNetError(str(msg))
    return ok


@register("_contrib_mrcnn_mask_target", differentiable=False)
def mrcnn_mask_target(rois, gt_masks, matches, cls_targets, *, num_rois=0,
                      num_classes=0, mask_size=(14, 14), sample_ratio=2,
                      aligned=False):
    """Mask R-CNN targets: each roi's matched mask ROIAlign-sampled into
    mask_size, and the one-hot class weights. rois (B, N, 4) corners,
    gt_masks (B, M, H, W), matches (B, N), cls_targets (B, N) -> two
    (B, N, C, MH, MW)."""
    MH, MW = mask_size
    if int(num_classes) <= 0:
        raise ValueError("mrcnn_mask_target requires num_classes > 0 "
                         "(static attribute; it sets the output shape)")
    C = int(num_classes)
    sr = max(int(sample_ratio), 1)
    off = 0.5 if aligned else 0.0
    B, N = rois.shape[:2]
    r = rois.reshape(B * N, 4) - off
    x1, y1 = r[:, 0], r[:, 1]
    rw, rh = r[:, 2] - x1, r[:, 3] - y1
    if not aligned:
        rw, rh = rw.clamp_min(1.0), rh.clamp_min(1.0)
    ys, xs = _roi_grid(x1, y1, rw, rh, MH, MW, sr, rois.device)
    masks = torch.gather(gt_masks, 1, matches.long()[..., None, None].expand(
        B, N, *gt_masks.shape[2:]))                            # (B, N, H, W)
    got = _bilinear_sample(masks.reshape(B * N, 1, *gt_masks.shape[2:]),
                           ys, xs).mean(dim=(-1, -2))          # (BN, 1, MH, MW)
    sampled = got.reshape(B, N, 1, MH, MW)
    mask_targets = sampled.expand(B, N, C, MH, MW).contiguous()
    onehot = (cls_targets[..., None] == torch.arange(
        C, device=rois.device)).to(gt_masks.dtype)
    mask_cls = onehot[..., None, None].expand(B, N, C, MH, MW).contiguous()
    return mask_targets, mask_cls


register("_contrib_hawkesll")(hawkes_ll)
