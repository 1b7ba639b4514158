"""Shape, indexing, ordering and linear-algebra operators of the port (the
counterpart of ``mxnet_tpu/ops/tensor.py``), plain PyTorch functions over
tensors under the JAX package's names.

Semantics kept from the reference where PyTorch's differ: indices arrive
in any numeric dtype and are truncated to integers; negative indices count
from the end as numpy's do (``take`` instead clips or wraps, by ``mode``);
ordering ops return float32 indices unless ``dtype`` says otherwise, and
break ties by position (a stable sort; ``topk`` keeps the lower index
first, as ``lax.top_k``). ``unique`` has a data-dependent size, so it
waits for the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import DTypes
from .registry import register


def _long(idx):
    """Integer positions from an index array of any dtype (floats are
    truncated toward zero, as ``astype(int32)``)."""
    return idx if idx.dtype == torch.int64 else idx.to(torch.int32).long()


def _wrap_negative(idx, n):
    return torch.where(idx < 0, idx + n, idx)


def _axis(x, axis):
    return axis % max(x.dim(), 1)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
def reshape_codes(src, shape):
    """The target shape of a reshape with the reference's codes: 0 copies
    a dimension, -1 infers one, -2 copies the rest, -3 merges two, -4
    splits one into the next two values (``matrix_op.cc`` Reshape)."""
    shape = tuple(shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return shape
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            a = src[i] // b if a == -1 else a
            b = src[i] // a if b == -1 else b
            out.extend([a, b])
            i += 1
            j += 2
        else:                      # a size, or -1 (inferred)
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


@register("reshape")
def reshape(x, *, shape, reverse=False):
    """Reshape with the reference's special codes (``reshape_codes``)."""
    return x.reshape(reshape_codes(x.shape, shape))


@register("transpose")
def transpose(x, *, axes=None):
    axes = tuple(axes) if axes else tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@register("swapaxes")
def swapaxes(x, *, dim1=0, dim2=1):
    return x.transpose(dim1, dim2)


@register("flatten")
def flatten(x):
    """Collapse all but the first axis (``matrix_op.cc`` Flatten)."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:]))


@register("expand_dims")
def expand_dims(x, *, axis):
    return x.unsqueeze(axis)


@register("squeeze")
def squeeze(x, *, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("broadcast_to")
def broadcast_to(x, *, shape):
    shape = tuple(shape)
    if len(shape) == x.dim():           # 0 keeps the dimension
        shape = tuple(d if s == 0 else s for s, d in zip(shape, x.shape))
    return x.expand(shape)


@register("broadcast_axis")
def broadcast_axis(x, *, axis, size):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return x.expand(tuple(shape))


@register("concat")
def concat(*arrays, dim=1):
    return torch.cat(arrays, dim=dim)


@register("stack")
def stack(*arrays, axis=0):
    return torch.stack(arrays, dim=axis)


def _equal_parts(x, n, axis):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {size} into {n}")
    return torch.split(x, size // n, dim=axis) if size else \
        tuple(x for _ in range(n))


@register("split")
def split(x, *, num_outputs, axis=1, squeeze_axis=False):
    parts = _equal_parts(x, num_outputs, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("split_v2")
def split_v2(x, *, indices_or_sections, axis=0, squeeze_axis=False):
    if isinstance(indices_or_sections, (list, tuple)):
        parts = torch.tensor_split(x, list(indices_or_sections), dim=axis)
    else:
        parts = _equal_parts(x, indices_or_sections, axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _slice_dim(x, dim, sl):
    """``x[..., sl, ...]`` on ``dim``; a negative step by an index."""
    if sl.step is None or sl.step > 0:
        return x[(slice(None),) * dim + (sl,)]
    idx = torch.arange(*sl.indices(x.shape[dim]), device=x.device)
    return x.index_select(dim, idx)


def _slices(begin, end, step):
    step = step or (None,) * len(begin)
    return [slice(b, e, step[i] if i < len(step) else None)
            for i, (b, e) in enumerate(zip(begin, end))]


def _sliced(x, slices):
    for d, sl in enumerate(slices):
        x = _slice_dim(x, d, sl)
    return x


@register("slice")
def slice_op(x, *, begin, end, step=None):
    return _sliced(x, _slices(begin, end, step))


@register("slice_axis")
def slice_axis(x, *, axis, begin, end):
    if end is None or end == 0 and begin > 0:
        end = x.shape[axis]
    return _slice_dim(x, _axis(x, axis), slice(begin, end))


@register("slice_like")
def slice_like(x, shape_like, *, axes=None):
    axes = range(x.dim()) if not axes else axes
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return x[tuple(idx)]


def _index_key(key):
    """An NDArray-style key for a tensor: index arrays become int64
    (float index arrays gather too), bool masks stay bool."""
    def conv(k):
        if isinstance(k, torch.Tensor) and k.dtype != torch.bool:
            return _long(k)
        return k
    return tuple(conv(k) for k in key) if isinstance(key, tuple) \
        else conv(key)


@register("_getitem")
def _getitem(x, *, key):
    return x[_index_key(key)]


@register("reverse")
def reverse(x, *, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, dims=axes)


@register("tile")
def tile(x, *, reps):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register("repeat")
def repeat(x, *, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Positions along one axis after edge/reflect padding."""
    return torch.from_numpy(np.pad(np.arange(n), (lo, hi), mode=mode)) \
        .to(device)


@register("pad")
def pad(x, *, mode="constant", pad_width=None, constant_value=0.0):
    """Pad (``pad.cc``): ``pad_width`` the flat (before, after) pairs of
    every axis; mode constant, edge or reflect."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1]) for i in range(x.dim())]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]
        return F.pad(x, flat, value=constant_value)
    np_mode = {"edge": "edge", "reflect": "reflect"}[mode]
    for d, (lo, hi) in enumerate(pw):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, np_mode,
                                             x.device))
    return x


@register("depth_to_space")
def depth_to_space(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def diag(x, *, k=0):
    if x.dim() <= 2:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


@register("shape_array", differentiable=False)
def shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register("size_array", differentiable=False)
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register("where")
def where(cond, a, b):
    return torch.where(cond.bool(), a, b)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------
@register("take")
def take(x, indices, *, axis=0, mode="clip"):
    """Gather along ``axis`` (``indexing_op.cc`` Take); out-of-range
    indices clip or wrap by ``mode``."""
    axis = _axis(x, axis)
    n = x.shape[axis]
    idx = _long(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + indices.shape + x.shape[axis + 1:])


@register("batch_take")
def batch_take(x, indices):
    idx = _wrap_negative(_long(indices), x.shape[1])
    return torch.gather(x, 1, idx[:, None])[:, 0]


@register("take_along_axis")
def take_along_axis(x, indices, *, axis=0):
    """``np.take_along_axis``: indices broadcast against ``x`` off the
    axis."""
    axis = _axis(x, axis)
    idx = _wrap_negative(_long(indices), x.shape[axis])
    shape = list(torch.broadcast_shapes(
        tuple(1 if d == axis else s for d, s in enumerate(x.shape)),
        tuple(1 if d == axis else s for d, s in enumerate(idx.shape))))
    xs, is_ = list(shape), list(shape)
    xs[axis], is_[axis] = x.shape[axis], idx.shape[axis]
    return torch.gather(x.expand(xs), axis, idx.expand(is_))


@register("pick")
def pick(x, indices, *, axis=-1, keepdims=False, mode="clip"):
    """``x`` at ``indices`` along ``axis``; ``indices`` has x's shape
    without the axis, any numeric dtype (``mode`` is accepted and, as in
    the reference, not used)."""
    axis = _axis(x, axis)
    out = take_along_axis(x, indices.unsqueeze(axis), axis=axis)
    return out if keepdims else out.squeeze(axis)


def _nd_index(indices):
    idx = _long(indices)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd")
def gather_nd(x, indices):
    """``indices`` (M, ...) index the first M dimensions of ``x``."""
    return x[_nd_index(indices)]


@register("scatter_nd")
def scatter_nd(data, indices, *, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, data, indices, *, shape=None):
    return lhs.index_put(_nd_index(indices), data)


@register("index_add")
def index_add(lhs, data, indices):
    """lhs with ``data`` added at ``indices``; repeated indices add up
    (on the card in no fixed order)."""
    return lhs.index_put(_nd_index(indices), data, accumulate=True)


@register("index_copy")
def index_copy(old, idx, new):
    return old.index_put((_long(idx),), new)


@register("one_hot", differentiable=False)
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """Rows of ``depth``; an index outside [0, depth) gives a row of
    ``off_value``."""
    pos = torch.arange(depth, device=indices.device)
    oh = (_long(indices).unsqueeze(-1) == pos).to(DTypes.torch(dtype))
    return oh * (on_value - off_value) + off_value


@register("boolean_mask_dense")
def boolean_mask_dense(data, mask, *, axis=0):
    """Rows of ``data`` whose mask is 0 set to 0 (the dense form of
    ``boolean_mask``)."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return data * mask.to(data.dtype).reshape(shape)


@register("sequence_mask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """SequenceMask (``sequence_mask.cc``): data is (seq, batch, ...) when
    axis=0 or (batch, seq, ...) when axis=1; positions at or past each
    row's length become ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    seq_axis, batch_axis = (0, 1) if axis == 0 else (1, 0)
    shape = [1] * data.dim()
    shape[seq_axis] = data.shape[seq_axis]
    pos = torch.arange(data.shape[seq_axis], device=data.device) \
        .reshape(shape)
    sl_shape = [1] * data.dim()
    sl_shape[batch_axis] = data.shape[batch_axis]
    sl = _long(sequence_length).reshape(sl_shape)
    return torch.where(pos < sl, data,
                       torch.tensor(value, dtype=data.dtype,
                                    device=data.device))


@register("sequence_last")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    d = data.movedim(axis, 0)                        # (seq, batch, ...)
    idx = (_long(sequence_length) - 1).reshape(
        (1, -1) + (1,) * (d.dim() - 2))
    return take_along_axis(d, idx, axis=0)[0]


@register("sequence_reverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    d = data.movedim(axis, 0)
    pos = torch.arange(d.shape[0], device=data.device)[:, None]
    sl = _long(sequence_length)[None, :]
    rev = torch.where(pos < sl, sl - 1 - pos, pos)
    out = take_along_axis(d, rev.reshape(rev.shape + (1,) * (d.dim() - 2)),
                          axis=0)
    return out.movedim(0, axis)


# ---------------------------------------------------------------------------
# ordering: stable sorts, so equal values keep their order
# ---------------------------------------------------------------------------
@register("sort")
def sort(x, *, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort", differentiable=False)
def argsort(x, *, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(DTypes.torch(dtype))


@register("topk", differentiable=False)
def topk(x, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (``is_ascend``: smallest) along ``axis``, ties by the
    lower index first (``lax.top_k``)."""
    xm = x.movedim(axis, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=not is_ascend, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(xm).scatter(-1, idx, 1)
        return mask.movedim(-1, axis)
    vals = vals.movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(DTypes.torch(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    if ret_typ == "both":
        return vals, idx
    raise ValueError(ret_typ)


@register("unique", differentiable=False)
def unique(x):
    """The sorted distinct values, padded to x.size with x's last element
    (the reference's fixed-size form)."""
    flat = x.reshape(-1)
    u = torch.unique(flat, sorted=True)
    return torch.cat([u, flat[-1:].expand(flat.numel() - u.numel())])


# ---------------------------------------------------------------------------
# init / ranges
# ---------------------------------------------------------------------------
@register("arange_like", differentiable=False)
def arange_like(x, *, start=0.0, step=1.0, repeat=1, axis=None):
    if axis is None:
        out = start + step * torch.arange(x.numel(), dtype=x.dtype,
                                          device=x.device)
        return out.reshape(x.shape)
    return start + step * torch.arange(x.shape[axis], dtype=x.dtype,
                                       device=x.device)


# ---------------------------------------------------------------------------
# products and linear algebra
# ---------------------------------------------------------------------------
@register("einsum")
def einsum(*operands, subscripts):
    return torch.einsum(subscripts, *operands)


def _t(a, flag):
    return a.transpose(-1, -2) if flag and a.dim() >= 2 else a


@register("dot")
def dot(a, b, *, transpose_a=False, transpose_b=False):
    """The product over a's last and b's first axis (``dot-inl.h``)."""
    a, b = _t(a, transpose_a), _t(b, transpose_b)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(a, b, *, transpose_a=False, transpose_b=False):
    return torch.matmul(_t(a, transpose_a), _t(b, transpose_b))


@register("matmul")
def matmul(a, b):
    return torch.matmul(a, b)


@register("khatri_rao")
def khatri_rao(*arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = (out[:, None, :] * a[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("linalg_gemm2")
def linalg_gemm2(a, b, *, transpose_a=False, transpose_b=False, alpha=1.0):
    return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b))


@register("linalg_gemm")
def linalg_gemm(a, b, c, *, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b)) \
        + beta * c


@register("linalg_potrf")
def linalg_potrf(a):
    return torch.linalg.cholesky(a)


@register("linalg_trsm")
def linalg_trsm(a, b, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Solve op(A) X = alpha B (X op(A) = alpha B with ``rightside``). As
    in the reference, ``transpose`` is not applied on the right side."""
    if rightside:
        xt = torch.linalg.solve_triangular(a.mT, (alpha * b).mT, upper=lower)
        return xt.mT
    if transpose:
        return torch.linalg.solve_triangular(a.mT, alpha * b, upper=lower)
    return torch.linalg.solve_triangular(a, alpha * b, upper=not lower)


@register("linalg_trmm")
def linalg_trmm(a, b, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    tri = torch.tril(a) if lower else torch.triu(a)
    if transpose:
        tri = tri.mT
    return alpha * (torch.matmul(b, tri) if rightside
                    else torch.matmul(tri, b))


@register("linalg_syrk")
def linalg_syrk(a, *, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(a.mT, a) if transpose
                    else torch.matmul(a, a.mT))


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(a, *, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(a, *, offset=0):
    """Vectors to diagonal matrices; batched input takes offset 0 only,
    as the reference's."""
    if a.dim() == 1:
        return torch.diag(a, offset)
    n = a.shape[-1]
    return torch.diag_embed(a).reshape(a.shape[:-1] + (n + abs(offset),) * 2)


@register("linalg_svd")
def linalg_svd(a):
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    return u, s, vt


@register("linalg_inverse")
def linalg_inverse(a):
    return torch.linalg.inv(a)


@register("linalg_det")
def linalg_det(a):
    return torch.linalg.det(a)


@register("linalg_slogdet")
def linalg_slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register("linalg_potri")
def linalg_potri(a):
    """Inverse of the SPD matrix whose Cholesky factor is ``a``, by two
    triangular solves."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) \
        .expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return torch.matmul(linv.mT, linv)


@register("linalg_syevd")
def linalg_syevd(a):
    """Symmetric eigendecomposition: (U, L) with the rows of U the
    eigenvectors (a = U^T diag(L) U)."""
    w, v = torch.linalg.eigh(a)
    return v.mT, w


@register("linalg_gelqf")
def linalg_gelqf(a):
    """LQ factorization of a wide matrix: a = L Q, the QR of a^T."""
    q, r = torch.linalg.qr(a.mT, mode="reduced")
    return r.mT, q.mT


def _tri_indices(n, offset, lower, device):
    f = torch.tril_indices if lower else torch.triu_indices
    return f(n, n, offset, device=device)


@register("linalg_extracttrian")
def linalg_extracttrian(a, *, offset=0, lower=True):
    rows, cols = _tri_indices(a.shape[-1], offset, lower, a.device)
    return a[..., rows, cols]


@register("linalg_maketrian")
def linalg_maketrian(a, *, offset=0, lower=True):
    m = a.shape[-1]
    s = int(round((-1 + (1 + 8 * m) ** 0.5) / 2))
    n = s + abs(offset)
    rows, cols = _tri_indices(n, offset, lower, a.device)
    out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    out[..., rows, cols] = a
    return out


# ---------------------------------------------------------------------------
# histogram, broadcast/reshape-like, ravel, slice assignment, im2col
# ---------------------------------------------------------------------------
@register("histogram", differentiable=False)
def histogram(data, bins=None, *, bin_cnt=None, range=None):
    """Counts (int32) and edges: explicit ``bins`` edges, or ``bin_cnt``
    equal bins over ``range``; the last bin is closed, values outside are
    not counted (``np.histogram``)."""
    if bins is not None:
        edges = bins
    else:
        edges = torch.linspace(float(range[0]), float(range[1]),
                               int(bin_cnt) + 1, device=data.device)
    x = data.reshape(-1).to(edges.dtype)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    counts = torch.bincount(idx, minlength=edges.numel() + 1)
    return counts[1:edges.numel()].to(torch.int32), edges


@register("broadcast_like")
def broadcast_like(lhs, rhs, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    target = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        target[la % lhs.dim()] = rhs.shape[ra % rhs.dim()]
    return lhs.expand(tuple(target))


@register("reshape_like")
def reshape_like(lhs, rhs, *, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    lb = 0 if lhs_begin is None else lhs_begin % (lhs.dim() + 1)
    le = lhs.dim() if lhs_end is None else lhs_end % (lhs.dim() + 1)
    rb = 0 if rhs_begin is None else rhs_begin % (rhs.dim() + 1)
    re_ = rhs.dim() if rhs_end is None else rhs_end % (rhs.dim() + 1)
    return lhs.reshape(lhs.shape[:lb] + rhs.shape[rb:re_] + lhs.shape[le:])


@register("ravel_multi_index", differentiable=False)
def ravel_multi_index(data, *, shape):
    """(ndim, N) coordinates to flat indices (``ravel.cc``)."""
    flat, stride = 0, 1
    for i in reversed(list(range(len(shape)))):
        flat = flat + data[i].to(torch.int32) * stride
        stride *= shape[i]
    return flat.to(data.dtype)


@register("unravel_index", differentiable=False)
def unravel_index(data, *, shape):
    """Flat indices to (ndim, N) coordinates."""
    idx = data.to(torch.int32)
    coords = []
    for s in reversed(list(shape)):
        coords.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack([c.to(data.dtype) for c in reversed(coords)])


def _slice_positions(shape, begin, end, step, device):
    pos = torch.arange(math.prod(shape), device=device).reshape(shape)
    return _sliced(pos, _slices(begin, end, step))


@register("slice_assign")
def slice_assign(lhs, rhs, *, begin, end, step=None):
    """lhs with ``rhs`` written into lhs[begin:end:step]."""
    pos = _slice_positions(lhs.shape, begin, end, step, lhs.device)
    out = lhs.reshape(-1).index_put((pos.reshape(-1),),
                                    rhs.to(lhs.dtype).expand(pos.shape)
                                    .reshape(-1))
    return out.reshape(lhs.shape)


@register("slice_assign_scalar")
def slice_assign_scalar(lhs, *, scalar, begin, end, step=None):
    pos = _slice_positions(lhs.shape, begin, end, step, lhs.device)
    value = torch.tensor(scalar, dtype=lhs.dtype, device=lhs.device)
    return lhs.reshape(-1).index_put((pos.reshape(-1),), value) \
        .reshape(lhs.shape)


def _pairs(v, default):
    return tuple(v) if v else (default, default)


@register("im2col")
def im2col(data, *, kernel, stride=None, dilate=None, pad=None):
    """NCHW patches as (N, C * kh * kw, L), channel-major (``im2col.h``)."""
    return F.unfold(data, tuple(kernel), dilation=_pairs(dilate, 1),
                    padding=_pairs(pad, 0), stride=_pairs(stride, 1))


@register("col2im")
def col2im(data, *, output_size, kernel, stride=None, dilate=None, pad=None):
    """The adjoint of ``im2col``: patches summed back into an image."""
    return F.fold(data, tuple(output_size), tuple(kernel),
                  dilation=_pairs(dilate, 1), padding=_pairs(pad, 0),
                  stride=_pairs(stride, 1))


@register("BlockGrad")
def BlockGrad(x):
    """Identity forward, zero gradient (``stop_gradient``)."""
    return x.detach()
