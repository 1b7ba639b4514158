"""Automatic mixed precision of the port (the counterpart of
``mxnet_tpu/amp/__init__.py``).

One cast-policy point, :func:`apply`, runs every op whose dtype AMP
decides: ``ops.registry.invoke`` (every ``nd`` call and NDArray method)
and the Gluon layers, which call their ops on tensors, reach it with the
op's registered name, as the reference's layers reach ``amp_invoke``
through ``F.<op>``. Inside an op's body nothing is cast: ops call each
other as plain functions. The active policy is the innermost
block-scoped one (:func:`convert_hybrid_block` attaches it to a block,
which pushes it around its forward), else the global one of
:func:`init`, else none: then :func:`apply` only runs the op.

The policy, as the reference's: an op of ``CONDITIONAL_FP32_OPS`` whose
attribute takes a listed value runs in float32; an op of
``TARGET_DTYPE_OPS`` has its floating inputs cast to the target dtype
(bf16 or fp16); one of ``FP32_OPS`` to float32; any other passes its
inputs through. Only positional tensors are cast (the reference casts
the NDArray inputs, not the attributes). The casts are recorded by
autograd, so a cast parameter gets its gradient in its own dtype (the
reference's cast builds a new, untaped array, and the gradient stops
there: ROADMAP Queue 3).

:func:`init_trainer`, :class:`scale_loss` and :func:`unscale` are the
dynamic loss scaling of fp16 training (:class:`LossScaler`).
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale", "convert_model",
           "convert_hybrid_block", "apply", "call", "lists", "LossScaler"]

_AMP_STATE = {"on": False, "target_dtype": "bfloat16", "scaler": None,
              "config": None}
_TARGETS = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_CFG_TLS = threading.local()


class _AmpConfig:
    """A resolved cast policy: the target and fp32 op sets, the
    conditional-fp32 rules and the target dtype."""

    __slots__ = ("low", "high", "cond", "dtype")

    def __init__(self, low, high, cond, target_dtype):
        self.low = set(low)
        self.high = set(high)
        # {op: (attribute, values)}: fp32 only when the value matches
        self.cond = {op: (attr, set(vals)) for op, attr, vals in cond}
        self.dtype = _TARGETS[target_dtype]

    def cast(self, name, tensors, attrs):
        """``tensors`` as the op ``name`` takes them under this policy."""
        if name in self.cond:
            attr, vals = self.cond[name]
            if str(attrs.get(attr)) in vals:
                return _cast_all(tensors, torch.float32)
        if name in self.low:
            return _cast_all(tensors, self.dtype, keep_sparse=(
                name == "_contrib_SparseEmbedding" or
                bool(attrs.get("sparse_grad"))))
        if name in self.high:
            return _cast_all(tensors, torch.float32)
        return tensors


class _SparseSafeCast(torch.autograd.Function):
    """``t.to(dtype)`` whose backward casts a sparse gradient back and
    keeps it sparse (the backward of ``Tensor.to`` refuses one): the cast
    of a ``sparse_grad`` Embedding's weight."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.src = t.dtype
        return t.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.src), None


def _cast_all(tensors, dtype, keep_sparse=False):
    cast = (lambda t: _SparseSafeCast.apply(t, dtype)) if keep_sparse \
        else (lambda t: t.to(dtype))
    return [cast(t) if isinstance(t, torch.Tensor)
            and t.is_floating_point() and t.dtype != dtype else t
            for t in tensors]


def _canonical(target_dtype):
    name = str(target_dtype).replace("torch.", "")
    if name not in _TARGETS:
        raise MXNetError("target_dtype must be float16 or bfloat16")
    return name


def _push_cfg(cfg):
    stack = getattr(_CFG_TLS, "stack", None)
    if stack is None:
        stack = _CFG_TLS.stack = []
    stack.append(cfg)


def _pop_cfg():
    _CFG_TLS.stack.pop()


def _active_cfg():
    stack = getattr(_CFG_TLS, "stack", None)
    if stack:
        return stack[-1]   # a block-scoped policy comes first
    return _AMP_STATE["config"] if _AMP_STATE["on"] else None


def apply(name, fn, tensors, attrs):
    """The cast-policy point: ``fn(*tensors, **attrs)``, the op registered
    as ``name``, with its tensors cast as the active policy says."""
    cfg = _active_cfg()
    if cfg is not None:
        tensors = cfg.cast(name, tensors, attrs)
    return fn(*tensors, **attrs)


_OPS = None


def call(name, *tensors, **attrs):
    """Run the registered op ``name`` on tensors through :func:`apply`:
    how a Gluon layer calls its ops."""
    global _OPS
    if _OPS is None:
        from ..ops.registry import _OPS
    return apply(name, _OPS[name].fn, tensors, attrs)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for every op from now on: TARGET_DTYPE_OPS in
    ``target_dtype`` (bf16 or fp16), FP32_OPS in float32."""
    target_dtype = _canonical(target_dtype)
    _AMP_STATE["config"] = _AmpConfig(
        target_precision_ops or lists.TARGET_DTYPE_OPS,
        fp32_ops or lists.FP32_OPS,
        conditional_fp32_ops or lists.CONDITIONAL_FP32_OPS, target_dtype)
    _AMP_STATE["target_dtype"] = target_dtype
    _AMP_STATE["on"] = True


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a Trainer."""
    scaler = LossScaler()
    _AMP_STATE["scaler"] = scaler
    trainer._amp_loss_scaler = scaler
    return trainer


class scale_loss:
    """``with scale_loss(loss, trainer) as scaled:`` the loss (or list of
    losses) times the trainer's loss scale (1 without a scaler)."""

    def __init__(self, loss, trainer):
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        scale = scaler.loss_scale if scaler else 1.0
        if isinstance(loss, (list, tuple)):
            self._scaled = [l * scale for l in loss]
        else:
            self._scaled = loss * scale

    def __enter__(self):
        return self._scaled

    def __exit__(self, *exc):
        return False


def unscale(trainer):
    """Divide every gradient of the trainer's parameters by the loss scale
    (a row-sparse gradient's stored rows)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        if p.grad_req != "null" and p._var is not None:
            for g in p.list_grad():
                g._data = g._data * inv


def convert_model(net, target_dtype="bfloat16"):
    """Cast a model for reduced-precision inference."""
    return convert_hybrid_block(net, target_dtype)


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None,
                         excluded_sym_names=None, ctx=None):
    """Cast the block's parameters to ``target_dtype`` (BatchNorm's stay
    float32) and attach the cast policy to it (``_amp_cfg``): its forward
    runs under the policy, whether or not AMP is on globally."""
    target_dtype = _canonical(target_dtype)
    block.cast(target_dtype)
    block._amp_cfg = _AmpConfig(
        target_dtype_ops or lists.TARGET_DTYPE_OPS,
        fp32_ops or lists.FP32_OPS,
        conditional_fp32_ops or lists.CONDITIONAL_FP32_OPS, target_dtype)
    return block
