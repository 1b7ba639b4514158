"""Imperative autograd over NDArrays, on PyTorch's autograd engine.

The counterpart of ``mxnet_tpu/autograd.py``. MXNet's semantics are kept
where they differ from PyTorch's defaults:

- a graph is built only inside :func:`record`; outside it (and inside
  :func:`pause`) NDArray operations run without one;
- ``train_mode`` is a flag of its own, apart from recording;
- ``attach_grad``/:func:`mark_variables` give an array a gradient NDArray
  that ``grad_req="write"`` overwrites on every backward and ``"add"``
  accumulates into (PyTorch always accumulates into ``.grad``: a
  post-accumulate hook moves it over and clears the leaf's own ``.grad``);
- a head that is not a scalar gets a head gradient of ones;
- the weight of an Embedding with ``sparse_grad=True`` gets a row-sparse
  gradient: PyTorch's sparse COO gradient, stored as a
  ``RowSparseNDArray`` (rows summed by id) in a row-sparse buffer and
  returned as one by :func:`grad`;
- :class:`Function` runs the user's NDArray-level ``forward`` under
  :func:`pause` and their ``backward`` with NDArray gradients, through a
  ``torch.autograd.Function``.

The recording and training flags are per thread, as in the reference.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_record: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(is_record)
    return prev


def set_training(train: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(train)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record: Optional[bool], train: Optional[bool]):
        self._enter_record = is_record
        self._enter_train = train
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._enter_record is not None:
            _STATE.recording = self._enter_record
        if self._enter_train is not None:
            _STATE.training = self._enter_train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev
        return False


def record(train_mode: bool = True):
    """Scope in which NDArray operations are recorded for backward."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope in which nothing is recorded, inside a :func:`record`."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Give each array the gradient buffer ``gradients[i]``, written by
    backward according to ``grad_reqs[i]`` ("write", "add" or "null")."""
    from .ndarray.ndarray import _grad_hook
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, gradient, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be 'write', 'add' or 'null', "
                             f"got {req!r}")
        var._grad, var._grad_req = gradient, req
        t = var._data.detach()
        if req != "null" and t.is_floating_point():
            t.requires_grad_(True)
            t.register_post_accumulate_grad_hook(_grad_hook(weakref.ref(var)))
        var._data = t


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            raise MXNetError("cannot differentiate a head that was not "
                             "recorded")
        outs.append(h._data)
        grads.append(torch.ones_like(h._data) if hg is None
                     else hg._data.to(h._data.dtype))
    return outs, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backward from ``heads``: each attached array's gradient buffer is
    written or added to by its ``grad_req``."""
    outs, grads = _heads(heads, head_grads)
    torch.autograd.backward(outs, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    NDArrays; no gradient buffer is touched. With ``create_graph`` the
    result can be differentiated again."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, grads = _heads(heads, head_grads)
    retain = create_graph if retain_graph is None else retain_graph
    with torch.set_grad_enabled(create_graph):
        got = torch.autograd.grad(outs, [v._data for v in variables], grads,
                                  retain_graph=retain,
                                  create_graph=create_graph,
                                  allow_unused=True)
    if any(g is None for g in got):
        raise MXNetError("one of the variables is unreachable from heads")
    res = [_grad_array(g, v) for g, v in zip(got, variables)]
    return res[0] if single else res


def _grad_array(g, v):
    """A gradient as :func:`grad` returns it: a ``RowSparseNDArray`` for
    the sparse gradient of a ``sparse_grad`` Embedding's weight, else an
    NDArray."""
    from .ndarray.ndarray import NDArray
    if g.is_sparse:
        from .sparse import from_coo
        return from_coo(g, v.shape, v.context)
    return NDArray(g, ctx=v.context)


class _Bridge(torch.autograd.Function):
    """Carries one :class:`Function` call through PyTorch's autograd."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outputs = fn.forward(*[NDArray(t) for t in tensors])
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        ctx.fn = fn
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        with pause():
            grads = ctx.fn.backward(*[NDArray(g) for g in out_grads])
        grads = grads if isinstance(grads, (list, tuple)) else [grads]
        return (None, *[None if g is None else g._data for g in grads])


class Function:
    """A differentiable function over NDArrays (``autograd.py`` Function).

    Subclass it with ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)``, both over NDArrays; ``forward`` runs
    unrecorded, and ``backward`` returns one gradient per input. Both may
    launch kernels of their own (``rtc.CudaModule``)."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        with torch.set_grad_enabled(is_recording()):
            outs = _Bridge.apply(self, *[x._data for x in inputs])
        res = [NDArray(t) for t in outs]
        return res[0] if len(res) == 1 else res
