"""``nd.contrib`` of the port (the counterpart of
``mxnet_tpu/ndarray/contrib.py``): the control-flow functions and every
``_contrib_*`` op under its name without the prefix, beside the seven
contrib ops the reference names without one (the MultiBox family and the
multi-tensor helpers).

The reference lowers ``foreach``, ``while_loop`` and ``cond`` to
``lax.scan``, ``lax.while_loop`` and ``lax.cond``; here they run eagerly:
``foreach`` loops over the leading axis, ``while_loop`` and ``cond`` read
their predicate on the host (one sync per iteration or call).
``while_loop`` keeps the reference's static shapes: its outputs are
stacked to ``max_iterations`` rows, zero past the last iteration.
``boolean_mask`` reads the mask on the host (one sync) and gathers the
kept rows with the ``take`` op, so its gradient is take's.
"""
from __future__ import annotations

import sys as _sys
from typing import Callable

import torch

from ..base import MXNetError
from ..ops import registry as _registry
from ..ops.registry import apply_op
from .ndarray import NDArray, _wrap

_this = _sys.modules[__name__]

__all__ = ["foreach", "while_loop", "cond", "boolean_mask"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(rows):
    return apply_op("stack", *rows, axis=0)


def foreach(body: Callable, data, init_states):
    """Run ``body(x_t, states) -> (out_t, new_states)`` over the leading
    axis of ``data`` (an NDArray or a list of them); returns (the outputs
    stacked, an NDArray or a tuple of them as ``body`` returns; the final
    states, an NDArray or a list as given)."""
    single_data = isinstance(data, NDArray)
    single_state = isinstance(init_states, NDArray)
    datas = [data] if single_data else list(data)
    states = init_states if single_state else list(init_states)
    outs = []
    for t in range(datas[0].shape[0]):
        x = datas[0][t] if single_data else [d[t] for d in datas]
        out, states = body(x, states)
        outs.append(out)
    if isinstance(outs[0], (list, tuple)):
        stacked = tuple(_stack([o[i] for o in outs])
                        for i in range(len(outs[0])))
    else:
        stacked = _stack(outs)
    if not single_state:
        states = _as_list(states)
    return stacked, states


def while_loop(cond: Callable, func: Callable, loop_vars,
               max_iterations=None):
    """While ``cond(*loop_vars)`` holds and fewer than ``max_iterations``
    steps ran: ``func(*loop_vars) -> (step_output, new_loop_vars)``.
    Returns (the outputs stacked to ``max_iterations`` rows, zero past the
    last step: one NDArray or a list; the final loop vars, a list)."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (static bound)")
    vars_ = _as_list(loop_vars)
    outs = []
    while len(outs) < max_iterations and \
            bool(cond(*vars_).asnumpy().reshape(())):
        out, vars_ = func(*vars_)
        outs.append(_as_list(out))
        vars_ = _as_list(vars_)
    # the rows' shapes: an iteration's outputs, else a probe, as the
    # reference's trace does
    probe = outs[0] if outs else _as_list(func(*vars_)[0])
    stacked = []
    for i, p in enumerate(probe):
        parts = [_stack([o[i] for o in outs])] if outs else []
        pad = max_iterations - len(outs)
        if pad:
            parts.append(_wrap(torch.zeros((pad,) + tuple(p.shape),
                                           dtype=p.data.dtype,
                                           device=p.data.device), p.context))
        stacked.append(parts[0] if len(parts) == 1
                       else apply_op("concat", *parts, dim=0))
    return (stacked[0] if len(stacked) == 1 else stacked), vars_


def cond(pred, then_func: Callable, else_func: Callable, inputs=None):
    """``then_func(*inputs)`` if ``pred`` (read on the host) is nonzero,
    else ``else_func(*inputs)``; a tuple result comes back as a list."""
    inputs = list(inputs or [])
    p = pred.asnumpy() if isinstance(pred, NDArray) else pred
    fn = then_func if bool(p.reshape(()) if hasattr(p, "reshape") else p) \
        else else_func
    out = fn(*inputs) if inputs else fn()
    return list(out) if isinstance(out, tuple) else out


def boolean_mask(data, index, axis=0):
    """The entries of ``data`` along ``axis`` where ``index`` is nonzero
    (``boolean_mask.cc``); the mask is read on the host (one sync), the
    rows gathered on the data's device by the ``take`` op."""
    mask = index.data if isinstance(index, NDArray) else torch.as_tensor(
        index)
    idx = torch.nonzero(mask.reshape(-1) != 0)[:, 0].to(torch.int32)
    return apply_op("take", data, _wrap(idx.to(data.data.device),
                                        data.context), axis=axis)


_UNPREFIXED = ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
               "multi_sum_sq", "all_finite", "multi_all_finite",
               "reset_arrays")


def _install_aliases():
    """Every ``_contrib_*`` op without its prefix, and the seven contrib
    ops the reference registers without one."""
    for name in _registry.list_ops():
        short = name[len("_contrib_"):] if name.startswith("_contrib_") \
            else name if name in _UNPREFIXED else None
        if short is not None and not hasattr(_this, short):
            setattr(_this, short,
                    _registry.make_nd_wrapper(_registry.get_op(name)))


_install_aliases()
