"""Executor: a bound symbolic graph of the port (the counterpart of
``mxnet_tpu/symbol/executor.py``; MXNet's ``GraphExecutor``).

No graph engine of its own: the DAG evaluates through the ``nd`` frontend
(one op implementation for the imperative and the symbolic API, as MXNet's
shared registry), PyTorch's autograd supplies the backward pass, and each
op runs eagerly on the bound arrays' device (the card's hand-written
kernels where the op has one). Arrays bind in float32, as the reference's.

Shape inference (MXNet's InferShape pass) runs each node through ``nd`` on
tensors of PyTorch's ``meta`` device, which carry a shape and a dtype and
no storage: nothing is allocated and nothing is launched (the attention
wrappers take their plain versions for a meta tensor and count nothing).
An op that cannot run without values (it reads them, calls numpy, or loads
a library) fails inference with the reference's ``MXNetError`` text, or,
under ``partial=True``, leaves its outputs unknown: inference never runs an
op on real data.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as onp
import torch

from ..base import MXNetError, current_context
from ..ndarray.ndarray import NDArray
from .symbol import Symbol

__all__ = ["Executor", "IncompleteShapeError"]

_META = torch.device("meta")


class IncompleteShapeError(MXNetError):
    """Not enough input shapes to complete inference (vs. a genuine shape
    inconsistency, which raises plain MXNetError)."""


# ops whose parameter shapes must be inferred from data shapes before the
# per-node meta pass can run (the deferred-shape part of InferShape)
def _param_shape_hook(op, attrs, in_shapes, arg_names):
    """Return {slot_index: shape} for unknown parameter slots."""
    out = {}
    data = in_shapes[0]
    if data is None:
        return out
    if op == "FullyConnected":
        units = int(attrs.get("num_hidden", 0))
        flatten = attrs.get("flatten", True)
        in_units = int(onp.prod(data[1:])) if flatten else data[-1]
        out[1] = (units, in_units)
        if len(arg_names) > 2:
            out[2] = (units,)
    elif op in ("Convolution", "Deconvolution"):
        k = tuple(attrs.get("kernel") or ())
        nf = int(attrs.get("num_filter", 0))
        g = int(attrs.get("num_group", 1))
        if op == "Convolution":
            out[1] = (nf, data[1] // g) + k
        else:
            out[1] = (data[1], nf // g) + k
        if len(arg_names) > 2:
            out[2] = (nf,)
    elif op in ("BatchNorm", "BatchNorm_v1", "SyncBatchNorm",
                "BatchNormWithReLU"):
        axis = int(attrs.get("axis", 1))
        c = data[axis]
        for slot in (1, 2, 3, 4):
            out[slot] = (c,)
    elif op in ("LayerNorm", "RMSNorm", "InstanceNorm", "GroupNorm"):
        axis = int(attrs.get("axis", -1))
        c = data[axis]
        for slot in range(1, len(arg_names)):
            out[slot] = (c,)
    elif op in ("Embedding", "_contrib_SparseEmbedding"):
        out[1] = (int(attrs.get("input_dim", 0)), int(attrs.get("output_dim", 0)))
    return out


def _array_slots(node):
    """The input slots of ``node`` that hold arrays: all but the
    reference's PRNG ``key`` slots (the port's samplers take the generator
    by keyword)."""
    return [i for i, _ in enumerate(node.inputs)
            if i >= len(node.arg_names) or node.arg_names[i] != "key"]


def _meta_outputs(node, in_shapes):
    """The output shapes of ``node`` run through ``nd`` on meta tensors of
    ``in_shapes`` (float32, as the reference's ``eval_shape`` structs),
    outside recording and training."""
    from .. import autograd
    from .. import ndarray as nd_mod
    fn = getattr(nd_mod, node.op)
    args = [None if in_shapes[i] is None else
            NDArray(torch.empty(in_shapes[i], dtype=torch.float32,
                                device=_META))
            for i in _array_slots(node)]
    while args and args[-1] is None:
        args.pop()
    with autograd.pause(train_mode=False):
        out = fn(*args, **node.attrs)
    outs = out if isinstance(out, (list, tuple)) else (out,)
    return tuple(tuple(o.shape) for o in outs)


def _eval(sym: Symbol, values: Dict[str, NDArray], monitor=None,
          monitor_all=False):
    """Evaluate ``sym``'s DAG through ``nd`` given a {var_name: NDArray}
    map; the one evaluator of a bound graph and of a ``_CachedSubgraph``
    region. An absent input slot passes as a positional None (trailing ones
    trimmed); ``monitor(name, array)`` sees each node's outputs (and, with
    ``monitor_all``, its inputs)."""
    from .. import ndarray as nd_mod
    cache: Dict[int, tuple] = {}
    for n in sym._topo():
        if n.is_var:
            if n.name not in values:
                raise MXNetError(f"unbound variable {n.name}")
            cache[id(n)] = (values[n.name],)
            continue
        ins = []
        for i in _array_slots(n):
            inp = n.inputs[i]
            ins.append(None if inp is None else cache[id(inp[0])][inp[1]])
        while ins and ins[-1] is None:
            ins.pop()
        out = getattr(nd_mod, n.op)(*ins, **n.attrs)
        outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
        n.num_outputs = len(outs)
        cache[id(n)] = outs
        if monitor is not None:
            if monitor_all:
                for i, a in enumerate(ins):
                    if a is not None:
                        monitor(f"{n.name}_input{i}", a)
            for i, o in enumerate(outs):
                suffix = "_output" if len(outs) == 1 else f"_output{i}"
                monitor(f"{n.name}{suffix}", o)
    return [cache[id(s._node)][s._index] for s in sym._outputs()]


def _infer_shapes(sym: Symbol, known: Dict[str, tuple], partial=False,
                  node_shapes_out: Optional[dict] = None):
    """Forward shape-inference walk (infer_graph_attr_pass.cc analog)."""
    nodes = sym._topo()
    shapes: Dict[str, tuple] = dict(known)
    node_out_shapes: Dict[int, tuple] = {}

    for n in nodes:
        if n.is_var:
            if n.name not in shapes and "__shape__" in n.attrs:
                shapes[n.name] = tuple(n.attrs["__shape__"])
            continue
        in_shapes = []
        for inp in n.inputs:
            if inp is None:
                in_shapes.append(None)
            elif inp[0].is_var:
                in_shapes.append(shapes.get(inp[0].name))
            else:
                outs = node_out_shapes.get(id(inp[0]))
                in_shapes.append(outs[inp[1]] if outs is not None else None)
        if n.op == "_CachedSubgraph":
            # recurse: infer the inner graph with whatever outer slot shapes
            # are known; inner inference fills parameter shapes (FC/conv
            # hooks), which map back onto the outer variables
            inner = n.attrs["sym"]
            arg_names = n.attrs["arg_names"]
            inner_known = {an: s for an, s in zip(arg_names, in_shapes)
                           if s is not None}
            inner_shapes, inner_outs, _ = _infer_shapes(inner, inner_known,
                                                        partial=partial)
            for slot, an in enumerate(arg_names):
                if in_shapes[slot] is None and an in inner_shapes:
                    src = n.inputs[slot][0]
                    if src.is_var and src.name not in shapes:
                        shapes[src.name] = inner_shapes[an]
                    in_shapes[slot] = inner_shapes[an]
            if any(s is None for s in inner_outs):
                if partial:
                    node_out_shapes[id(n)] = None
                    continue
                raise IncompleteShapeError(
                    f"infer_shape: subgraph {n.name} outputs unresolved")
            n.num_outputs = len(inner_outs)
            node_out_shapes[id(n)] = tuple(tuple(s) for s in inner_outs)
            continue
        # fill unknown parameter shapes from the hook
        hook = _param_shape_hook(n.op, n.attrs, in_shapes, n.arg_names)
        for slot, shp in hook.items():
            if slot < len(n.inputs) and n.inputs[slot] is not None:
                vn = n.inputs[slot][0]
                if vn.is_var and vn.name not in shapes:
                    shapes[vn.name] = shp
                    in_shapes[slot] = shp
        if any(s is None for i, s in enumerate(in_shapes)
               if n.inputs[i] is not None):
            if partial:
                node_out_shapes[id(n)] = None
                continue
            missing = [n.inputs[i][0].name for i, s in enumerate(in_shapes)
                       if s is None and n.inputs[i] is not None]
            raise IncompleteShapeError(
                f"infer_shape: missing shapes for {missing} (node {n.name})")
        try:
            out_shapes = _meta_outputs(n, in_shapes)
        except Exception as e:  # noqa: BLE001
            if partial:
                node_out_shapes[id(n)] = None
                continue
            raise MXNetError(f"infer_shape failed at node {n.name} ({n.op}): {e}")
        n.num_outputs = len(out_shapes)
        node_out_shapes[id(n)] = out_shapes

    out_shapes = []
    for s in sym._outputs():
        if s._node.is_var:
            out_shapes.append(shapes.get(s._node.name))
        else:
            outs = node_out_shapes.get(id(s._node))
            out_shapes.append(outs[s._index] if outs else None)
    if node_shapes_out is not None:
        node_shapes_out.update(node_out_shapes)
    return shapes, out_shapes, None


def _zeros(shape, ctx):
    from .. import ndarray as nd_mod
    return nd_mod.zeros(shape, ctx=ctx, dtype="float32")


def _assign(arr: NDArray, t: torch.Tensor):
    """Write ``t`` into ``arr`` in its dtype, on its device."""
    arr._set_data(t.detach().to(device=arr._data.device,
                                dtype=arr._data.dtype))


class Executor:
    """Bound graph executor (GraphExecutor analog, autograd-backed)."""

    def __init__(self, sym: Symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = sym
        self._ctx = ctx or current_context()
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()

        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        self.arg_dict: Dict[str, NDArray] = dict(args or {})
        self.aux_dict: Dict[str, NDArray] = dict(aux_states or {})
        missing = [a for a in arg_names if a not in self.arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")

        if isinstance(grad_req, str):
            grad_req = {a: grad_req for a in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(arg_names, grad_req))
        self._grad_req = grad_req
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip([a for a in arg_names
                                  if grad_req.get(a, "write") != "null"],
                                 args_grad))
        self.grad_dict: Dict[str, NDArray] = dict(args_grad or {})
        for a in arg_names:
            req = grad_req.get(a, "write")
            if req != "null" and a not in self.grad_dict:
                arr = self.arg_dict[a]
                self.grad_dict[a] = NDArray(torch.zeros_like(arr._data),
                                            ctx=arr.context)
        self._arg_names = arg_names
        self._aux_names = aux_names
        self.outputs: List[NDArray] = []
        self._out_heads = None
        self._monitor_callback = None
        self._monitor_all = False

    def set_monitor_callback(self, callback, monitor_all=False):
        """Fire ``callback(name, NDArray)`` for every op output (and input,
        when monitor_all) during graph evaluation (MXExecutorSetMonitorCallbackEX
        analog; consumed by mx.monitor.Monitor)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    # -- factory used by Symbol.simple_bind ---------------------------------
    @staticmethod
    def _simple_bind(sym: Symbol, ctx, grad_req, shape_kwargs):
        shapes, _, _ = _infer_shapes(sym, {k: tuple(v)
                                           for k, v in shape_kwargs.items()})
        ctx = ctx or current_context()
        args = {}
        for a in sym.list_arguments():
            if a not in shapes:
                raise MXNetError(f"simple_bind: could not infer shape of {a}")
            args[a] = _zeros(shapes[a], ctx)
        aux = {}
        for a in sym.list_auxiliary_states():
            if a not in shapes:
                raise MXNetError(f"simple_bind: could not infer shape of {a}")
            aux[a] = _zeros(shapes[a], ctx)
        return Executor(sym, ctx, args, None, grad_req, aux)

    # -- execution ----------------------------------------------------------
    def _eval_graph(self):
        return _eval(self._symbol, {**self.aux_dict, **self.arg_dict},
                     self._monitor_callback, self._monitor_all)

    def forward(self, is_train=False, **kwargs):
        from .. import autograd
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown argument {k}")
            src = v._data if isinstance(v, NDArray) else \
                torch.as_tensor(onp.asarray(v))
            _assign(self.arg_dict[k], src)
        if is_train:
            grad_vars = [self.arg_dict[a] for a in self._arg_names
                         if self._grad_req.get(a, "write") != "null"]
            grads = [self.grad_dict[a] for a in self._arg_names
                     if self._grad_req.get(a, "write") != "null"]
            reqs = [self._grad_req.get(a, "write") for a in self._arg_names
                    if self._grad_req.get(a, "write") != "null"]
            autograd.mark_variables(grad_vars, grads, reqs)
            with autograd.record(train_mode=True):
                self.outputs = self._eval_graph()
                self._out_heads = list(self.outputs)
        else:
            with autograd.pause(train_mode=False):
                self.outputs = self._eval_graph()
            self._out_heads = None
        return self.outputs

    def backward(self, out_grads=None):
        from .. import autograd
        if self._out_heads is None:
            raise MXNetError("backward called before forward(is_train=True)")
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        autograd.backward(self._out_heads, out_grads)

    # -- accessors (executor.py parity) --------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[a] for a in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(a) for a in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[a] for a in self._aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                _assign(self.arg_dict[k], v._data)
            elif not allow_extra_params:
                raise MXNetError(f"unknown parameter {k}")
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _assign(self.aux_dict[k], v._data)
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux state {k}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Re-bind with new input shapes, preserving parameter values whose
        shapes are unchanged (executor.py reshape semantics)."""
        shapes = {a: tuple(kwargs.get(a, self.arg_dict[a].shape))
                  for a in self._arg_names}
        new_ex = Executor._simple_bind(self._symbol, self._ctx, self._grad_req,
                                       shapes)
        for name, arr in self.arg_dict.items():
            if name in new_ex.arg_dict and \
                    new_ex.arg_dict[name].shape == arr.shape:
                _assign(new_ex.arg_dict[name], arr._data)
        for name, arr in self.aux_dict.items():
            if name in new_ex.aux_dict and \
                    new_ex.aux_dict[name].shape == arr.shape:
                _assign(new_ex.aux_dict[name], arr._data)
        return new_ex
