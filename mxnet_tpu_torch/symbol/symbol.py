"""Symbol: the legacy declarative graph API of the port (the counterpart
of ``mxnet_tpu/symbol/symbol.py``).

A Symbol is a small DAG over the port's operator registry, the one the
imperative ``nd`` frontend runs (as MXNet's ``NNVM_REGISTER_OP`` serves
both ``mx.nd`` and ``mx.sym``). Binding builds no graph engine of its own:
``simple_bind`` evaluates the DAG through ``nd`` (so BatchNorm's and
Dropout's training behaviour, the generators and autograd come from the
one implementation, and ``multi_head_attention`` reaches the hand-written
attention kernels on the card). Shape inference runs each node through
``nd`` on tensors of the ``meta`` device, with parameter-shape hooks for
the ops that own parameters (``executor.py``). Op names, the auto-created
parameter names and the JSON format are the reference's, so a
``-symbol.json`` written by either package loads in the other.
"""
from __future__ import annotations

import inspect
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json"]

# positional op arguments that are learnable/aux parameters: auto-created as
# vars when not supplied (the reference's symbol composition does the same —
# FullyConnected(data, name="fc1") creates fc1_weight/fc1_bias)
_PARAM_ARGS = {"weight", "bias", "gamma", "beta", "moving_mean", "moving_var",
               "running_mean", "running_var", "params", "state", "state_cell",
               "parameters", "label"}
_AUX_ARGS = {"moving_mean", "moving_var", "running_mean", "running_var"}
_SKIP_ARGS = {"key"}  # runtime-injected (PRNG); never a graph input

_name_lock = threading.Lock()
_name_counts: Dict[str, int] = {}


def _auto_name(hint: str) -> str:
    from ..name import NameManager
    mgr = NameManager.current()
    if mgr is not None:
        return mgr.get(None, hint)
    with _name_lock:
        n = _name_counts.get(hint, 0)
        _name_counts[hint] = n + 1
    return f"{hint}{n}"


class _SymNode:
    """One graph node: a variable or an op application."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs", "arg_names")

    def __init__(self, op: Optional[str], name: str, attrs: dict,
                 inputs: List[Tuple["_SymNode", int]], arg_names=()):
        self.op = op              # None for variables
        self.name = name
        self.attrs = attrs
        self.inputs = inputs      # [(node, out_index) or None per positional slot]
        self.num_outputs = 1
        self.arg_names = arg_names

    @property
    def is_var(self):
        return self.op is None


def _positional_names(op_name: str):
    """Positional (array) parameter names of an op, from the registry
    signature or the hand-written nd wrapper. An op that draws from a
    generator has the reference's ``key`` slot (its PRNG key, never a graph
    input): first for the ``_random_*`` samplers, last for the others, as
    the reference's signatures have it."""
    from ..ops import registry as _registry
    from .. import ndarray as nd_mod
    try:
        fn = _registry.get_op(op_name).fn
    except MXNetError:
        fn = getattr(nd_mod, op_name, None)
        if fn is None:
            raise
    sig = inspect.signature(fn)
    names = []
    variadic = False
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            names.append(p.name)
        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
            variadic = True
    if "generator" in sig.parameters:
        names = ["key", *names] if op_name.startswith("_random_") \
            else [*names, "key"]
    return names, variadic


class Symbol:
    """A node-output handle in the symbolic graph (symbol.py Symbol)."""

    __slots__ = ("_node", "_index", "_group")

    def __init__(self, node: Optional[_SymNode] = None, index: int = 0,
                 group: Optional[List["Symbol"]] = None):
        self._node = node
        self._index = index
        self._group = group

    # -- construction -------------------------------------------------------
    @staticmethod
    def _create(op_name: str, args: Sequence, kwargs: dict) -> "Symbol":
        name = kwargs.pop("name", None) or _auto_name(op_name.lower())
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol) and k != "attr"}
        sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        pos_names, variadic = _positional_names(op_name)

        inputs: List[Optional[Tuple[_SymNode, int]]] = []
        arg_names: List[str] = []
        if variadic:
            for a in args:
                if not isinstance(a, Symbol):
                    raise MXNetError(f"{op_name}: positional args must be Symbols")
                inputs.append((a._node, a._index))
                arg_names.append(f"arg{len(arg_names)}")
        else:
            supplied = list(args)
            for i, pname in enumerate(pos_names):
                if pname in _SKIP_ARGS:
                    inputs.append(None)
                    arg_names.append(pname)
                    continue
                sym = None
                if pname in sym_kwargs:
                    sym = sym_kwargs.pop(pname)
                elif supplied:
                    cand = supplied.pop(0)
                    if cand is None:
                        inputs.append(None)
                        arg_names.append(pname)
                        continue
                    if not isinstance(cand, Symbol):
                        raise MXNetError(
                            f"{op_name}: positional arg {pname} must be a Symbol")
                    sym = cand
                elif pname in _PARAM_ARGS:
                    if pname == "bias" and (attrs.get("no_bias") or
                                            attrs.get("use_bias") is False):
                        inputs.append(None)
                        arg_names.append(pname)
                        continue
                    sym = var(f"{name}_{pname}")
                else:
                    break  # trailing optional data inputs not supplied
                inputs.append((sym._node, sym._index))
                arg_names.append(pname)
        node = _SymNode(op_name, name, attrs, inputs, tuple(arg_names))
        return Symbol(node)

    # -- identity -----------------------------------------------------------
    @property
    def name(self):
        if self._group is not None:
            return "group"
        return self._node.name

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __iter__(self):
        if self._group is not None:
            return iter(self._group)
        return iter([self])

    def __getitem__(self, idx):
        if self._group is not None:
            return self._group[idx]
        if isinstance(idx, int):
            return Symbol(self._node, idx)
        raise MXNetError("symbol indexing requires an integer")

    # -- graph walking ------------------------------------------------------
    def _outputs(self) -> List["Symbol"]:
        return self._group if self._group is not None else [self]

    def _topo(self) -> List[_SymNode]:
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp in node.inputs:
                if inp is not None:
                    visit(inp[0])
            order.append(node)

        for s in self._outputs():
            visit(s._node)
        return order

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._topo()
                if n.is_var and not _is_aux_name(n)]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self._topo() if n.is_var and _is_aux_name(n)]

    def list_outputs(self) -> List[str]:
        return [f"{s._node.name}_output{s._index}" if s._node.num_outputs > 1
                else f"{s._node.name}_output" for s in self._outputs()]

    def get_internals(self) -> "Symbol":
        return Group([Symbol(n, 0) for n in self._topo() if not n.is_var])

    def attr(self, key):
        return self._node.attrs.get(key) if self._node else None

    # -- composition (symbol.py __call__) ------------------------------------
    def __call__(self, **kwargs):
        """Substitute variables by name with other symbols."""
        mapping = {}
        for n in self._topo():
            if n.is_var and n.name in kwargs:
                mapping[id(n)] = (kwargs[n.name]._node, kwargs[n.name]._index)
        if not mapping:
            return self
        memo: Dict[int, _SymNode] = {}

        def clone(node):
            if id(node) in mapping:
                return mapping[id(node)][0]
            if id(node) in memo:
                return memo[id(node)]
            new_inputs = []
            for inp in node.inputs:
                if inp is None:
                    new_inputs.append(None)
                elif id(inp[0]) in mapping:
                    new_inputs.append(mapping[id(inp[0])])
                else:
                    new_inputs.append((clone(inp[0]), inp[1]))
            nn = _SymNode(node.op, node.name, dict(node.attrs), new_inputs,
                          node.arg_names)
            memo[id(node)] = nn
            return nn

        outs = [Symbol(clone(s._node), s._index) for s in self._outputs()]
        return outs[0] if len(outs) == 1 else Group(outs)

    # -- shape/type inference (infer_graph_attr_pass.cc analog) ---------------
    def infer_shape(self, **kwargs):
        from .executor import _infer_shapes, IncompleteShapeError
        try:
            shapes, out_shapes, aux_shapes = _infer_shapes(self, kwargs)
        except IncompleteShapeError:
            # under-specified is a soft failure (reference returns Nones);
            # genuine shape inconsistencies propagate as MXNetError
            return None, None, None
        args = self.list_arguments()
        auxs = self.list_auxiliary_states()
        return ([shapes.get(a) for a in args], out_shapes,
                [shapes.get(a) for a in auxs])

    def infer_shape_partial(self, **kwargs):
        from .executor import _infer_shapes
        shapes, out_shapes, _ = _infer_shapes(self, kwargs, partial=True)
        args = self.list_arguments()
        auxs = self.list_auxiliary_states()
        return ([shapes.get(a) for a in args], out_shapes,
                [shapes.get(a) for a in auxs])

    # -- binding -------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        from .executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    # -- evaluation helper (symbol.py eval) -----------------------------------
    def eval(self, ctx=None, **kwargs):
        args = {k: v for k, v in kwargs.items()}
        ex = self.bind(ctx, args=args, grad_req="null")
        return ex.forward()

    # -- autodiff ------------------------------------------------------------
    def grad(self, wrt):
        raise MXNetError("Symbol.grad: use executor.backward (autograd-based)")

    # -- serialization (symbol.py tojson/save) --------------------------------
    def tojson(self):
        nodes = self._topo()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": n.op or "null", "name": n.name,
                "attrs": {k: repr(v) for k, v in n.attrs.items()},
                "inputs": [[idx[id(i[0])], i[1]] if i is not None else None
                           for i in n.inputs],
                "arg_names": list(n.arg_names),
            })
        heads = [[idx[id(s._node)], s._index] for s in self._outputs()]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "format": "mxnet_tpu/symbol-v1"}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- arithmetic ----------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return Symbol._create(op, (a, b), {})
        return Symbol._create(scalar_op, (self,),
                              {"scalar": float(other), "reverse": reverse})

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return Symbol._create("negative", (self,), {})

    # method mirrors
    def reshape(self, shape):
        return Symbol._create("reshape", (self,), {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return Symbol._create("transpose", (self,), {"axes": axes})

    def sum(self, axis=None, keepdims=False):
        return Symbol._create("sum", (self,), {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return Symbol._create("mean", (self,), {"axis": axis, "keepdims": keepdims})


def _is_aux_name(node) -> bool:
    n = node.name
    return any(n.endswith("_" + a) or n == a for a in _AUX_ARGS)


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs) -> Symbol:
    """Create a variable symbol (symbol.py var/Variable)."""
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype
    if init is not None:
        attrs["__init__"] = init
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    return Symbol(_SymNode(None, name, attrs, []))


Variable = var


def Group(symbols) -> Symbol:
    syms = []
    for s in symbols:
        syms.extend(s._outputs())
    return Symbol(group=syms)


def load_json(json_str: str) -> Symbol:
    """Parse symbol JSON: both the native mxnet_tpu/symbol-v1 format and
    reference-exported MXNet graphs (nodes carry "attrs" or legacy "param";
    "inputs"/"heads" entries are [id, index] or [id, index, version] — indexed,
    not tuple-unpacked, so both arities work; "arg_nodes"/"node_row_ptr" are
    metadata recomputable from the DAG and are ignored)."""
    data = json.loads(json_str)
    nodes: List[_SymNode] = []
    for jn in data["nodes"]:
        raw_attrs = jn.get("attrs") or jn.get("param") or {}
        attrs = {k: _unrepr(v) for k, v in raw_attrs.items()}
        inputs = [(nodes[e[0]], e[1]) if e is not None else None
                  for e in jn["inputs"]]
        op = None if jn["op"] == "null" else jn["op"]
        nodes.append(_SymNode(op, jn["name"], attrs, inputs,
                              tuple(jn.get("arg_names", ()))))
    heads = [Symbol(nodes[e[0]], e[1]) for e in data["heads"]]
    return heads[0] if len(heads) == 1 else Group(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def _unrepr(v):
    import ast
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
