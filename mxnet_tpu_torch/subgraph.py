"""Subgraph partition and backend delegation of the port (the counterpart
of ``mxnet_tpu/subgraph.py``; MXNet's ``subgraph_property.h``
SubgraphProperty registration and ``symbol.optimize_for`` over
``MXNET_SUBGRAPH_BACKEND``, which hands regions to MKLDNN or TensorRT).

A backend declares the ops it supports; ``optimize_for`` groups maximal
supported regions greedily (cycle-safe: a node joins the open group only if
its graph inputs are group members or predate the group), as the reference
does, and replaces each with a ``_CachedSubgraph`` node. The backend names
are the reference's (``"xla"`` is the default, supporting every registered
op), so scripts that name one run unchanged.

In the port a ``_CachedSubgraph`` region runs its inner graph op by op
through ``nd``, on the autograd tape, in the order of the unpartitioned
graph: a partitioned graph computes bitwise what the unpartitioned one
computes, gradients and random draws included. The reference compiles the
region as one ``jax.jit`` with ``jax.vjp`` for its gradient; capturing the
region as one CUDA graph is a later step of the port.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .base import MXNetError

__all__ = ["SubgraphBackend", "register_backend", "get_backend",
           "list_backends", "optimize_for"]


class SubgraphBackend:
    """Backend descriptor (SubgraphProperty analog).

    Subclass and override ``supported``/``accept`` or pass an op whitelist."""

    def __init__(self, name, op_whitelist=None, min_size=1):
        self.name = name
        self._whitelist = set(op_whitelist) if op_whitelist is not None else None
        self.min_size = min_size

    def supported(self, node) -> bool:
        """Can this op run inside a delegated region?"""
        if self._whitelist is None:
            from .ops import registry
            return node.op in registry._OPS
        return node.op in self._whitelist

    def accept(self, nodes) -> bool:
        """Keep a candidate region? (SubgraphProperty::Accept analog)."""
        return len(nodes) >= self.min_size


_BACKENDS: Dict[str, SubgraphBackend] = {}
_LOCK = threading.Lock()


def register_backend(backend: SubgraphBackend):
    with _LOCK:
        _BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> SubgraphBackend:
    if name not in _BACKENDS:
        raise MXNetError(f"unknown subgraph backend {name!r}; known: "
                         f"{sorted(_BACKENDS)}")
    return _BACKENDS[name]


def list_backends():
    return sorted(_BACKENDS)


register_backend(SubgraphBackend("xla"))


def _install_op():
    from .ops import registry

    @registry.register("_CachedSubgraph")
    def _CachedSubgraph(*arrays, sym, arg_names, backend):
        """A delegated region (subgraph_property.h CreateSubgraphNode
        analog): its inner graph run op by op through ``nd`` on the
        tensors given, recorded on the tape when the caller records, so its
        outputs and gradients are the unpartitioned graph's."""
        from .ndarray.ndarray import _context_of, _wrap
        from .symbol.executor import _eval
        values = {name: _wrap(a, _context_of(a))
                  for name, a in zip(arg_names, arrays)}
        out = tuple(o._data for o in _eval(sym, values))
        return out if len(out) > 1 else out[0]

    # regenerate frontend wrappers (this module imports after those were built)
    from . import ndarray as _nd
    from . import symbol as _sym
    _nd._install_wrappers()
    _sym._install_wrappers()


_install_op()


# ---------------------------------------------------------------------------
# the partition pass (BuildSubgraph analog, build_subgraph.cc)
# ---------------------------------------------------------------------------
def optimize_for(sym, backend_name="xla"):
    """Partition a Symbol for a backend (symbol.optimize_for parity). Returns
    a new Symbol where each delegated region is a ``_CachedSubgraph`` node."""
    from .symbol.symbol import Group, Symbol, _SymNode

    def _var_node(name):
        return _SymNode(None, name, {}, [])

    def _from_slots(slots):
        syms = [Symbol(node, idx) for node, idx in slots]
        return syms[0] if len(syms) == 1 else Group(syms)

    backend = get_backend(backend_name)
    topo = sym._topo()
    pos = {id(n): i for i, n in enumerate(topo)}
    # each node's output count: what evaluation recorded, or at least one
    # past the highest output index any consumer reads (a graph never run
    # still records 1 for a split; the reference's pass then reads only
    # output 0 from a region and keeps the original producers of the rest
    # beside it, running them twice)
    n_out = {id(n): n.num_outputs for n in topo}
    for n in topo:
        for slot in n.inputs:
            if slot is not None:
                n_out[id(slot[0])] = max(n_out[id(slot[0])], slot[1] + 1)
    for s in sym._outputs():
        n_out[id(s._node)] = max(n_out[id(s._node)], s._index + 1)

    # greedy grouping: a supported node joins the open group iff every
    # graph-node input is a group member or predates the group start
    groups: List[List] = []
    open_group: Optional[List] = None
    group_start = 0
    members: Dict[int, int] = {}     # id(node) -> group index
    for i, n in enumerate(topo):
        if n.is_var:
            continue
        joinable = backend.supported(n)
        if joinable and open_group is not None:
            cur = len(groups) - 1
            for slot in n.inputs:
                if slot is None:
                    continue
                src, _ = slot
                if src.is_var:
                    continue
                in_current = members.get(id(src)) == cur
                if not in_current and pos[id(src)] >= group_start:
                    joinable = False
                    break
        if not backend.supported(n):
            open_group = None
            continue
        if open_group is None or not joinable:
            open_group = []
            group_start = i
            groups.append(open_group)
        open_group.append(n)
        members[id(n)] = len(groups) - 1

    groups = [g for g in groups if backend.accept(g)]
    if not groups:
        return sym

    group_of = {id(n): gi for gi, g in enumerate(groups) for n in g}
    # old (node id, out idx) -> new (node, out idx); vars map to themselves
    slot_map: Dict[tuple, tuple] = {}

    def _map_slot(slot):
        if slot is None:
            return None
        src, idx = slot
        return slot_map.get((id(src), idx), (src, idx))

    def _emit_group(gi):
        g = groups[gi]
        gset = {id(n) for n in g}
        ext_inputs, seen = [], set()
        for n in g:
            for slot in n.inputs:
                if slot is None:
                    continue
                src, idx = slot
                if id(src) in gset:
                    continue
                key = (id(src), idx)
                if key not in seen:
                    seen.add(key)
                    ext_inputs.append((src, idx))
        out_slots, out_seen = [], set()
        consumers = [n for n in topo if id(n) not in gset and not n.is_var]
        for n in g:
            used_outside = any(slot is not None and slot[0] is n
                               for c in consumers for slot in c.inputs)
            is_final = any(s._node is n for s in sym._outputs())
            if used_outside or is_final:
                for idx in range(n_out[id(n)]):
                    key = (id(n), idx)
                    if key not in out_seen:
                        out_seen.add(key)
                        out_slots.append((n, idx))

        # the inner symbol: group nodes over fresh variables for ext inputs
        var_names, var_map = [], {}
        for j, (src, idx) in enumerate(ext_inputs):
            vname = f"sg{gi}_in{j}"
            var_names.append(vname)
            var_map[(id(src), idx)] = _var_node(vname)
        inner_nodes = {}
        for n in g:
            slots = []
            for slot in n.inputs:
                if slot is None:
                    slots.append(None)
                    continue
                src, idx = slot
                slots.append((inner_nodes[id(src)], idx) if id(src) in gset
                             else (var_map[(id(src), idx)], 0))
            nn = _SymNode(n.op, n.name, dict(n.attrs or {}), slots,
                          arg_names=n.arg_names)
            nn.num_outputs = n_out[id(n)]
            inner_nodes[id(n)] = nn
        inner_sym = _from_slots(
            [(inner_nodes[id(n)], idx) for (n, idx) in out_slots])

        sg_node = _SymNode(
            "_CachedSubgraph", f"_sg_{backend.name}{gi}",
            {"sym": inner_sym, "arg_names": tuple(var_names),
             "backend": backend.name},
            [_map_slot((src, idx)) for (src, idx) in ext_inputs])
        sg_node.num_outputs = len(out_slots)
        for k, (n, idx) in enumerate(out_slots):
            slot_map[(id(n), idx)] = (sg_node, k)

    # one topo walk: emit each group at its first member, clone every node
    # outside a group with remapped inputs (downstream consumers must point
    # at the new producers, not the originals)
    emitted = set()
    for n in topo:
        if n.is_var:
            continue
        gi = group_of.get(id(n))
        if gi is not None:
            if gi not in emitted:
                emitted.add(gi)
                _emit_group(gi)
            continue
        clone = _SymNode(n.op, n.name, dict(n.attrs or {}),
                         [_map_slot(s) for s in n.inputs],
                         arg_names=n.arg_names)
        clone.num_outputs = n_out[id(n)]
        for idx in range(n_out[id(n)]):
            slot_map[(id(n), idx)] = (clone, idx)

    return _from_slots(
        [_map_slot((s._node, s._index)) for s in sym._outputs()])
