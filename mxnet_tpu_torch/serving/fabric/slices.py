"""Slice planner: partition this process's contexts into gang-scheduled
slices, each backing one logical serving replica (the port of
``mxnet_tpu/serving/fabric/slices.py``).

A :class:`SliceSpec` is the scheduling unit the fabric gangs devices by: a
contiguous run of contexts (``parallel.mesh.carve_slices``), a named axis
layout over them, and a ``capacity`` equal to its context count — the weight
``ServingPool.submit`` divides queue load by, so heterogeneous replicas (one
4-card slice next to two single cards) each attract their fair share of
traffic.

A slice lives inside one process: ``gpu(0)``, ``gpu(1)``, ... on a host
with several cards, ``cpu(i)`` in the tests. Its mesh (:class:`SliceMesh`)
is therefore process-local — the reference's ``shape``, ``axis_names``,
``axis_size`` and ``size`` over a list of contexts — and never a job's mesh
of ranks (``parallel.mesh.make_mesh``): nothing of a slice goes through
``torch.distributed``.

:func:`plan_slices` publishes its plan in ``mxtpu_fabric_slices`` (slices
by size).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ... import telemetry as _telemetry
from ...base import Context, MXNetError
from ...parallel import mesh as _mesh

__all__ = ["SliceSpec", "SliceMesh", "plan_slices"]

_SLICES_G = _telemetry.gauge(
    "mxtpu_fabric_slices",
    "Gang-scheduled device slices in the last plan, by slice size "
    "(devices per slice).",
    labelnames=("size",))


class SliceMesh:
    """A process-local mesh: ``{axis: size}`` laid row-major over a slice's
    contexts. Only the layout is recorded; the sharded endpoints read
    ``axis_names[0]`` as the batch axis."""

    def __init__(self, axes: Dict[str, int], contexts: Sequence[Context]):
        self.shape = {str(a): int(s) for a, s in axes.items()}
        self.axis_names = tuple(self.shape)
        self.contexts = list(contexts)
        size = 1
        for s in self.shape.values():
            size *= s
        if size != len(self.contexts):
            raise MXNetError(f"mesh axes {self.shape} need {size} contexts, "
                             f"{len(self.contexts)} given")
        self.size = size

    def axis_size(self, name: str) -> int:
        if name not in self.shape:
            raise MXNetError(f"mesh {self.shape} has no axis {name!r}")
        return self.shape[name]

    def __repr__(self):
        return f"SliceMesh({self.shape}, {self.contexts})"


class SliceSpec:
    """One gang-scheduled slice: the contexts, the mesh axis layout over
    them, and the replica capacity they add up to.

    ``axes`` defaults to ``{"dp": n}``, the batch-axis layout whose sharded
    endpoints compute each row whole on one context. Pass a different
    layout for tp/fsdp-style experiments (the batch splits over the first
    axis only)."""

    __slots__ = ("index", "devices", "axes", "_mesh")

    def __init__(self, index: int, devices: Sequence,
                 axes: Optional[Dict[str, int]] = None):
        self.index = int(index)
        self.devices = [Context(d) for d in devices]
        if not self.devices:
            raise MXNetError("a slice needs at least one device")
        n = len(self.devices)
        if axes is None:
            axes = {"dp": n}
        sizes = 1
        for s in axes.values():
            sizes *= int(s)
        if sizes != n:
            raise MXNetError(f"slice axes {axes} need {sizes} devices, "
                             f"slice has {n}")
        self.axes = dict(axes)
        self._mesh: Optional[SliceMesh] = None

    @property
    def capacity(self) -> int:
        """Devices this slice gangs — the replica's load weight."""
        return len(self.devices)

    @property
    def name(self) -> str:
        """Topology-stable label: axis layout, not concrete device ids —
        the same string on any restart that lands an equal-shaped slice."""
        return "slice[" + ",".join(f"{a}={s}" for a, s in
                                   sorted(self.axes.items())) + "]"

    def make_mesh(self) -> SliceMesh:
        """The slice's process-local mesh (built once, cached)."""
        if self._mesh is None:
            self._mesh = SliceMesh(self.axes, self.devices)
        return self._mesh

    def __repr__(self):
        return (f"SliceSpec(#{self.index} {self.name} "
                f"devices={[str(d) for d in self.devices]})")


def _visible_cards() -> List[Context]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetError("plan_slices: no CUDA card is visible; pass "
                         "devices=[cpu(0), cpu(1), ...] to plan on the CPU")
    return [Context("gpu", i) for i in range(n)]


def plan_slices(sizes: Sequence[int], devices=None,
                axes: Optional[Sequence[Dict[str, int]]] = None
                ) -> List[SliceSpec]:
    """Carve ``devices`` (default: every card this process sees) into
    gang-scheduled slices.

    ``sizes`` follows ``carve_slices``: asymmetric sizes are fine, leftover
    devices stay uncarved for single-card replicas, oversubscription
    raises. ``axes`` optionally gives each slice its own layout (one dict
    per size; default ``{"dp": size}``)."""
    if axes is not None and len(axes) != len(sizes):
        raise MXNetError(f"axes ({len(axes)}) must match sizes "
                         f"({len(sizes)}) one-to-one")
    if devices is None:
        devices = _visible_cards()
    carved = _mesh.carve_slices(sizes, devices=devices)
    specs = [SliceSpec(i, devs, axes[i] if axes is not None else None)
             for i, devs in enumerate(carved)]
    by_size: Dict[int, int] = {}
    for sp in specs:
        by_size[sp.capacity] = by_size.get(sp.capacity, 0) + 1
    for size, count in by_size.items():
        _SLICES_G.labels(str(size)).set(count)
    return specs
