"""Device meshes of the port (the counterpart of
``mxnet_tpu/parallel/mesh.py``).

The JAX package names the axes of a device grid (dp, fsdp, pp, tp, sp, ep)
and lets GSPMD insert the collectives. The port runs one process per rank
(``parallel.collectives.initialize_distributed``): a mesh lays the job's
ranks out row-major over its axes, as the reference reshapes its device
list (``mesh.py:127-131``), so rank ``r`` of a ``{"dp": 2, "tp": 2}`` mesh
sits at ``(r // 2, r % 2)``. Each axis of size > 1 gets one process group
per line of ranks along it, made here by every rank in the same order (the
one place of the port that calls ``new_group``). A mesh whose sizes are all
1 is one rank's mesh and needs no job.
"""
from __future__ import annotations

import threading
from itertools import product
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..base import Context, MXNetError, current_context
from . import collectives

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "replicated",
           "shard_spec", "carve_slices"]

_current = threading.local()


class DeviceMesh:
    """Named axes over the job's ranks; this process is one of them, on
    ``ctx``.

    Axis names are free-form; the canonical ones are dp (data), fsdp
    (fully sharded data), tp (tensor), sp (sequence), pp (pipeline) and ep
    (expert)."""

    def __init__(self, axes: Dict[str, int], ctx: Context):
        self._axes = dict(axes)
        self.ctx = ctx
        #: the torch device every array of a step on this mesh lives on
        self.device: torch.device = ctx.torch_device()
        self.rank = collectives.rank()
        self._coords = self._coords_of(self.rank)
        self._groups = {}
        for name in self._axes:
            if self._axes[name] > 1:
                self._groups[name] = self._make_groups(name)

    def _coords_of(self, r) -> Dict[str, int]:
        coords = {}
        for name in reversed(list(self._axes)):
            coords[name] = r % self._axes[name]
            r //= self._axes[name]
        return coords

    def _rank_of(self, coords) -> int:
        r = 0
        for name in self._axes:
            r = r * self._axes[name] + coords[name]
        return r

    def _make_groups(self, axis):
        """Every line of ranks along ``axis`` as a process group (each
        rank creates all of them, in one order); this rank's returned."""
        others = [n for n in self._axes if n != axis]
        mine = None
        for fixed in product(*(range(self._axes[n]) for n in others)):
            coords = dict(zip(others, fixed))
            ranks = [self._rank_of({**coords, axis: i})
                     for i in range(self._axes[axis])]
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._axes)

    @property
    def size(self) -> int:
        n = 1
        for s in self._axes.values():
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self._axes.get(name, 1)

    def axis_index(self, name: str) -> int:
        """This rank's position along ``name`` (0 for an absent axis)."""
        return self._coords.get(name, 0)

    def group(self, name: str):
        """The process group of this rank's line along ``name``."""
        if name not in self._groups:
            raise MXNetError(f"mesh {self._axes} has no axis {name!r} of "
                             "size > 1")
        return self._groups[name]

    def __enter__(self):
        stack = getattr(_current, "stack", None)
        if stack is None:
            stack = _current.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _current.stack.pop()

    def __repr__(self):
        return f"DeviceMesh({self._axes}, {self.ctx})"


def make_mesh(axes: Dict[str, int], ctx: Context = None,
              devices=None) -> DeviceMesh:
    """A mesh with the given ``{axis_name: size}`` layout over the job's
    ranks (one size may be -1, inferred); this rank computes on ``ctx``
    (default :func:`current_context`, i.e. ``gpu(0)``; a GPU context on a
    host without CUDA raises). ``devices`` is the reference's device list:
    its length, when given, must be the job's size. A process that a
    launcher started joins its job first."""
    collectives.initialize_distributed()
    world = collectives.num_workers()
    if devices is not None and len(devices) != world:
        raise MXNetError(f"a mesh of the port spans the job's {world} "
                         f"rank(s); {len(devices)} devices given")
    names, sizes = list(axes), [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise MXNetError("at most one mesh axis may be -1")
    known = 1
    for s in sizes:
        if s != -1:
            if s < 1:
                raise MXNetError(f"mesh axis sizes must be >= 1: {axes}")
            known *= s
    if -1 in sizes:
        if world % known:
            raise MXNetError(f"cannot infer axis: {world} ranks not "
                             f"divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    elif known != world:
        raise MXNetError(f"mesh {dict(zip(names, sizes))} needs {known} "
                         f"ranks, the job has {world}")
    if ctx is None:
        ctx = current_context()
        if ctx.device_type == "gpu" and world > 1:
            dev = collectives.device()
            ctx = Context("gpu", dev.index or 0)
    return DeviceMesh(dict(zip(names, sizes)), ctx)


def carve_slices(sizes: Sequence[int], devices=None):
    """Partition ``devices`` (default: the job's ranks) into contiguous
    slices of the given sizes; the tail may stay uncarved, oversubscribing
    raises."""
    if devices is None:
        devices = list(range(collectives.num_workers()))
    devices = list(devices)
    sizes = [int(s) for s in sizes]
    if not sizes:
        raise MXNetError("carve_slices needs at least one slice size")
    for s in sizes:
        if s < 1:
            raise MXNetError(f"slice sizes must be >= 1, got {s} in {sizes}")
    if sum(sizes) > len(devices):
        raise MXNetError(
            f"slice plan {sizes} needs {sum(sizes)} devices, only "
            f"{len(devices)} visible — slices must never share chips")
    out, off = [], 0
    for s in sizes:
        out.append(devices[off:off + s])
        off += s
    return out


def current_mesh() -> Optional[DeviceMesh]:
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


def replicated(mesh: DeviceMesh):
    """The spec of an array every rank holds whole."""
    return shard_spec()


class shard_spec(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry per
    dimension, an axis name (or a tuple of them) that dimension is split
    over, or None for a whole dimension."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)

    def __repr__(self):
        return f"shard_spec{tuple.__repr__(self)}"
