"""Device meshes of the port: the one-device part of
``mxnet_tpu/parallel/mesh.py``.

The JAX package names the axes of a device grid (dp, fsdp, pp, tp, sp, ep)
and lets GSPMD insert the collectives. The port runs on one card so far: a
mesh is named axes of size 1 over one device. Larger meshes (multi-GPU over
``torch.distributed``) are ROADMAP item P9 and raise here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..base import Context, MXNetError, current_context

__all__ = ["DeviceMesh", "make_mesh"]


class DeviceMesh:
    """Named axes of size 1 over one device (``ctx``)."""

    def __init__(self, axes: Dict[str, int], ctx: Context):
        self._axes = dict(axes)
        self.ctx = ctx
        #: the torch device every array of a step on this mesh lives on
        self.device: torch.device = ctx.torch_device()

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._axes)

    def __repr__(self):
        return f"DeviceMesh({self._axes}, {self.ctx})"


def make_mesh(axes: Dict[str, int], ctx: Context = None) -> DeviceMesh:
    """A mesh with the given ``{axis_name: size}`` layout on ``ctx``
    (default :func:`current_context`, i.e. ``gpu(0)``). Every size must be
    1; a GPU context on a host without CUDA raises."""
    for name, size in axes.items():
        if size != 1:
            raise MXNetError(
                f"mesh axis {name!r} has size {size}: the port runs on one "
                "device so far; multi-device meshes are ROADMAP item P9")
    return DeviceMesh(axes, ctx if ctx is not None else current_context())
