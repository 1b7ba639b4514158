"""Training over device meshes (one device so far): ``make_mesh`` and
``ParallelTrainStep``."""
from .mesh import DeviceMesh, make_mesh
from .train_step import ParallelTrainStep

__all__ = ["DeviceMesh", "ParallelTrainStep", "make_mesh"]
