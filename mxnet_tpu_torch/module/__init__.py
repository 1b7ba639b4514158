"""``mx.mod`` of the port (the counterpart of ``mxnet_tpu/module/``; MXNet's
``python/mxnet/module/``): ``BaseModule.fit`` (base_module.py:409),
``Module``'s bind/forward/backward/update (module.py:364-646),
``BucketingModule`` (bucketing_module.py:40) and the checkpoints
(module.py:165, 793).

``Module`` drives the symbolic ``Executor`` (autograd over the ``nd`` ops,
on the card's kernels where an op has one) and the port's optimizers;
there is no separate bound-graph engine.
"""
from .module import BaseModule, Module, BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
