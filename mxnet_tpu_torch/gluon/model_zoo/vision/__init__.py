"""Vision models of the port (ResNet v1/v2, AlexNet, VGG, SqueezeNet,
DenseNet, Inception-v3, MobileNet v1/v2, SSD) and ``get_model`` by the
reference's names."""
import re

import numpy as np

from ....base import MXNetError
from ..carrier import _ZOO_PREFIX, check_against, rename_from_jax, to_tensor
from . import dense_nets, resnet, simple_nets, ssd
from .dense_nets import *   # noqa: F401,F403
from .resnet import *       # noqa: F401,F403
from .simple_nets import *  # noqa: F401,F403
from .ssd import SSD, ssd_96_tiny, ssd_300_vgg16

_FAMILIES = (resnet, simple_nets, dense_nets)
_models = {name: getattr(m, name) for m in _FAMILIES for name in m.__all__
           if name[0].islower() and not name.startswith("get_")
           and name != "state_from_jax"}
_models.update(ssd_300_vgg16=ssd_300_vgg16, ssd_96_tiny=ssd_96_tiny)

__all__ = sorted(set().union(*(m.__all__ for m in _FAMILIES))
                 - {"state_from_jax"}) + [
    "SSD", "dense_nets", "get_model", "resnet", "simple_nets", "ssd",
    "ssd_300_vgg16", "ssd_96_tiny", "state_from_jax"]


def get_model(name: str, **kwargs):
    """A model of the zoo by its reference name (``"resnet50_v1"``,
    ``"mobilenet_v2_1_0"``, ...)."""
    if name.lower() not in _models:
        raise MXNetError(f"Model {name} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name.lower()](**kwargs)


def _family(model_name):
    """The name scope of the net ``_models[model_name]`` builds
    (``"resnetv2"``, ``"vgg"``, ``"mobilenetv2"``, ...)."""
    if model_name.startswith("resnet"):
        return "resnetv" + model_name[-1]
    if model_name.startswith("mobilenet_v2"):
        return "mobilenetv2"
    if model_name == "inception_v3":
        return "inception3"
    return re.match(r"[a-z]+", model_name).group(0)


def state_from_jax(named, family):
    """``carrier.params_from_jax`` for a zoo net of ``family`` other than
    ResNet v1: the state dict of the first of the family's models whose
    names and shapes (``classes`` from its output layer) these are, running
    stats included. Raises MXNetError unless they are exactly one such
    net's (with the closest candidate's mismatches)."""
    pre = _ZOO_PREFIX.match(next(iter(named))).group(0)
    error = MXNetError(f"parameters do not match any {family} net of the "
                       "zoo")
    for name in sorted(n for n in _models if _family(n) == family):
        probe = _models[name]()
        out = next(iter(probe.output.collect_params().values()))
        key = pre + out.name[len(probe.prefix):]
        if key not in named:
            continue
        net = _models[name](classes=np.shape(named[key])[0])
        keyed = rename_from_jax(net.jax_names(), named, name)
        try:
            check_against({k: p.shape for k, p in
                           net._collect_params_with_prefix().items()},
                          {k: tuple(np.shape(v)) for k, v in keyed.items()},
                          name)
        except MXNetError as e:
            error = e
            continue
        return {k: to_tensor(v) for k, v in keyed.items()}
    raise error
