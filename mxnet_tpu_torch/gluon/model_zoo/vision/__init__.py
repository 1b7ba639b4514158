"""Vision models of the port (ResNet v1, SSD) and ``get_model`` by
name."""
from ....base import MXNetError
from . import resnet, ssd
from .resnet import (BasicBlockV1, BottleneckV1, ResNetV1, get_resnet,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1)
from .ssd import SSD, ssd_96_tiny, ssd_300_vgg16

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "SSD", "get_model",
           "get_resnet", "resnet", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "ssd",
           "ssd_300_vgg16", "ssd_96_tiny"]

_MODELS = {"resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
           "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
           "resnet152_v1": resnet152_v1, "ssd_300_vgg16": ssd_300_vgg16,
           "ssd_96_tiny": ssd_96_tiny}


def get_model(name: str, **kwargs):
    """A model of the zoo by its reference name (``"resnet50_v1"``, ...)."""
    if name.lower() not in _MODELS:
        raise MXNetError(f"model {name!r} is not ported; available: "
                         f"{sorted(_MODELS)}")
    return _MODELS[name.lower()](**kwargs)
