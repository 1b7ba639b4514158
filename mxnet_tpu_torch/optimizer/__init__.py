"""Optimizers of the port, their registry and ``Updater``, and the
learning-rate schedulers (``lr_scheduler``)."""
from . import lr_scheduler
from .lr_scheduler import (CosineScheduler, FactorScheduler, LRScheduler,
                           MultiFactorScheduler, PolyScheduler)
from .optimizer import (DCASGD, FTML, LAMB, LARS, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, AdamW, Ftrl, Optimizer, RMSProp,
                        Signum, Updater, create, get_updater, register)

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "NAG", "RMSProp", "AdaGrad",
           "AdaDelta", "Ftrl", "FTML", "LAMB", "LARS", "Signum", "SGLD",
           "DCASGD", "create", "register", "Updater", "get_updater",
           "lr_scheduler", "LRScheduler", "FactorScheduler",
           "MultiFactorScheduler", "PolyScheduler", "CosineScheduler"]
