"""The Gluon surface of the port: ``Block``, ``HybridBlock``,
``Parameter``, ``ParameterDict``, ``Constant``, ``Trainer``, the layers
(``nn``), the recurrent layers and cells (``rnn``), the losses, ``utils``,
the data path (``data``) and the model zoo. A block is a ``torch.nn.Module``."""
from .block import Block, HybridBlock
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import data, loss, model_zoo, nn, rnn, utils
from .utils import split_and_load

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "data", "loss",
           "model_zoo",
           "nn", "rnn", "utils", "split_and_load"]
