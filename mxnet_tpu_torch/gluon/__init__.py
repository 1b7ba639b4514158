"""Layers and models of the port as ``torch.nn.Module``s."""
from . import loss, model_zoo, nn

__all__ = ["loss", "model_zoo", "nn"]
