"""Layers and models of the port as ``torch.nn.Module``s."""
from . import model_zoo, nn

__all__ = ["model_zoo", "nn"]
