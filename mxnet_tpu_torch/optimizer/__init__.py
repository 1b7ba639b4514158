"""Optimizers of the port (``Optimizer``, ``SGD``, ``Adam``)."""
from .optimizer import SGD, Adam, Optimizer

__all__ = ["Adam", "Optimizer", "SGD"]
