"""Optimizers of the port (``Optimizer``, ``Adam``)."""
from .optimizer import Adam, Optimizer

__all__ = ["Adam", "Optimizer"]
