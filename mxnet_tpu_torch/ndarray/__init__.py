"""Reading the JAX package's ``.params`` files."""
from . import utils

__all__ = ["utils"]
