"""``mx.init``: the initializers under their short name (an alias of
``initializer``, as in the reference)."""
from .initializer import *  # noqa: F401,F403
from .initializer import __all__  # noqa: F401
