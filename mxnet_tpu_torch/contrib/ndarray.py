"""``contrib.ndarray`` (the counterpart of ``mxnet_tpu/contrib/ndarray.py``):
``nd.contrib`` under its legacy name."""
from ..ndarray.contrib import *  # noqa: F401,F403
