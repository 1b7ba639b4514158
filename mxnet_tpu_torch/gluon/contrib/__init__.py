"""gluon.contrib of the port (the counterpart of
``mxnet_tpu/gluon/contrib/``): the contrib layers (``nn``, ``cnn``,
``rnn``) and the ``estimator`` training facade."""
from . import cnn, estimator, nn, rnn  # noqa: F401

__all__ = ["cnn", "estimator", "nn", "rnn"]
