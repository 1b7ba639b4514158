"""``mx.log`` (the counterpart of ``mxnet_tpu/log.py``): a logger factory
with the reference's format."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger", "CRITICAL", "ERROR", "WARNING",
           "INFO", "DEBUG", "NOTSET"]

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger writing to ``filename`` (else standard error) in the
    reference's format; a second call only sets the level."""
    logger = logging.getLogger(name)
    if getattr(logger, "_init_done", False):
        logger.setLevel(level)
        return logger
    logger._init_done = True
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


getLogger = get_logger  # the reference's spelling
