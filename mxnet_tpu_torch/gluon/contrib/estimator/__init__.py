"""The Estimator training facade of the port (the counterpart of
``mxnet_tpu/gluon/contrib/estimator/``)."""
from .estimator import Estimator  # noqa: F401
from .event_handler import (  # noqa: F401
    BatchBegin, BatchEnd, CheckpointHandler, EarlyStoppingHandler,
    EpochBegin, EpochEnd, EventHandler, LoggingHandler, MetricHandler,
    StoppingHandler, TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator", "BatchBegin", "BatchEnd", "CheckpointHandler",
           "EarlyStoppingHandler", "EpochBegin", "EpochEnd", "EventHandler",
           "LoggingHandler", "MetricHandler", "StoppingHandler",
           "TrainBegin", "TrainEnd", "ValidationHandler"]
