"""Event handlers of the Estimator's loop (the counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``): a handler
subclasses the stages it acts at, and the Estimator calls every handler at
every stage in ascending ``priority`` (0 where a handler has none; the
sort is stable). The priorities and the ``mode="auto"`` rules (min for a
monitor whose name holds "loss", else max) are the reference's."""
from __future__ import annotations

import logging
import os
import time

__all__ = ["EventHandler", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after ``max_epoch`` epochs or ``max_batch`` batches."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset the metrics at each epoch's start and update them after each
    batch: a metric named "loss" from the batch's loss, the others from
    the label and the prediction."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for m in self.metrics:
            if getattr(m, "name", "") == "loss" and loss is not None:
                m.update(0, loss)
            elif pred is not None and label is not None:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Call ``eval_fn(val_data)`` every ``epoch_period`` epochs (and every
    ``batch_period`` batches when given)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log training progress at the end of training and of each epoch, and
    every ``log_interval`` batches when it is an integer."""

    def __init__(self, log_interval="epoch", metrics=None, priority=-3000):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.priority = priority
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.batch_index = 0

    def _metric_str(self):
        parts = []
        for m in self.metrics:
            name, val = m.get()
            parts.append(f"{name}: {val:.4f}" if isinstance(val, float)
                         else f"{name}: {val}")
        return ", ".join(parts)

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        self.logger.info("Training done in %.3fs; %s",
                         time.time() - self.train_start, self._metric_str())

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.logger.info("Epoch done in %.3fs; %s",
                         time.time() - self.epoch_start, self._metric_str())

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            self.logger.info("Batch %d; %s", self.batch_index,
                             self._metric_str())


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save the net's parameters as ``{model_prefix}-epoch{n}.params``
    every ``epoch_period`` epochs and, with ``save_best``, as
    ``{model_prefix}-best.params`` whenever ``monitor`` improves."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="auto", epoch_period=1, batch_period=None,
                 save_best=False, priority=-3000):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.save_best = save_best
        self.priority = priority
        if mode == "auto":
            mode = "min" if monitor is not None and \
                "loss" in getattr(monitor, "name", "") else "max"
        self.mode = mode
        self.best = float("inf") if self.mode == "min" else -float("inf")
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        self.current_epoch = 0

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-{tag}.params")
        estimator.net.save_parameters(path)
        return path

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            better = val < self.best if self.mode == "min" \
                else val > self.best
            if better:
                self.best = val
                self._save(estimator, "best")


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stop when ``monitor`` has not improved by more than ``min_delta``
    for more than ``patience`` epochs."""

    def __init__(self, monitor, min_delta=0.0, patience=0, mode="auto"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        if mode == "auto":
            mode = "min" if "loss" in getattr(monitor, "name", "") else "max"
        self.mode = mode
        self.best = float("inf") if self.mode == "min" else -float("inf")
        self.wait = 0
        self.stopped_epoch = None

    def train_begin(self, estimator, *args, **kwargs):
        self.best = float("inf") if self.mode == "min" else -float("inf")
        self.wait = 0

    def epoch_end(self, estimator, *args, **kwargs):
        _, val = self.monitor.get()
        improved = (val < self.best - self.min_delta if self.mode == "min"
                    else val > self.best + self.min_delta)
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped_epoch = kwargs.get("epoch")
                estimator.stop_training = True
