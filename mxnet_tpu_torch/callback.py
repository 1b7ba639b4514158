"""Training callbacks of the port (the counterpart of
``mxnet_tpu/callback.py``): ``Speedometer``, ``BatchEndParam``,
``log_train_metric`` and ``LogValidationMetricsCallback``, over the port's
metrics. ``do_checkpoint`` and ``module_checkpoint`` save through
``model.save_checkpoint`` and ``Module``, which wait for the legacy API
(ROADMAP Q1.13)."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "BatchEndParam", "log_train_metric",
           "LogValidationMetricsCallback"]


class Speedometer:
    """Log samples/sec (and the metric, reset after each log when
    ``auto_reset``) every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (time.time()
                                                           - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    logging.info(msg, param.epoch, count, speed,
                                 "\t".join(f"{n}={v:f}"
                                           for n, v in name_value))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class BatchEndParam:
    """What a batch-end callback is given."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def log_train_metric(period, auto_reset=False):
    """A callback logging the training metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class LogValidationMetricsCallback:
    """Log each validation metric at the end of an epoch."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
