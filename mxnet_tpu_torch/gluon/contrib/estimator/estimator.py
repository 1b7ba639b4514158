"""The Estimator of the port (the counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``): ``fit`` and
``evaluate`` over a Gluon block, a loss and a ``Trainer``, with the event
loop of ``event_handler.py``.

One difference from the reference, which calls the net on each batch as
its loader made it (JAX places arrays implicitly): the port's loaders make
``cpu()`` arrays (pinned ones with ``pin_memory``), and a block computes
on its input's context, so ``_unpack`` moves data and label to ``context``
(default :func:`current_context`, the card) first: one copy each,
non-blocking from pinned memory. That is MXNet's own ``split_and_load``
placement on one device.
"""
from __future__ import annotations

from ....base import MXNetError, current_context
from ....ndarray.ndarray import NDArray
from .event_handler import (LoggingHandler, MetricHandler, StoppingHandler,
                            ValidationHandler)

__all__ = ["Estimator"]


class Estimator:
    """Train ``net`` on ``loss`` with ``trainer`` (default Adam, lr 1e-3),
    reporting ``train_metrics`` (default ``[Accuracy()]``) and the
    ``loss_metric``, on ``context`` (one context, or a list of one)."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        from .... import metric as metric_mod
        from ... import Trainer
        self.net = net
        self.loss = loss
        self.train_metrics = train_metrics if train_metrics is not None else \
            [metric_mod.Accuracy()]
        if not isinstance(self.train_metrics, (list, tuple)):
            self.train_metrics = [self.train_metrics]
        self.train_metrics = list(self.train_metrics)
        self.loss_metric = metric_mod.Loss(name="loss")
        self.trainer = trainer or Trainer(net.collect_params(), "adam",
                                          {"learning_rate": 1e-3})
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("the port's Estimator trains on one "
                                 "context; several wait for multi-GPU")
            context = context[0]
        self.context = context
        self.stop_training = False

    # -- evaluation ------------------------------------------------------
    def evaluate(self, val_data, val_metrics=None):
        """Run the net over ``val_data`` (no recording, predict mode),
        updating ``val_metrics`` (default: the training metrics); returns
        their ``get()`` pairs."""
        from .... import autograd
        metrics = val_metrics or self.train_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            data, label = self._unpack(batch)
            with autograd.pause():
                pred = self.net(data)
            for m in metrics:
                if getattr(m, "name", "") == "loss":
                    m.update(0, self.loss(pred, label))
                else:
                    m.update(label, pred)
        return [m.get() for m in metrics]

    # -- training --------------------------------------------------------
    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None):
        """Train for ``epochs`` epochs or ``batches`` batches, calling the
        handlers (the defaults added by ``_default_handlers``) at each
        stage: record, backward, ``trainer.step(batch size)``."""
        from .... import autograd
        if epochs is None and batches is None:
            raise MXNetError("fit needs epochs or batches")
        handlers = self._default_handlers(val_data, event_handlers,
                                          epochs, batches)
        self.stop_training = False

        def emit(stage, *args, **kwargs):
            for h in handlers:
                fn = getattr(h, stage, None)
                if fn is not None:
                    fn(self, *args, **kwargs)

        emit("train_begin")
        epoch = 0
        while not self.stop_training and (epochs is None or epoch < epochs):
            emit("epoch_begin")
            for batch in train_data:
                if self.stop_training:
                    break
                emit("batch_begin", batch=batch)
                data, label = self._unpack(batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                self.loss_metric.update(0, loss)
                emit("batch_end", batch=batch, pred=pred, label=label,
                     loss=loss)
            emit("epoch_end", epoch=epoch)
            epoch += 1
        emit("train_end")

    # -- plumbing --------------------------------------------------------
    def _place(self, arr):
        ctx = self.context or current_context()
        return arr.as_in_context(ctx) if isinstance(arr, NDArray) else arr

    def _unpack(self, batch):
        """(data, label) of a ``DataBatch`` or a pair, on the context."""
        if hasattr(batch, "data"):  # DataBatch
            data, label = batch.data[0], batch.label[0]
        else:
            data, label = batch
        return self._place(data), self._place(label)

    def _default_handlers(self, val_data, user_handlers, epochs, batches):
        handlers = list(user_handlers or [])
        have = {type(h) for h in handlers}
        if StoppingHandler not in have:
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(
                [self.loss_metric] + self.train_metrics))
        if val_data is not None and \
                not any(isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=[self.loss_metric] + self.train_metrics))
        handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return handlers
