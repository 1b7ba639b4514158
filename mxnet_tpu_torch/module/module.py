"""Module of the port (the counterpart of ``mxnet_tpu/module/module.py``):
``BaseModule``'s fit/score/predict loops, ``Module`` over one bound
``Executor``, and ``BucketingModule``, whose buckets share parameter
objects. See the package docstring."""
from __future__ import annotations

import logging
from typing import Dict

import torch

from ..base import MXNetError, current_context
from .. import initializer as init_mod
from .. import metric as metric_mod
from .. import optimizer as opt_mod
from ..symbol.executor import _assign

__all__ = ["BaseModule", "Module", "BucketingModule"]


class BaseModule:
    """Shared fit/score/predict loops (base_module.py:409 fit)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- high-level train loop (base_module.py fit) --------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None):
        assert num_epoch is not None, "please specify number of epochs"
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or init_mod.Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        if monitor is not None:
            self.install_monitor(monitor)

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    from ..callback import BatchEndParam
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric, locals=locals())
                    for cb in _listify(batch_end_callback):
                        cb(param)
            name_vals = eval_metric.get_name_value()
            for name, val in name_vals:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _listify(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)

    def score(self, eval_data, eval_metric, num_batch=None, reset=True):
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True):
        if reset:
            eval_data.reset()
        outs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs.append(self.get_outputs()[0])
        from ..ops.registry import apply_op
        return apply_op("concat", *outs, dim=0) if len(outs) > 1 else outs[0]

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def install_monitor(self, mon):
        """Install a mx.monitor.Monitor on the bound executor
        (base_module.py install_monitor)."""
        if getattr(self, "_exec", None) is None:
            raise MXNetError("install_monitor requires a bound module")
        mon.install(self._exec)

    # abstract
    def bind(self, *a, **k):
        raise NotImplementedError

    def forward(self, *a, **k):
        raise NotImplementedError

    def backward(self, *a, **k):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError


def _listify(x):
    return x if isinstance(x, (list, tuple)) else [x]


class Module(BaseModule):
    """Single-symbol module (module.py:364 bind)."""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, context=None, work_load_list=None,
                 fixed_param_names=None, state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = context or current_context()
        if isinstance(self._context, (list, tuple)):
            self._context = self._context[0]
        self._fixed_param_names = set(fixed_param_names or [])
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._data_shapes = None
        self._label_shapes = None

    @property
    def symbol(self):
        return self._symbol

    # -- binding (module.py:364) ---------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        shape_kwargs = {}
        for desc in data_shapes:
            name, shape = (desc.name, desc.shape) if hasattr(desc, "name") else desc
            shape_kwargs[name] = tuple(shape)
        for desc in (label_shapes or []):
            name, shape = (desc.name, desc.shape) if hasattr(desc, "name") else desc
            shape_kwargs[name] = tuple(shape)
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        req = grad_req if for_training else "null"
        if isinstance(req, str):
            reqs = {}
            for a in self._symbol.list_arguments():
                if a in shape_kwargs or a in self._fixed_param_names:
                    reqs[a] = "null"
                else:
                    reqs[a] = req
        else:
            reqs = req
        self._exec = self._symbol.simple_bind(self._context, grad_req=reqs,
                                              **shape_kwargs)
        self.binded = True
        preloaded = getattr(self, "_preloaded", None)
        if preloaded is not None:
            self.init_params(arg_params=preloaded[0], aux_params=preloaded[1],
                             allow_missing=True)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        initializer = initializer or init_mod.Uniform(0.01)
        input_names = set(self._data_names) | set(self._label_names)
        for name, arr in self._exec.arg_dict.items():
            if name in input_names:
                continue
            if arg_params and name in arg_params:
                _assign(arr, arg_params[name]._data)
            elif arg_params and not allow_missing:
                raise MXNetError(f"Parameter {name} missing from arg_params "
                                 "(pass allow_missing=True to initialize it)")
            else:
                initializer(init_mod.InitDesc(name), arr)
        for name, arr in self._exec.aux_dict.items():
            if aux_params and name in aux_params:
                _assign(arr, aux_params[name]._data)
            else:
                if name.endswith("_moving_var") or name.endswith("_running_var"):
                    arr._set_data(torch.ones_like(arr._data))
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        optimizer_params = dict(optimizer_params or {"learning_rate": 0.01})
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True

    # -- data flow -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = True
        feed = {}
        for name, arr in zip(self._data_names, _listify(data_batch.data)):
            feed[name] = arr
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, _listify(data_batch.label)):
                if name in self._exec.arg_dict:
                    feed[name] = arr
        self._exec.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        input_names = set(self._data_names) | set(self._label_names)
        i = 0
        for name in self._exec._arg_names:
            if name in input_names or name in self._fixed_param_names:
                continue
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            self._updater(i, grad, self._exec.arg_dict[name])
            i += 1

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(_listify(labels), self.get_outputs())

    # -- params / checkpoint (module.py:165,793) ------------------------------
    def get_params(self):
        input_names = set(self._data_names) | set(self._label_names)
        arg = {k: v for k, v in self._exec.arg_dict.items()
               if k not in input_names}
        aux = dict(self._exec.aux_dict)
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(None, arg_params, aux_params, allow_missing,
                         force_init, allow_extra)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save(f"{prefix}-symbol.json")
        arg, aux = self.get_params()
        from ..ndarray.utils import save as nd_save
        data = {f"arg:{k}": v for k, v in arg.items()}
        data.update({f"aux:{k}": v for k, v in aux.items()})
        nd_save(f"{prefix}-{epoch:04d}.params", data)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states(True))

    @staticmethod
    def load_checkpoint(prefix, epoch):
        """Returns (symbol, arg_params, aux_params) (model.py:452)."""
        from ..symbol import load as sym_load
        from ..ndarray.utils import load as nd_load
        sym = sym_load(f"{prefix}-symbol.json")
        data = nd_load(f"{prefix}-{epoch:04d}.params")
        arg = {k[4:]: v for k, v in data.items() if k.startswith("arg:")}
        aux = {k[4:]: v for k, v in data.items() if k.startswith("aux:")}
        return sym, arg, aux

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint's symbol, its parameters read onto
        the module's context and set at ``bind``."""
        ctx = kwargs.get("context") or current_context()
        with ctx[0] if isinstance(ctx, (list, tuple)) else ctx:
            sym, arg, aux = Module.load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        return mod


class BucketingModule(BaseModule):
    """Variable-length training via per-bucket executors sharing parameters
    (bucketing_module.py:40; used by example/rnn/bucketing)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, **kwargs):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets: Dict = {}
        self._curr = None
        self._curr_fwd = None
        self._shared_params = None

    @property
    def symbol(self):
        return self._curr.symbol if self._curr else None

    def _get_module(self, bucket_key, data_shapes, label_shapes, for_training):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            mod = Module(sym, data_names, label_names, self.logger,
                         self._context, **self._kwargs)
            mod.bind(data_shapes, label_shapes, for_training)
            if self._shared_params is not None:
                # parameter sharing across buckets: same NDArray objects
                arg, aux = self._shared_params
                for k, v in arg.items():
                    if k in mod._exec.arg_dict:
                        mod._exec.arg_dict[k] = v
                for k, v in aux.items():
                    if k in mod._exec.aux_dict:
                        mod._exec.aux_dict[k] = v
                mod.params_initialized = True
            self._buckets[bucket_key] = mod
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True, **kwargs):
        self._curr = self._get_module(self._default_key, data_shapes,
                                      label_shapes, for_training)
        self.binded = True

    def init_params(self, initializer=None, **kwargs):
        self._curr.init_params(initializer=initializer, **kwargs)
        self._shared_params = self._curr.get_params()
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self._curr.init_optimizer(**kwargs)
        self._opt_kwargs = kwargs
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_key)
        shapes = data_batch.provide_data if hasattr(data_batch, "provide_data") \
            else None
        mod = self._get_module(key, shapes or self._curr._data_shapes,
                               getattr(data_batch, "provide_label", None)
                               or self._curr._label_shapes, True)
        if not mod.optimizer_initialized and self.optimizer_initialized:
            mod._optimizer = self._curr._optimizer
            mod._updater = self._curr._updater
            mod.optimizer_initialized = True
        self._curr_fwd = mod
        mod.forward(data_batch, is_train)

    def _active(self):
        if self._curr_fwd is None:
            raise MXNetError("BucketingModule: call forward() first")
        return self._curr_fwd

    def backward(self, out_grads=None):
        self._active().backward(out_grads)

    def update(self):
        self._active().update()

    def get_outputs(self, merge_multi_context=True):
        return self._active().get_outputs()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._active().update_metric(eval_metric, labels)

    def get_params(self):
        return self._curr.get_params()

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        self._curr = self._get_module(bucket_key, data_shapes, label_shapes, True)
