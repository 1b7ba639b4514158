"""``mx.model`` of the port (the counterpart of ``mxnet_tpu/model.py``;
MXNet's ``python/mxnet/model.py``): the checkpoint helpers
``save_checkpoint`` (model.py:403), ``load_params`` and ``load_checkpoint``
(model.py:452), writing ``prefix-symbol.json`` and ``prefix-%04d.params``
in the reference's formats through the port's ``nd.save``/``nd.load``,
and the ``BatchEndParam`` namedtuple. The deprecated FeedForward trainer is
served by ``Module``."""
from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from .base import cpu

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` + ``prefix-%04d.params`` (model.py:403).

    ``remove_amp_cast`` is accepted for signature parity but has no effect:
    AMP casts are made at dispatch time, never recorded as graph nodes, so
    there is nothing to strip from the saved symbol."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v.as_in_context(cpu())
                 for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v.as_in_context(cpu())
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_params(prefix, epoch):
    """Split a saved dict back into (arg_params, aux_params)."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    if not save_dict:
        logging.warning("Params file '%s-%04d.params' is empty", prefix, epoch)
        return arg_params, aux_params
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) saved by save_checkpoint
    (model.py:452)."""
    from .symbol import load as sym_load
    symbol = sym_load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
