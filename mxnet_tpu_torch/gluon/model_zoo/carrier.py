"""The weight carrier: parameter dicts of the JAX package into the port's
models, as numpy arrays.

Two naming schemes are taken:

- the JAX package's ``_collect_params_with_prefix()`` names (for example
  ``encoder.layer0.attention.qkv.weight``, ``features.4.0.body.0.weight``
  or an RNN layer's flat ``lstm.parameters`` vector, in the reference's
  layout), which are the port's too (and its ``state_dict()`` keys), since
  its block trees are the JAX block trees;
- a ResNet's ``collect_params()`` names (``resnetv10_stage1_conv2d0_weight``,
  running stats included), which a ResNet of the port maps to its keys with
  ``jax_names()``.

:func:`params_from_jax` turns such a dict into a state dict after checking
it against the model its names and shapes imply (a BERTModel, a
BERTForPretraining, a TransformerLM, a ResNetV1 or an
LSTMLanguageModel); :func:`load_jax_params`
loads it into a given model through its Gluon ``Parameter``s, as the JAX
package's ``load_parameters`` does: a parameter not yet initialized is
initialized from the array, an initialized one is overwritten in place.
Both refuse missing keys, extra keys and shape mismatches before anything
is copied.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ...base import MXNetError

__all__ = ["params_from_jax", "load_jax_params", "to_tensor",
           "check_against", "rename_from_jax"]

# the name scope of a ResNet block tree, e.g. "resnetv10_" (the counter
# after "resnetv1" numbers the nets a process created)
_RESNET_PREFIX = re.compile(r"^resnetv1\d*_")


def to_tensor(arr) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr`` (numpy, ml_dtypes bf16 or a
    tensor) in its own dtype."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", copy=True)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from the JAX side
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _fits(want, got) -> bool:
    """``got`` is ``want``, an unknown (0) dimension of ``want`` taking any
    size."""
    return len(want) == len(got) and all(w in (0, g)
                                         for w, g in zip(want, got))


def check_against(expected: Dict[str, tuple], got: Dict[str, tuple],
                  what: str):
    """Raise MXNetError unless ``got`` has exactly ``expected``'s keys and
    shapes (a deferred, 0, dimension of ``expected`` takes any size)."""
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    bad = sorted(f"{k}: {got[k]} != {expected[k]}"
                 for k in set(expected) & set(got)
                 if not _fits(tuple(expected[k]), tuple(got[k])))
    if missing or extra or bad:
        raise MXNetError(f"parameters do not match {what}: missing {missing}, "
                         f"extra {extra}, shape mismatches {bad}")


def _is_resnet_names(named) -> bool:
    return bool(named) and all(_RESNET_PREFIX.match(k) for k in named)


def rename_from_jax(jax_names: Dict[str, str], named: Dict[str, object],
                    what: str) -> Dict[str, object]:
    """``named`` under ``collect_params()`` names (one ``resnetv1N_``
    prefix) re-keyed by state-dict key, given ``jax_names`` = {state-dict
    key: name without the prefix}. A name the model does not have stays
    under its own name, so the check that follows reports it."""
    prefixes = {_RESNET_PREFIX.match(k).group(0) for k in named}
    if len(prefixes) != 1:
        raise MXNetError(f"parameters do not match {what}: names of several "
                         f"nets {sorted(prefixes)}")
    pre = prefixes.pop()
    to_key = {v: k for k, v in jax_names.items()}
    return {to_key.get(k[len(pre):], k): v for k, v in named.items()}


def params_from_jax(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """State dict (CPU tensors, the arrays' own dtypes) from a JAX-package
    parameter dict: a BERTModel's, BERTForPretraining's, TransformerLM's or
    LSTMLanguageModel's ``_collect_params_with_prefix()`` names, or a
    ResNetV1's or an SSD's (``ssd_300_vgg16``, ``ssd_96_tiny``)
    ``collect_params()`` names. Raises MXNetError unless the names and
    shapes are exactly those of one such model."""
    if _is_resnet_names(named):
        from .vision import resnet
        return resnet.state_from_jax(named)
    from .vision import ssd
    if named and all(ssd._SCOPE.match(k) for k in named):
        return ssd.state_from_jax(named)
    if "lstm.parameters" in named:
        from . import lstm_lm
        return lstm_lm.state_from_jax(named)
    from . import bert
    return bert.state_from_jax(named)


def load_jax_params(model, named: Dict[str, np.ndarray], ctx=None):
    """Copy a JAX-package parameter dict into the Gluon block ``model``,
    each array cast to its parameter's dtype (a ResNet's running stats
    included): in place into parameters already initialized, else
    initializing them on ``ctx`` (default :func:`current_context`). The
    names are ``_collect_params_with_prefix()`` names, or, for a model with
    ``jax_names()``, its ``collect_params()`` names. Raises MXNetError on
    any missing key, extra key or shape mismatch, before anything is
    copied."""
    what = type(model).__name__
    if _is_resnet_names(named) and hasattr(model, "jax_names"):
        named = rename_from_jax(model.jax_names(), named, what)
    params = model._collect_params_with_prefix()
    check_against({k: p.shape for k, p in params.items()},
                  {k: tuple(np.shape(v)) for k, v in named.items()}, what)
    for k, v in named.items():
        params[k]._load(to_tensor(v), ctx)
