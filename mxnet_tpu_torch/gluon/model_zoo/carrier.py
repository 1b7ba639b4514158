"""The weight carrier: parameter dicts of the JAX package into the port's
models, as numpy arrays.

Two naming schemes are taken:

- the JAX package's ``_collect_params_with_prefix()`` names (for example
  ``encoder.layer0.attention.qkv.weight`` or ``features.4.0.body.0.weight``),
  which are the port's ``state_dict()`` keys, since its module trees mirror
  the JAX block trees;
- a ResNet's ``collect_params()`` names (``resnetv10_stage1_conv2d0_weight``,
  running stats included), which a ResNet of the port maps to its keys with
  ``jax_names()``.

:func:`params_from_jax` turns such a dict into a state dict after checking
it against the model its names and shapes imply (a BERTModel, a
BERTForPretraining, a TransformerLM or a ResNetV1); :func:`load_jax_params`
loads it into a given model. Both refuse missing keys, extra keys and shape
mismatches before anything is copied.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

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


def check_against(expected: Dict[str, tuple], got: Dict[str, tuple],
                  what: str):
    """Raise MXNetError unless ``got`` has exactly ``expected``'s keys and
    shapes."""
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    bad = sorted(f"{k}: {got[k]} != {expected[k]}"
                 for k in set(expected) & set(got) if got[k] != expected[k])
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
    parameter dict: a BERTModel's, BERTForPretraining's or TransformerLM's
    ``_collect_params_with_prefix()`` names, or a ResNetV1's
    ``collect_params()`` names. Raises MXNetError unless the names and
    shapes are exactly those of one such model."""
    if _is_resnet_names(named):
        from .vision import resnet
        return resnet.state_from_jax(named)
    from . import bert
    return bert.state_from_jax(named)


def load_jax_params(model: nn.Module, named: Dict[str, np.ndarray]):
    """Copy a JAX-package parameter dict into ``model`` (cast to each
    tensor's dtype and device; a ResNet's running stats included). The
    names are state-dict keys, or, for a model with ``jax_names()``, its
    ``collect_params()`` names. Raises MXNetError on any missing key, extra
    key or shape mismatch, before anything is copied."""
    what = type(model).__name__
    if _is_resnet_names(named) and hasattr(model, "jax_names"):
        named = rename_from_jax(model.jax_names(), named, what)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in named.items()}
    check_against(want, got, what)
    model.load_state_dict({k: to_tensor(v) for k, v in named.items()},
                          strict=True)
