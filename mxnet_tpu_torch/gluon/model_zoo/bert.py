"""BERT encoder of the port: the counterpart of the encoder half of
``mxnet_tpu/gluon/model_zoo/bert.py`` (``SelfAttention`` through
``BERTModel`` and ``bert_base``).

The module tree mirrors the JAX block tree, so ``state_dict()`` keys equal
the JAX package's ``_collect_params_with_prefix()`` names (for example
``encoder.layer0.attention.qkv.weight``). Weights cross over as numpy
arrays: :func:`params_from_jax` turns such a dict into a state dict and
:func:`load_jax_params` loads it into a model, both refusing missing keys,
extra keys and shape mismatches; ``BERTModel.load_parameters`` reads a
``.params`` file the JAX package wrote.

Attention runs through ``ops.nn.multi_head_attention``: with no padding mask
every layer's attention is one call of the hand-written flash-attention
kernel on the card.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from ...base import MXNetError
from ...ops import nn as ops
from ..nn import Dense, Dropout, Embedding, LayerNorm

__all__ = ["SelfAttention", "PositionwiseFFN", "TransformerEncoderLayer",
           "BERTEncoder", "BERTModel", "bert_base", "params_from_jax",
           "load_jax_params"]


class SelfAttention(nn.Module):
    """Multi-head self-attention with one fused QKV projection."""

    def __init__(self, units, num_heads, dropout=0.0, device=None):
        super().__init__()
        self._units = units
        self._heads = num_heads
        self.qkv = Dense(3 * units, flatten=False, in_units=units,
                         device=device)
        self.proj = Dense(units, flatten=False, in_units=units, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        out = ops.multi_head_attention(q, k, v, mask, heads=self._heads)
        return self.drop(self.proj(out))


class PositionwiseFFN(nn.Module):
    """FFN with the original-BERT tanh GELU."""

    def __init__(self, units, hidden_size, dropout=0.0, device=None):
        super().__init__()
        self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                          device=device)
        self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                          device=device)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(self.ffn2(ops.gelu_tanh(self.ffn1(x))))


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None):
        super().__init__()
        self.attention = SelfAttention(units, num_heads, dropout,
                                       device=device)
        self.ln1 = LayerNorm(units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, device=device)
        self.ln2 = LayerNorm(units, device=device)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        return self.ln2(x + self.ffn(x))


class BERTEncoder(nn.Module):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 device=None):
        super().__init__()
        self._layers = []
        for i in range(num_layers):
            layer = TransformerEncoderLayer(units, hidden_size, num_heads,
                                            dropout, device=device)
            self.add_module(f"layer{i}", layer)
            self._layers.append(layer)

    def forward(self, x, mask=None):
        for layer in self._layers:
            x = layer(x, mask)
        return x


class BERTModel(nn.Module):
    """Embeddings + encoder + pooler. ``forward(tokens, token_types=None,
    valid_mask=None)`` returns ``(sequence_output, pooled_output)``."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, vocab_size=30522, max_length=512,
                 type_vocab_size=2, dropout=0.1, device=None):
        super().__init__()
        self._units = units
        self.word_embed = Embedding(vocab_size, units, device=device)
        self.token_type_embed = Embedding(type_vocab_size, units,
                                          device=device)
        self.position_embed = Embedding(max_length, units, device=device)
        self.embed_ln = LayerNorm(units, device=device)
        self.embed_drop = Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, device=device)
        self.pooler = Dense(units, activation="tanh", flatten=False,
                            in_units=units, device=device)

    def forward(self, tokens, token_types=None, valid_mask=None):
        B, S = tokens.shape[0], tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        h = self.word_embed(tokens) + self.position_embed(positions)
        if token_types is not None:
            h = h + self.token_type_embed(token_types)
        h = self.embed_drop(self.embed_ln(h))
        attn_mask = None
        if valid_mask is not None:
            # (B, S) valid-token mask -> (B, 1, 1, S) attention mask
            attn_mask = valid_mask.reshape(B, 1, 1, S)
        seq = self.encoder(h, attn_mask)
        return seq, self.pooler(seq[:, 0])

    def load_parameters(self, filename: str):
        """Load a ``.params`` file written by the JAX package's
        ``save_parameters`` (dense records only)."""
        from ...ndarray.utils import load
        named = load(filename)
        if not isinstance(named, dict):
            raise MXNetError(f"{filename} holds an unnamed array list, not "
                             "model parameters")
        load_jax_params(self, named)


def bert_base(vocab_size=30522, max_length=512, dropout=0.1, **kwargs):
    return BERTModel(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                     vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, **kwargs)


# ---------------------------------------------------------------------------
# weight carrier: JAX-package parameter dicts -> state dicts
# ---------------------------------------------------------------------------
def _to_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach().to("cpu", copy=True)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 from the JAX side
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _check_against(expected: Dict[str, tuple], got: Dict[str, tuple],
                   what: str):
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    bad = sorted(f"{k}: {got[k]} != {expected[k]}"
                 for k in set(expected) & set(got) if got[k] != expected[k])
    if missing or extra or bad:
        raise MXNetError(f"parameters do not match {what}: missing {missing}, "
                         f"extra {extra}, shape mismatches {bad}")


def _bert_shapes(named: Dict[str, tuple]) -> Dict[str, tuple]:
    """The full key -> shape set of the BERTModel whose sizes ``named``
    implies (vocab, units, max length, type vocab, layers, FFN width)."""
    try:
        vocab, units = named["word_embed.weight"]
        max_length = named["position_embed.weight"][0]
        type_vocab = named["token_type_embed.weight"][0]
        hidden = named["encoder.layer0.ffn.ffn1.weight"][0]
    except (KeyError, ValueError, IndexError) as e:
        raise MXNetError(f"not a BERTModel parameter set: {e!r}") from None
    layers = 1 + max(int(m.group(1)) for m in
                     (re.match(r"encoder\.layer(\d+)\.", k) for k in named)
                     if m)   # layer0 exists: its FFN was read above
    ref = BERTModel(num_layers=layers, units=units, hidden_size=hidden,
                    num_heads=1, vocab_size=vocab, max_length=max_length,
                    type_vocab_size=type_vocab, device="meta")
    return {k: tuple(v.shape) for k, v in ref.state_dict().items()}


def params_from_jax(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """State dict (CPU tensors, the arrays' own dtypes) from the JAX
    package's ``{_collect_params_with_prefix() name: array}``. Raises
    MXNetError unless the names and shapes are exactly those of one
    BERTModel."""
    shapes = {k: tuple(np.shape(v)) for k, v in named.items()}
    _check_against(_bert_shapes(shapes), shapes, "a BERTModel")
    return {k: _to_tensor(v) for k, v in named.items()}


def load_jax_params(model: nn.Module, named: Dict[str, np.ndarray]):
    """Copy a JAX-package parameter dict into ``model`` (cast to each
    parameter's dtype and device). Raises MXNetError on any missing key,
    extra key or shape mismatch, before anything is copied."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in named.items()}
    _check_against(want, got, type(model).__name__)
    model.load_state_dict({k: _to_tensor(v) for k, v in named.items()},
                          strict=True)
