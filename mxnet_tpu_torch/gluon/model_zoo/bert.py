"""BERT of the port: the counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``
from ``SelfAttention`` through ``BERTModel`` and ``bert_base`` to the
pretraining heads ``BERTForPretraining`` and ``BERTPretrainingLoss``, and the
decoder-only ``TransformerLM`` that the generative serving path serves.

The module tree mirrors the JAX block tree, so ``state_dict()`` keys equal
the JAX package's ``_collect_params_with_prefix()`` names (for example
``encoder.layer0.attention.qkv.weight``, ``backbone.word_embed.weight`` or
``mlm_ln.gamma``). Weights cross over as numpy
arrays through the weight carrier (``carrier.py``, re-exported here):
:func:`params_from_jax` turns such a dict into a state dict and
:func:`load_jax_params` loads it into a model, both refusing missing keys,
extra keys and shape mismatches; ``BERTModel.load_parameters`` reads a
``.params`` file the JAX package wrote.

Attention runs through ``ops.nn.multi_head_attention``: with no padding mask
every layer's attention is one call of the hand-written flash-attention
kernels on the card (K1 forward; K2 + K3 in the backward), causal for
``TransformerLM`` (its forward and its prefill). A decode step attends one
token against cached context with ``ops.nn.single_query_attention``.
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
from .carrier import check_against, load_jax_params, params_from_jax, \
    to_tensor

__all__ = ["SelfAttention", "PositionwiseFFN", "TransformerEncoderLayer",
           "BERTEncoder", "BERTModel", "BERTForPretraining",
           "BERTPretrainingLoss", "TransformerLM", "bert_base",
           "params_from_jax", "load_jax_params"]


class SelfAttention(nn.Module):
    """Multi-head self-attention with one fused QKV projection.

    ``causal=True`` bakes the causal mask into attention (TransformerLM);
    the block then also offers the two incremental-decode views the
    generative serving engine runs: ``forward_collect`` (the prefill) and
    ``attend_step`` (one token against cached context)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 device=None):
        super().__init__()
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self.qkv = Dense(3 * units, flatten=False, in_units=units,
                         device=device)
        self.proj = Dense(units, flatten=False, in_units=units, device=device)
        self.drop = Dropout(dropout)

    def forward(self, x, mask=None):
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        out = ops.multi_head_attention(q, k, v, mask, heads=self._heads,
                                       causal=self._causal)
        return self.drop(self.proj(out))

    def forward_collect(self, x, mask=None):
        """The forward, also returning the (B, S, H*D) key and value
        projections (views of the QKV output) for the KV cache."""
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        out = ops.multi_head_attention(q, k, v, mask, heads=self._heads,
                                       causal=self._causal)
        return self.drop(self.proj(out)), k, v

    def attend_step(self, x, k_ctx, v_ctx, lengths):
        """One decode step: ``x`` (R, H*D) is the current token's hidden
        state, ``k_ctx``/``v_ctx`` (B, L, H*D) the cached context of the
        first B <= R rows and ``lengths`` (R,) each row's cached positions
        (== its token's position). Rows past B only pad the projections to
        R rows: they attend nothing (a zero attention output). Returns
        (out, k_new, v_new), R rows each."""
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        B = k_ctx.shape[0]
        out = ops.single_query_attention(q[:B], k_ctx, v_ctx, k[:B], v[:B],
                                         lengths[:B], heads=self._heads)
        if B < x.shape[0]:
            out = torch.cat([out, out.new_zeros(x.shape[0] - B,
                                                out.shape[1])])
        return self.drop(self.proj(out)), k, v


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
                 causal=False, device=None):
        super().__init__()
        self.attention = SelfAttention(units, num_heads, dropout,
                                       causal=causal, device=device)
        self.ln1 = LayerNorm(units, device=device)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, device=device)
        self.ln2 = LayerNorm(units, device=device)

    def forward(self, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        return self.ln2(x + self.ffn(x))

    def forward_collect(self, x, mask=None):
        """The layer's forward, plus its (B, S, H*D) K/V for the cache."""
        a, k, v = self.attention.forward_collect(x, mask)
        x = self.ln1(x + a)
        return self.ln2(x + self.ffn(x)), k, v

    def decode_step(self, x, k_ctx, v_ctx, lengths):
        """One token per row, (R, H*D), against cached context (see
        ``SelfAttention.attend_step``); the residual and post-LN structure
        of ``forward``, every op per row."""
        a, k, v = self.attention.attend_step(x, k_ctx, v_ctx, lengths)
        x = self.ln1(x + a)
        return self.ln2(x + self.ffn(x)), k, v


class BERTEncoder(nn.Module):
    def __init__(self, num_layers, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, device=None):
        super().__init__()
        self._layers = []
        for i in range(num_layers):
            layer = TransformerEncoderLayer(units, hidden_size, num_heads,
                                            dropout, causal=causal,
                                            device=device)
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


class BERTForPretraining(nn.Module):
    """MLM + NSP heads over a :class:`BERTModel`.

    ``forward(tokens, token_types=None, valid_mask=None,
    masked_positions=None)`` returns ``(mlm_logits, nsp_logits)``. With
    ``masked_positions`` (B, P) the MLM transform and the vocab decoder run
    only at those rows, (B, P, V) logits instead of (B, S, V); the rows are
    gathered with ``torch.gather`` (the reference's one-hot batched matmul is
    a TPU choice; both pick the same rows exactly). The decoder is tied to
    ``backbone.word_embed.weight`` and has no bias."""

    def __init__(self, backbone: BERTModel, vocab_size=30522, device=None):
        super().__init__()
        self._vocab = vocab_size
        units = backbone._units
        self.backbone = backbone
        self.mlm_transform = Dense(units, flatten=False, in_units=units,
                                   device=device)
        self.mlm_ln = LayerNorm(units, device=device)
        self.nsp = Dense(2, flatten=False, in_units=units, device=device)

    def forward(self, tokens, token_types=None, valid_mask=None,
                masked_positions=None):
        seq, pooled = self.backbone(tokens, token_types, valid_mask)
        if masked_positions is not None:
            idx = masked_positions.long().unsqueeze(-1).expand(
                -1, -1, seq.shape[-1])
            seq = torch.gather(seq, 1, idx)                 # (B, P, U)
        h = self.mlm_ln(ops.gelu(self.mlm_transform(seq)))
        mlm = torch.matmul(h, self.backbone.word_embed.weight.t())
        return mlm, self.nsp(pooled)


class BERTPretrainingLoss(nn.Module):
    """Masked-LM + NSP loss. ``mlm_labels`` uses -1 for unmasked (ignored)
    positions; the MLM term is the mean over labelled positions (at least
    one), the NSP term the mean over the batch. Each term keeps the
    reference's dtypes: log-softmax in f32, cast back to the logits'
    dtype."""

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels):
        logp = ops.log_softmax(mlm_logits, axis=-1)
        labels = mlm_labels.long()
        picked = ops.pick(logp, labels.clamp_min(0), axis=-1)
        valid = (labels >= 0).float()
        mlm_loss = -(picked * valid).sum() / valid.sum().clamp_min(1.0)
        nsp_logp = ops.log_softmax(nsp_logits, axis=-1)
        nsp_loss = -ops.pick(nsp_logp, nsp_labels, axis=-1).mean()
        return mlm_loss + nsp_loss


class TransformerLM(nn.Module):
    """Decoder-only causal language model over the BERT encoder stack: the
    post-LN layers with the causal mask, word + position embeddings and an
    LM head tied to the word embedding (``word_embed.weight``, no bias).
    Three entry points share one parameter set:

    - ``forward(tokens)``: full causal pass, (B, S) -> (B, S, V) logits;
    - ``prefill_collect(tokens)``: the same pass, also returning every
      layer's (B, S, H*D) K/V (the generative engine's prefill);
    - ``decode_step(ids, positions, *kv_ctx)``: one token per row against
      cached context (the engine's decode step); ``positions`` is both the
      position-embedding index and the cached length.

    ``num_layers``, ``units`` and ``max_length`` are the attributes the
    decode engine reads."""

    def __init__(self, num_layers=2, units=64, hidden_size=128, num_heads=2,
                 vocab_size=256, max_length=128, dropout=0.0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.units = units
        self.num_heads = num_heads
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.word_embed = Embedding(vocab_size, units, device=device)
        self.position_embed = Embedding(max_length, units, device=device)
        self.embed_ln = LayerNorm(units, device=device)
        self.embed_drop = Dropout(dropout)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, causal=True, device=device)

    def _embed(self, ids, positions):
        h = self.word_embed(ids) + self.position_embed(positions)
        return self.embed_drop(self.embed_ln(h))

    def _head(self, h):
        return torch.matmul(h, self.word_embed.weight.t())

    def forward(self, tokens):
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self._head(self.encoder(self._embed(tokens, positions)))

    def prefill_collect(self, tokens):
        """(B, S) tokens -> (logits (B, S, V), k_0, v_0, ..., k_{n-1},
        v_{n-1}), each k/v (B, S, H*D)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        h = self._embed(tokens, positions)
        kvs = []
        for layer in self.encoder._layers:
            h, k, v = layer.forward_collect(h)
            kvs.extend((k, v))
        return (self._head(h),) + tuple(kvs)

    def decode_step(self, ids, positions, *kv_ctx):
        """One decode step. ``ids``/``positions`` (R,) integers; ``kv_ctx``
        is ``(k_ctx_0, v_ctx_0, ...)``, one pair per layer, each (B, L, H*D)
        gathered from the KV pool for the first B <= R rows. Rows past B
        pad the matrix products to R rows and attend nothing (see
        ``SelfAttention.attend_step``). Returns (logits (R, V), k_new_0,
        v_new_0, ...), each new k/v (R, H*D)."""
        h = self._embed(ids, positions)
        kvs = []
        for i, layer in enumerate(self.encoder._layers):
            h, k, v = layer.decode_step(h, kv_ctx[2 * i], kv_ctx[2 * i + 1],
                                        positions)
            kvs.extend((k, v))
        return (self._head(h),) + tuple(kvs)


def bert_base(vocab_size=30522, max_length=512, dropout=0.1, **kwargs):
    return BERTModel(num_layers=12, units=768, hidden_size=3072, num_heads=12,
                     vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, **kwargs)


# ---------------------------------------------------------------------------
# weight carrier: the BERT shapes a JAX-package parameter dict implies
# ---------------------------------------------------------------------------
def _kind(named) -> str:
    """Which model a parameter dict names: "BERTForPretraining" (names under
    ``backbone.``), "TransformerLM" (no token-type embedding, no pooler) or
    "BERTModel"."""
    if any(k.startswith("backbone.") for k in named):
        return "BERTForPretraining"
    if "token_type_embed.weight" not in named and \
            not any(k.startswith("pooler.") for k in named):
        return "TransformerLM"
    return "BERTModel"


def _bert_shapes(named: Dict[str, tuple]) -> Dict[str, tuple]:
    """The full key -> shape set of the model :func:`_kind` names whose
    sizes ``named`` implies (vocab, units, max length, type vocab, layers,
    FFN width)."""
    kind = _kind(named)
    pre = "backbone." if kind == "BERTForPretraining" else ""
    try:
        vocab, units = named[pre + "word_embed.weight"]
        max_length = named[pre + "position_embed.weight"][0]
        hidden = named[pre + "encoder.layer0.ffn.ffn1.weight"][0]
        if kind != "TransformerLM":
            type_vocab = named[pre + "token_type_embed.weight"][0]
    except (KeyError, ValueError, IndexError) as e:
        raise MXNetError(f"not a {kind} parameter set: {e!r}") from None
    layers = 1 + max(int(m.group(1)) for m in
                     (re.match(re.escape(pre) + r"encoder\.layer(\d+)\.", k)
                      for k in named)
                     if m)   # layer0 exists: its FFN was read above
    if kind == "TransformerLM":
        ref = TransformerLM(num_layers=layers, units=units, hidden_size=hidden,
                            num_heads=1, vocab_size=vocab,
                            max_length=max_length, device="meta")
    else:
        ref = BERTModel(num_layers=layers, units=units, hidden_size=hidden,
                        num_heads=1, vocab_size=vocab, max_length=max_length,
                        type_vocab_size=type_vocab, device="meta")
    if pre:
        ref = BERTForPretraining(ref, vocab_size=vocab, device="meta")
    return {k: tuple(v.shape) for k, v in ref.state_dict().items()}


def state_from_jax(named: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """:func:`params_from_jax` for BERT-family names: raises MXNetError
    unless the names and shapes are exactly those of one BERTModel, one
    BERTForPretraining (names under ``backbone.``) or one TransformerLM
    (``word_embed``, ``position_embed``, ``embed_ln``, ``encoder.layerN``;
    no token-type embedding, no pooler)."""
    shapes = {k: tuple(np.shape(v)) for k, v in named.items()}
    check_against(_bert_shapes(shapes), shapes, "a " + _kind(shapes))
    return {k: to_tensor(v) for k, v in named.items()}
