"""A BERT encoder written with the symbolic API, and the weight carrier
from the port's Gluon ``BERTModel``.

``symbol_bert(sym, ...)`` composes, with the symbol module it is given
(the port's ``mxnet_tpu_torch.symbol`` or the reference's
``mxnet_tpu.symbol``: this module imports neither), the encoder of
``gluon.model_zoo.bert.BERTModel`` from registry ops both packages have:
word, position and token-type ``Embedding`` (positions from
``arange_like``, token types 0 from ``zeros_like``), ``LayerNorm``,
``Dropout``, and per layer one QKV ``FullyConnected(flatten=False)`` split
into three, unmasked ``multi_head_attention`` (the attention kernels on
the card), the output projection, the tanh GELU (``gelu_tanh``) and the
post-LN residual adds, as the Gluon layers run them. On top: a
``FullyConnected`` over the first token and ``SoftmaxOutput``. Every node
is named, so both packages build the same graph. Inputs: ``data`` (B, S)
token ids, ``softmax_label`` (B,).

``gluon_arg_params(named)`` maps the Gluon model's parameter names
(``_collect_params_with_prefix()``) onto the graph's argument names; the
pooler has no counterpart and is left out.
"""
from __future__ import annotations

__all__ = ["symbol_bert", "encoder_output_name", "encoder_output",
           "gluon_arg_params"]


def _layer_prefix(i: int) -> str:
    return f"layer{i}_"


def encoder_output_name(layers: int) -> str:
    """The ``get_internals()`` output name of the encoder's last layer."""
    return f"{_layer_prefix(layers - 1)}ln2_output"


def encoder_output(net, layers: int):
    """The encoder's output symbol among ``net.get_internals()``: the
    (B, S, units) sequence output the Gluon model returns first."""
    internals = net.get_internals()
    return internals[internals.list_outputs().index(
        encoder_output_name(layers))]


def symbol_bert(sym, layers=12, units=768, heads=12, ffn=3072, seq=128,
                vocab=30522, classes=2, dropout=0.1):
    """The BERT encoder and a first-token classifier as one Symbol built
    with ``sym``; ``seq`` is the position table's length (the longest
    sequence the graph takes)."""
    data = sym.var("data")
    h = sym.Embedding(data, input_dim=vocab, output_dim=units,
                      name="word_embed")
    positions = sym.arange_like(data, axis=1, name="position_ids")
    h = sym.broadcast_add(h, sym.Embedding(
        positions, input_dim=seq, output_dim=units, name="position_embed"),
        name="embed_add_position")
    token_types = sym.zeros_like(data, name="token_type_ids")
    h = sym.broadcast_add(h, sym.Embedding(
        token_types, input_dim=2, output_dim=units, name="token_type_embed"),
        name="embed_add_token_type")
    h = sym.Dropout(sym.LayerNorm(h, name="embed_ln"), p=dropout,
                    name="embed_drop")
    for i in range(layers):
        pre = _layer_prefix(i)
        qkv = sym.FullyConnected(h, num_hidden=3 * units, flatten=False,
                                 name=f"{pre}qkv")
        qkv = sym.split(qkv, num_outputs=3, axis=-1, name=f"{pre}qkv_split")
        att = sym.multi_head_attention(qkv[0], qkv[1], qkv[2], heads=heads,
                                       name=f"{pre}attention")
        att = sym.Dropout(sym.FullyConnected(
            att, num_hidden=units, flatten=False, name=f"{pre}proj"),
            p=dropout, name=f"{pre}proj_drop")
        h = sym.LayerNorm(sym.broadcast_add(h, att, name=f"{pre}add1"),
                          name=f"{pre}ln1")
        f = sym.FullyConnected(h, num_hidden=ffn, flatten=False,
                               name=f"{pre}ffn1")
        f = sym.FullyConnected(sym.gelu_tanh(f, name=f"{pre}gelu"),
                               num_hidden=units, flatten=False,
                               name=f"{pre}ffn2")
        f = sym.Dropout(f, p=dropout, name=f"{pre}ffn_drop")
        h = sym.LayerNorm(sym.broadcast_add(h, f, name=f"{pre}add2"),
                          name=f"{pre}ln2")
    first = sym.slice_axis(h, axis=1, begin=0, end=1, name="first_token")
    logits = sym.FullyConnected(first, num_hidden=classes, name="cls")
    return sym.SoftmaxOutput(logits, name="softmax")


_EMBED = {"word_embed.weight": "word_embed_weight",
          "position_embed.weight": "position_embed_weight",
          "token_type_embed.weight": "token_type_embed_weight",
          "embed_ln.gamma": "embed_ln_gamma",
          "embed_ln.beta": "embed_ln_beta"}
_LAYER = {"attention.qkv": "qkv", "attention.proj": "proj", "ln1": "ln1",
          "ffn.ffn1": "ffn1", "ffn.ffn2": "ffn2", "ln2": "ln2"}


def gluon_arg_params(named):
    """``{graph argument name: value}`` for the Gluon ``BERTModel``'s
    ``{parameter name: value}`` (any value type; the pooler's are
    dropped)."""
    out = {}
    for name, value in named.items():
        if name in _EMBED:
            out[_EMBED[name]] = value
            continue
        parts = name.split(".")
        if parts[0] == "pooler":
            continue
        if parts[0] != "encoder" or not parts[1].startswith("layer"):
            raise KeyError(f"gluon_arg_params: no graph argument for {name}")
        block = _LAYER[".".join(parts[2:-1])]
        out[f"{_layer_prefix(int(parts[1][5:]))}{block}_{parts[-1]}"] = value
    return out
