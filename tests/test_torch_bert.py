"""The port's BERT path (mxnet_tpu_torch.ops.nn and gluon.model_zoo.bert)
against the JAX package on the CPU, at a small size.

Inputs and weights are made with numpy from a seed and handed to both
packages. f32 results agree within 1e-4 (1e-5 for single ops): both sides
are true fp32, sums run in another order. bf16 LayerNorm agrees within
2e-2: outputs are rounded to bf16 (one ulp near 2 is 1.6e-2)."""
import numpy as onp
import pytest

import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.ops.nn import layer_norm as jax_layer_norm
from mxnet_tpu.ops.nn import multi_head_attention as jax_mha
from mxnet_tpu.ops.registry import get_op

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import cpu as mx_cpu
from mxnet_tpu_torch.gluon.model_zoo.bert import (
    BERTModel, load_jax_params, params_from_jax)
from mxnet_tpu_torch.ops import nn as ops

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
             vocab_size=100, max_length=64, dropout=0.0)


@pytest.mark.parametrize("mode", ["none", "causal", "mask"])
def test_multi_head_attention_matches_jax(mode):
    rng = onp.random.RandomState(0)
    N, L, H, D = 2, 48, 4, 16
    q, k, v = (rng.randn(N, L, H * D).astype(onp.float32) for _ in range(3))
    mask = None
    if mode == "mask":
        mask = (rng.rand(N, 1, 1, L) > 0.3)
        mask[..., 0] = True
    causal = mode == "causal"
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if mask is None else jnp.asarray(mask), heads=H,
                   causal=causal)
    got = ops.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), heads=H,
        causal=causal)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-5)


@pytest.mark.parametrize("recipe", ["f32", "bf16_reduce", "bf16_two_pass"])
def test_layer_norm_matches_jax(recipe, monkeypatch):
    rng = onp.random.RandomState(1)
    x = (3.0 + rng.randn(4, 8, 96)).astype(onp.float32)
    gamma = (1 + 0.1 * rng.randn(96)).astype(onp.float32)
    beta = (0.1 * rng.randn(96)).astype(onp.float32)
    if recipe == "bf16_two_pass":      # both packages read the same flag
        monkeypatch.setenv("MXNET_BN_BF16_REDUCE", "0")
    jdt, tdt = ((jnp.float32, torch.float32) if recipe == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_layer_norm(jnp.asarray(x, dtype=jdt), jnp.asarray(gamma),
                          jnp.asarray(beta))
    got = ops.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                         torch.from_numpy(beta))
    assert got.dtype == tdt
    tol = 1e-5 if recipe == "f32" else 2e-2
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.astype(jnp.float32)),
                                rtol=0, atol=tol)


def test_gelu_tanh_matches_jax():
    x = onp.random.RandomState(2).randn(1000).astype(onp.float32) * 4
    want = get_op("gelu_tanh").fn(jnp.asarray(x))
    got = ops.gelu_tanh(torch.from_numpy(x))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), rtol=0,
                                atol=1e-6)


def _jax_bert(seed=0, **kw):
    """A small JAX BERTModel with seeded numpy weights; returns
    (net, {name: array})."""
    net = JaxBERT(**{**SMALL, **kw})
    net.initialize()
    tok = mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32")
    net(tok, tok)                      # materialize deferred shapes
    rng = onp.random.RandomState(seed)
    named = {}
    for name, p in net._collect_params_with_prefix().items():
        a = (0.1 * rng.randn(*p.shape)).astype(onp.float32)
        if name.endswith("gamma"):
            a += 1.0
        p.set_data(mx.nd.array(a))
        named[name] = a
    return net, named


def _tokens(seed, rows, seq):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab_size"], (rows, seq)).astype(onp.int32),
            rng.randint(0, 2, (rows, seq)).astype(onp.int32))


def test_small_bert_matches_jax():
    jnet, named = _jax_bert()
    tnet = BERTModel(**SMALL)
    tnet.load_state_dict(params_from_jax(named))
    tnet.eval()
    tok, typ = _tokens(3, 3, 40)
    j_seq, j_pooled = jnet(mx.nd.array(tok, dtype="int32"),
                           mx.nd.array(typ, dtype="int32"))
    with torch.inference_mode():
        t_seq, t_pooled = tnet(torch.from_numpy(tok), torch.from_numpy(typ))
    assert tuple(t_seq.shape) == (3, 40, 64) and tuple(t_pooled.shape) == (3, 64)
    onp.testing.assert_allclose(t_seq.numpy(), j_seq.asnumpy(), rtol=0,
                                atol=1e-4)
    onp.testing.assert_allclose(t_pooled.numpy(), j_pooled.asnumpy(), rtol=0,
                                atol=1e-4)


def test_state_dict_keys_are_the_jax_names():
    _, named = _jax_bert()
    tnet = BERTModel(**SMALL)
    tnet.initialize(ctx=mx_cpu())
    assert set(tnet.state_dict()) == set(named)
    assert set(tnet._collect_params_with_prefix()) == set(named)
    assert "encoder.layer0.attention.qkv.weight" in named


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_weight_carrier_refuses_mismatch(fault):
    _, named = _jax_bert()
    bad = dict(named)
    if fault == "missing":
        del bad["encoder.layer1.ln2.beta"]
    elif fault == "extra":
        bad["encoder.layer1.ffn.ffn3.weight"] = onp.zeros((4, 4), onp.float32)
    else:
        bad["pooler.weight"] = onp.zeros((64, 32), onp.float32)
    with pytest.raises(MXNetError, match=fault if fault != "shape" else "shape"):
        params_from_jax(bad)
    tnet = BERTModel(**SMALL)
    tnet.initialize(ctx=mx_cpu())
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    with pytest.raises(MXNetError):
        load_jax_params(tnet, bad)
    for k, v in tnet.state_dict().items():    # nothing was copied
        assert torch.equal(v, before[k])


def test_load_jax_params_refuses_other_depth():
    _, named = _jax_bert()
    with pytest.raises(MXNetError, match="missing"):
        load_jax_params(BERTModel(**{**SMALL, "num_layers": 3}), named)


def test_load_parameters_from_jax_checkpoint(tmp_path):
    jnet, named = _jax_bert(seed=5)
    path = str(tmp_path / "bert.params")
    jnet.save_parameters(path)
    tnet = BERTModel(**SMALL)
    tnet.load_parameters(path, ctx=mx_cpu())
    want = params_from_jax(named)
    got = tnet.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_params_reader_refuses_sparse_records(tmp_path):
    from mxnet_tpu.ndarray.utils import save as jax_save
    from mxnet_tpu.sparse import RowSparseNDArray
    from mxnet_tpu_torch.ndarray.utils import read
    path = str(tmp_path / "sparse.params")
    dense = mx.nd.array(onp.ones((2, 3), onp.float32))
    rs = RowSparseNDArray(onp.ones((1, 3), onp.float32),
                          onp.array([1], onp.int32), (4, 3), ctx=mx.cpu())
    jax_save(path, {"dense": dense, "sparse": rs})
    with pytest.raises(MXNetError, match="sparse"):
        read(path)


def test_params_reader_reads_bf16_and_ints(tmp_path):
    from mxnet_tpu.ndarray.utils import save as jax_save
    from mxnet_tpu_torch.ndarray.utils import read
    path = str(tmp_path / "mixed.params")
    x = onp.arange(6, dtype=onp.float32).reshape(2, 3) / 7
    jax_save(path, {"w": mx.nd.array(x).astype("bfloat16"),
                    "i": mx.nd.array(onp.arange(5), dtype="int32")})
    got = read(path)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.from_numpy(x).to(torch.bfloat16))
    onp.testing.assert_array_equal(got["i"], onp.arange(5, dtype=onp.int32))
