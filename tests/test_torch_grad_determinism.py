"""``mxnet_tpu_torch/tools/grad_determinism.py`` on the CPU at a small size
(a 2-layer BERT, 64 wide): its parts find no difference where the
computation repeats bit for bit, and name the leaf where a difference is
planted."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import bert as bz
from mxnet_tpu_torch.tools import grad_determinism as gd

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=2)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(gd, "_model", lambda dropout=0.1: bz.BERTForPretraining(
        bz.BERTModel(**SMALL, dropout=dropout, max_length=16)))
    for name, value in (("BATCH", 4), ("SEQ", 16), ("P", 3), ("UNITS", 64)):
        monkeypatch.setattr(gd, name, value)
    with mt.cpu():
        yield


def test_embedding_backward_repeats(small):
    out = gd.embedding_repeats(torch.device("cpu"))
    assert sorted(out) == [2, 16, 30522]
    assert all(v["same"] and v["max_abs_diff"] == 0 for v in out.values())


def test_one_process_gradients_repeat(small):
    named = gd.seeded_bert_weights(gd._model(), 0)
    differ, alerts = gd.process_repeats(named, gd._batches(0))
    assert differ == [{}] * gd.BATCHES
    assert alerts == []


def test_a_planted_difference_is_named(small, monkeypatch):
    """Every second call's gradient of the token-type table moved by one
    f32 ulp: each batch names that leaf alone."""
    own, calls = gd.gradients, []

    def planted(step, batches, i):
        grads = own(step, batches, i)
        calls.append(i)
        if len(calls) % 2 == 0:
            j = step._names.index("inner.backbone.token_type_embed.weight")
            grads[j] = torch.nextafter(grads[j], torch.full_like(
                grads[j], onp.inf))
        return grads
    monkeypatch.setattr(gd, "gradients", planted)
    named = gd.seeded_bert_weights(gd._model(), 0)
    differ, _ = gd.process_repeats(named, gd._batches(0))
    assert [list(d) for d in differ] == \
        [["inner.backbone.token_type_embed.weight"]] * gd.BATCHES
