"""The port's serving path (mxnet_tpu_torch.serving) on the CPU with a small
BERT: threaded clients against the direct forward, the same rows against
the JAX package's ModelEndpoint.run_batch (f32 within 1e-4: both true fp32,
sums in another order), bucket padding, admission control, deadlines,
drain, and the default context."""
import sys
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JaxBERT
from mxnet_tpu.serving import ModelEndpoint as JaxEndpoint

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel, params_from_jax

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

SMALL = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
             vocab_size=100, max_length=64, dropout=0.0)
SEQ = 32


def _weights(seed=0):
    rng = onp.random.RandomState(seed)
    shapes = {k: p.shape for k, p in
              BERTModel(**SMALL)._collect_params_with_prefix().items()}
    named = {}
    for k, shp in shapes.items():
        a = (0.1 * rng.randn(*shp)).astype(onp.float32)
        named[k] = a + 1.0 if k.endswith("gamma") else a
    return named


def _port_net(named):
    net = BERTModel(**SMALL)
    net.load_state_dict(params_from_jax(named))
    return net.eval()


def _rows(rng, rows):
    return (rng.randint(0, SMALL["vocab_size"], (rows, SEQ)).astype(onp.int32),
            rng.randint(0, 2, (rows, SEQ)).astype(onp.int32))


def _direct(net, tok, typ):
    with torch.inference_mode():
        return net(torch.from_numpy(tok), torch.from_numpy(typ))


def _endpoint(name, net, **kw):
    return serving.ModelEndpoint(name, net, [(SEQ,), (SEQ,)], dtype="int32",
                                 max_batch_size=kw.pop("max_batch_size", 8),
                                 ctx=mt.cpu(), **kw)


def test_threaded_clients_match_direct_forward():
    named = _weights()
    net = _port_net(named)
    ep = _endpoint("bert", net)
    server = serving.InferenceServer(batch_timeout_ms=2.0)
    server.register(ep)
    server.start()
    results, errors = [], []
    lock = threading.Lock()

    def client(i):
        rng = onp.random.RandomState(100 + i)
        try:
            for _ in range(4):
                tok, typ = _rows(rng, int(rng.randint(1, 5)))
                seq, pooled = server.predict("bert", (tok, typ), timeout=60)
                with lock:
                    results.append((tok, typ, seq, pooled))
        except Exception as e:       # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)      # interleave the clients finely
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
        server.stop(drain=True)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(results) == 32
    for tok, typ, seq, pooled in results:
        assert seq.device.type == "cpu" and seq.shape == (len(tok), SEQ, 64)
        d_seq, d_pooled = _direct(net, tok, typ)
        onp.testing.assert_allclose(seq.numpy(), d_seq.numpy(), rtol=0,
                                    atol=1e-5)
        onp.testing.assert_allclose(pooled.numpy(), d_pooled.numpy(),
                                    rtol=0, atol=1e-5)
    c = ep.stats.snapshot()["counters"]
    assert c["submitted"] == c["completed"] == 32
    assert c["real_rows"] == sum(len(r[0]) for r in results)
    assert c["warmup_batches"] == 1 + len(ep.buckets)   # probe + warm-up


def test_served_rows_match_jax_run_batch():
    named = _weights(seed=1)
    jnet = JaxBERT(**SMALL)
    jnet.initialize()
    z = mx.nd.array(onp.zeros((1, SEQ), onp.int32), dtype="int32")
    jnet(z, z)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(named[k]))
    jep = JaxEndpoint("torch_port_parity_bert", jnet, [(SEQ,), (SEQ,)],
                      dtype="int32", max_batch_size=8, ctx=mx.cpu())
    ep = _endpoint("bert", _port_net(named))
    server = serving.InferenceServer()
    server.register(ep)
    server.start()
    try:
        tok, typ = _rows(onp.random.RandomState(7), 5)
        seq, pooled = server.predict("bert", (tok, typ), timeout=60)
    finally:
        server.stop(drain=True)
    j_outs, bucket = jep.run_batch((tok, typ), 5)
    assert bucket == 8
    onp.testing.assert_allclose(seq.numpy(), onp.asarray(j_outs[0])[:5],
                                rtol=0, atol=1e-4)
    onp.testing.assert_allclose(pooled.numpy(), onp.asarray(j_outs[1])[:5],
                                rtol=0, atol=1e-4)


def test_bucket_padding_keeps_rows_apart():
    net = _port_net(_weights())
    ep = _endpoint("bert", net)
    assert ep.buckets == (1, 2, 4, 8)
    tok, typ = _rows(onp.random.RandomState(3), 3)
    outs, bucket = ep.run_batch((tok, typ), 3)
    assert bucket == 4 and outs[0].shape[0] == 4
    d_seq, _ = _direct(net, tok, typ)
    onp.testing.assert_allclose(outs[0][:3].numpy(), d_seq.numpy(), rtol=0,
                                atol=1e-5)
    c = ep.stats.snapshot()["counters"]
    assert (c["batches"], c["real_rows"], c["padded_rows"]) == (1, 3, 1)


def test_single_example_resolves_without_batch_axis():
    net = _port_net(_weights())
    server = serving.InferenceServer()
    server.register(_endpoint("bert", net))
    server.start()
    try:
        tok, typ = _rows(onp.random.RandomState(4), 1)
        seq, pooled = server.predict("bert", (tok[0], typ[0]), timeout=60)
    finally:
        server.stop(drain=True)
    assert seq.shape == (SEQ, 64) and pooled.shape == (64,)


def test_overload_then_drain_resolves_everything():
    net = _port_net(_weights())
    ep = _endpoint("bert", net)
    server = serving.InferenceServer(batch_timeout_ms=60_000, max_queue=4)
    server.register(ep, warmup=False)
    server.start()
    rng = onp.random.RandomState(5)
    futs = [server.submit("bert", _rows(rng, 2)) for _ in range(2)]
    with pytest.raises(serving.ServerOverloadError):
        server.submit("bert", _rows(rng, 1))
    server.stop(drain=True, timeout=60)
    for f in futs:
        seq, _ = f.result(timeout=0)          # resolved by the drain
        assert seq.shape == (2, SEQ, 64)
    assert ep.stats.snapshot()["counters"]["rejected"] == 1
    with pytest.raises(serving.ServerClosedError):
        server.submit("bert", _rows(rng, 1))


def test_expired_deadline_fails_at_assembly():
    server = serving.InferenceServer(batch_timeout_ms=60_000)
    ep = _endpoint("bert", _port_net(_weights()))
    server.register(ep, warmup=False)
    server.start()
    rng = onp.random.RandomState(6)
    late = server.submit("bert", _rows(rng, 1), deadline_ms=1.0)
    ok = server.submit("bert", _rows(rng, 1))
    time.sleep(0.02)
    server.stop(drain=True, timeout=60)
    with pytest.raises(serving.RequestTimeoutError):
        late.result(timeout=0)
    assert ok.result(timeout=0)[0].shape == (1, SEQ, 64)
    assert ep.stats.snapshot()["counters"]["deadline_drops"] == 1


def test_stop_without_drain_fails_queued():
    server = serving.InferenceServer(batch_timeout_ms=60_000)
    server.register(_endpoint("bert", _port_net(_weights())), warmup=False)
    server.start()
    fut = server.submit("bert", _rows(onp.random.RandomState(8), 1))
    server.stop(drain=False, timeout=60)
    with pytest.raises(serving.ServerClosedError):
        fut.result(timeout=0)


@pytest.mark.parametrize("bad", ["shape", "rows", "arity"])
def test_malformed_requests_raise(bad):
    server = serving.InferenceServer()
    server.register(_endpoint("bert", _port_net(_weights())), warmup=False)
    server.start()
    tok, typ = _rows(onp.random.RandomState(9), 1)
    try:
        with pytest.raises(mt.MXNetError):
            if bad == "shape":
                server.submit("bert", (tok[:, :5], typ[:, :5]))
            elif bad == "rows":
                server.submit("bert", (onp.repeat(tok, 9, 0),
                                       onp.repeat(typ, 9, 0)))
            else:
                server.submit("bert", tok)
    finally:
        server.stop(drain=True)


def test_default_context_is_the_card():
    assert mt.current_context() == mt.gpu(0)
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
    assert mt.current_context() == mt.gpu(0)


def test_endpoint_without_ctx_runs_on_the_card_or_raises():
    net = _port_net(_weights())
    if torch.cuda.is_available():
        ep = serving.ModelEndpoint("bert", net, [(SEQ,), (SEQ,)],
                                   dtype="int32", max_batch_size=2)
        assert ep.device.type == "cuda"
        return
    with pytest.raises(mt.MXNetError, match="CUDA is not available"):
        serving.ModelEndpoint("bert", net, [(SEQ,), (SEQ,)], dtype="int32",
                              max_batch_size=2)
