"""The port's generative serving path (mxnet_tpu_torch.serving.generate and
InferenceServer.generate) on the CPU, with the JAX package's test config:
TransformerLM(2 layers, units 32, 2 heads, vocab 50), weights N(0, 0.5)
from a numpy seed (wide enough that greedy tokens depend on history),
crossing into the port through the weight carrier.

The load-bearing checks compare token lists exactly: batched continuous
decode (sequences joining and retiring mid-batch, pages freed and reused)
against one-sequence-at-a-time greedy decode through the same engine, and
the port's greedy tokens against the JAX package's DecodeEndpoint on the
same weights. The paged-pool helpers are held bitwise against the JAX
package's, the pool's accounting and the scheduler's streaming, cancel,
drain, validation, failover and server facade as the JAX tests hold them."""
import threading
import time

import numpy as onp
import pytest

import jax.numpy as jnp
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import TransformerLM as JaxLM
from mxnet_tpu.serving import bucketing as jax_bucketing
from mxnet_tpu.serving import generate as jax_generate
from mxnet_tpu.serving.stats import LatencyHistogram as JaxHistogram

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, config, serving
from mxnet_tpu_torch.gluon.model_zoo.bert import TransformerLM, load_jax_params
from mxnet_tpu_torch.serving import (KVPoolExhausted, ServerClosedError,
                                     bucketing)
from mxnet_tpu_torch.serving.generate import (
    DecodeEndpoint, DecodeScheduler, PagedKVPool, TokenStream, gather_ctx,
    write_prefill, write_step)
from mxnet_tpu_torch.serving.router import StepCostEWMA
from mxnet_tpu_torch.serving.stats import LatencyHistogram

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision (~1e-4 relative error in torch.exp over that
# thread's chunk); one parallel op primes the pool before any comparison.
torch.exp(torch.zeros(1 << 18))

CFG = dict(num_layers=2, units=32, hidden_size=64, num_heads=2,
           vocab_size=50, max_length=64)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [12, 13],
           [14, 15, 16, 17]]
BUDGETS = [6, 9, 4, 8, 5, 7]


def _weights(seed=0):
    """The reference test's ``mx.init.Normal(0.5)`` from a numpy seed:
    weights N(0, 0.5^2), biases and beta 0, gamma 1."""
    rng = onp.random.RandomState(seed)
    named = {}
    for k, v in TransformerLM(**CFG)._collect_params_with_prefix().items():
        if k.endswith("gamma"):
            named[k] = onp.ones(v.shape, onp.float32)
        elif k.endswith(("beta", "bias")):
            named[k] = onp.zeros(v.shape, onp.float32)
        else:
            named[k] = rng.normal(0.0, 0.5, v.shape).astype(onp.float32)
    return named


def _lm(named):
    lm = TransformerLM(**CFG)
    load_jax_params(lm, named, ctx=mt.cpu())
    return lm


def _engine(name="tlm", **kw):
    return DecodeEndpoint(name, _lm(_weights()), max_seq_len=64,
                          max_batch_size=4, page_size=8, num_pages=64,
                          ctx=mt.cpu(), **kw)


@pytest.fixture(scope="module")
def engine():
    eng = _engine()
    eng.warmup()
    return eng


def _serial_decode(eng, prompt, max_new, sid):
    """The oracle: one sequence at a time through the same engine."""
    eng.pool.reserve(sid, len(prompt) + max_new)
    toks = [eng.prefill(prompt, eng.pool.table(sid))]
    pos = len(prompt)
    for _ in range(max_new - 1):
        (t,) = eng.decode_step([(toks[-1], pos, eng.pool.table(sid))])
        toks.append(t)
        pos += 1
    eng.pool.free(sid)
    return toks


# ---------------------------------------------------------------------------
# the acceptance oracles
# ---------------------------------------------------------------------------
def test_continuous_batched_decode_bitwise_equals_serial(engine):
    """Staggered submits with different budgets: sequences join and retire
    mid-batch and pages are freed and reallocated throughout; the token
    lists must equal serial greedy decode exactly."""
    base = engine.pool.pages_in_use
    oracle = [_serial_decode(engine, p, b, 90000 + i)
              for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
    assert any(len(set(t)) > 2 for t in oracle)     # history-sensitive
    assert engine.pool.pages_in_use == base
    sched = DecodeScheduler(engine, poll_s=0.02).start()
    try:
        streams = []
        for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
            streams.append(sched.submit(p, max_new_tokens=b))
            if i == 2:
                time.sleep(0.05)      # later submits join a running batch
        results = [s.result(timeout=60) for s in streams]
    finally:
        sched.stop()
    assert results == oracle
    assert engine.pool.pages_in_use == base
    assert engine.stats.snapshot()["counters"]["seq_finished"] >= len(PROMPTS)


def test_tokens_equal_the_jax_decode_endpoint(engine):
    """The port's greedy tokens equal the JAX package's DecodeEndpoint's for
    the same prompts and weights."""
    named = _weights()
    jlm = JaxLM(**CFG)
    jlm.initialize()
    jlm(mx.nd.array(onp.zeros((1, 4), onp.int32), dtype="int32"))
    params = jlm._collect_params_with_prefix()
    assert set(params) == set(named)
    for k, p in params.items():
        p.set_data(mx.nd.array(named[k]))
    jeng = jax_generate.DecodeEndpoint("jtlm", jlm, max_seq_len=64,
                                       max_batch_size=4, page_size=8,
                                       num_pages=64)
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        want = _serial_decode(jeng, p, b, 97000 + i)
        assert _serial_decode(engine, p, b, 97100 + i) == want, (p, want)


def test_page_free_then_realloc_is_bitwise_clean(engine):
    """A second wave reuses pages the first dirtied (the LIFO free list
    guarantees reuse): stale contents must be invisible."""
    first = _serial_decode(engine, [21, 22, 23], 8, 91001)
    assert _serial_decode(engine, [21, 22, 23], 8, 91002) == first
    other = _serial_decode(engine, [31, 32], 8, 91003)
    assert _serial_decode(engine, [21, 22, 23], 8, 91004) == first
    assert other != first


def test_defrag_is_bitwise_invisible(engine):
    """Compaction mid-generation relocates live pages; decode continues
    bitwise-identically through the remapped tables."""
    oracle = _serial_decode(engine, [41, 42, 43], 8, 92000)
    engine.pool.reserve(92001, 30)              # 4 pages, low ids
    sid = 92002
    engine.pool.reserve(sid, 3 + 8)
    toks = [engine.prefill([41, 42, 43], engine.pool.table(sid))]
    pos = 3
    for i in range(7):
        if i == 3:
            engine.pool.free(92001)             # holes below sid's pages
            assert engine.pool.defrag() > 0
        (t,) = engine.decode_step([(toks[-1], pos, engine.pool.table(sid))])
        toks.append(t)
        pos += 1
    engine.pool.free(sid)
    assert toks == oracle


def test_engine_buckets_warmup_and_snapshot(engine):
    snap = engine.snapshot()
    assert snap["prefill_buckets"] == [16, 32, 64]
    assert snap["decode_buckets"] == [1, 2, 4]
    assert snap["executables"] == 6
    assert snap["stats"]["counters"]["compiles"] == 6
    assert engine.warmup() == 0                 # every bucket already ran
    assert set(engine.step_cost.snapshot()) == {1, 2, 4}
    assert set(engine.prefill_cost.snapshot()) == {16, 32, 64}
    assert snap["kv_pool"]["pages"] == 63
    assert engine.pool.k_pool.dtype == torch.float32
    assert engine.pool.k_pool.shape == (2, 64, 8, 32)


def test_warmup_writes_only_the_scratch_page():
    eng = _engine("warm")
    assert eng.warmup() == 6
    touched = (eng.pool.k_pool != 0).flatten(2).any(-1) | \
        (eng.pool.v_pool != 0).flatten(2).any(-1)      # (layers, pages)
    assert touched[:, 0].all() and not touched[:, 1:].any()


def test_engine_refuses_a_block_without_the_protocol():
    with pytest.raises(MXNetError, match="incremental-decode protocol"):
        DecodeEndpoint("bad", torch.nn.Linear(2, 2), ctx=mt.cpu())
    with pytest.raises(MXNetError, match="position-embedding"):
        DecodeEndpoint("long", _lm(_weights()), max_seq_len=128,
                       ctx=mt.cpu())


def test_entry_points_default_to_the_card():
    """Without ``ctx`` the engine and the pool take gpu(0), which raises
    on a host without CUDA instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        DecodeEndpoint("gpu", _lm(_weights()), max_seq_len=64)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        PagedKVPool("gpu", 1, 4, max_seq_len=32, page_size=8, num_pages=8)


# ---------------------------------------------------------------------------
# bucketing ladder, cost model, histogram, flags
# ---------------------------------------------------------------------------
def test_seq_buckets_ladder():
    assert bucketing.seq_buckets(64) == (16, 32, 64)
    assert bucketing.seq_buckets(100) == (16, 32, 64, 100)
    assert bucketing.seq_buckets(16) == (16,)
    assert bucketing.seq_buckets(8) == (8,)
    assert bucketing.seq_buckets(512) == (16, 32, 64, 128, 256, 512)
    assert bucketing.seq_buckets(64, ladder=[8, 64]) == (8, 64)
    for n in (1, 8, 16, 17, 100, 512, 600):
        assert bucketing.seq_buckets(n) == jax_bucketing.seq_buckets(n)
    with pytest.raises(MXNetError):
        bucketing.seq_buckets(0)
    with pytest.raises(MXNetError):
        bucketing.seq_buckets(64, ladder=[8, 32])       # largest != max
    with pytest.raises(MXNetError):
        bucketing.seq_buckets(64, ladder=[32, 16, 64])  # not ascending


def test_bucket_for_edges():
    ladder = bucketing.seq_buckets(64)
    assert bucketing.bucket_for(1, ladder) == 16
    assert bucketing.bucket_for(16, ladder) == 16       # exact boundary
    assert bucketing.bucket_for(17, ladder) == 32
    assert bucketing.bucket_for(64, ladder) == 64
    with pytest.raises(MXNetError):
        bucketing.bucket_for(65, ladder)                # over-max rejected


def test_step_cost_ewma():
    ewma = StepCostEWMA()
    assert ewma.estimate(4) == 0.0                      # empty table
    ewma.observe(2, 100.0)
    assert ewma.estimate(2) == 100.0
    assert ewma.estimate(8) == 400.0                    # row-ratio fallback
    ewma.observe(2, 200.0)
    assert ewma.estimate(2) == 125.0                    # alpha 0.25
    assert ewma.snapshot() == {2: 125.0}


def test_latency_histogram_matches_jax():
    ours, theirs = LatencyHistogram(), JaxHistogram()
    assert ours.snapshot() == theirs.snapshot()
    for d in onp.random.RandomState(7).lognormal(6.0, 2.0, 500):
        ours.record(d)
        theirs.record(d)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.percentile(50) == theirs.percentile(50)


def test_flags_read_as_the_reference(monkeypatch):
    assert config.get("MXNET_KV_PAGE_SIZE") == 16
    assert config.get("MXNET_KV_POOL_PAGES") == 256
    assert config.get("MXNET_KV_DEFRAG_RATIO") == 0.0
    assert config.get("MXNET_DECODE_MAX_BATCH") == 8
    assert config.get("MXNET_DECODE_MAX_TOKENS") == 64
    assert config.get("MXNET_DECODE_STREAM_BUFFER") == 64
    assert config.get("MXNET_DECODE_SLO_MS") == 100.0
    assert config.get("MXNET_SUPERVISOR_POLL_S") == 0.05
    assert config.get("MXNET_SERVING_DRAIN_TIMEOUT_S") == 30.0
    monkeypatch.setenv("MXNET_KV_PAGE_SIZE", "4")
    assert config.get("MXNET_KV_PAGE_SIZE") == 4
    pool = PagedKVPool("env", 1, 4, max_seq_len=16, num_pages=8,
                       ctx=mt.cpu())
    assert pool.page_size == 4 and pool.pages_per_seq == 4
    monkeypatch.setenv("MXNET_KV_PAGE_SIZE", "four")
    with pytest.raises(MXNetError):
        config.get("MXNET_KV_PAGE_SIZE")


def test_defrag_ratio_flag_compacts_on_free(monkeypatch):
    pool = PagedKVPool("auto", 1, 4, max_seq_len=32, page_size=8,
                       num_pages=16, ctx=mt.cpu())
    pool.reserve(1, 32)
    pool.reserve(2, 8)                   # pages 1-4 for sid 1, 5 for sid 2
    monkeypatch.setenv("MXNET_KV_DEFRAG_RATIO", "1.5")
    pool.free(1)                         # spread 5 / 1 > 1.5: compacts
    assert list(pool.table(2)[:1]) == [1] and pool.spread() == 1.0


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------
def test_pool_helpers_equal_the_jax_package():
    rng = onp.random.RandomState(8)
    L, N, kv, S = 2, 10, 4, 20
    pool = rng.randn(L, N, 8, kv).astype(onp.float32)
    vals = rng.randn(L, S, kv).astype(onp.float32)
    table = onp.array([3, 7, 5], onp.int32)
    want = jax_generate.write_prefill(jnp.asarray(pool), jnp.asarray(vals),
                                      jnp.asarray(table), 13, 8)
    got = write_prefill(torch.from_numpy(pool.copy()), torch.from_numpy(vals),
                        torch.from_numpy(table), 13, 8)
    # page 0 takes the padding writes in an unspecified order
    onp.testing.assert_array_equal(got.numpy()[:, 1:],
                                   onp.asarray(want)[:, 1:])
    tables = onp.array([[3, 7, 5], [1, 2, 4], [0, 0, 0]], onp.int32)
    positions = onp.array([9, 17, 0], onp.int32)
    valid = onp.array([True, True, False])
    step = rng.randn(L, 3, kv).astype(onp.float32)
    want = jax_generate.write_step(jnp.asarray(pool), jnp.asarray(step),
                                   jnp.asarray(tables),
                                   jnp.asarray(positions),
                                   jnp.asarray(valid), 8)
    got = write_step(torch.from_numpy(pool.copy()), torch.from_numpy(step),
                     torch.from_numpy(tables), torch.from_numpy(positions),
                     torch.from_numpy(valid), 8)
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))
    want = jax_generate.gather_ctx(jnp.asarray(pool), jnp.asarray(tables))
    got = gather_ctx(torch.from_numpy(pool), torch.from_numpy(tables))
    assert tuple(got.shape) == (L, 3, 3 * 8, kv)
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))


def test_pool_accounting_and_exhaustion():
    pool = PagedKVPool("acct", num_layers=1, kv_dim=4, max_seq_len=32,
                       page_size=8, num_pages=8, ctx=mt.cpu())  # 7 usable
    assert pool.pages_per_seq == 4
    pool.reserve(1, 17)                  # ceil(17/8) = 3 pages
    assert pool.pages_in_use == 3
    pool.reserve(1, 17)                  # idempotent re-reserve
    assert pool.pages_in_use == 3
    pool.reserve(2, 32)                  # 4 more -> full
    assert pool.pages_in_use == 7 and pool.occupancy() == 1.0
    with pytest.raises(KVPoolExhausted) as ei:
        pool.reserve(3, 9)
    assert "RESOURCE_EXHAUSTED" in str(ei.value)
    assert pool.free(1) == 3
    assert pool.free(1) == 0
    pool.reserve(3, 9)                   # freed pages immediately reusable
    assert pool.pages_in_use == 6
    assert 0 not in list(pool.table(2))  # page 0 is never handed out
    assert list(pool.table(3)[2:]) == [0, 0]     # padded with scratch
    with pytest.raises(MXNetError):
        pool.reserve(4, 33)              # beyond layout
    snap = pool.snapshot()
    assert snap["pages"] == 7 and snap["in_use"] == 6
    assert snap["sequences"] == 2 and snap["bytes"] == 2 * 8 * 8 * 4 * 4


def test_pool_rejects_undersized_layout():
    with pytest.raises(MXNetError):
        PagedKVPool("tiny", 1, 4, max_seq_len=64, page_size=8, num_pages=8,
                    ctx=mt.cpu())
    with pytest.raises(MXNetError):
        PagedKVPool("none", 1, 4, max_seq_len=8, page_size=8, num_pages=1,
                    ctx=mt.cpu())


# ---------------------------------------------------------------------------
# streaming: iterator, backpressure, cancel, drain, validation
# ---------------------------------------------------------------------------
def test_stream_backpressure_pauses_and_resumes(engine):
    sched = DecodeScheduler(engine, stream_buffer=2, poll_s=0.02).start()
    try:
        s = sched.submit([1, 2, 3], max_new_tokens=12)
        deadline = time.monotonic() + 30
        while engine.stats.snapshot()["counters"]["seq_paused"] < 1:
            assert time.monotonic() < deadline, "never paused"
            time.sleep(0.01)
        toks = list(s)                   # draining resumes the sequence
        assert len(toks) == 12
        c = engine.stats.snapshot()["counters"]
        assert c["seq_resumed"] >= 1 and c["seq_finished"] >= 1
    finally:
        sched.stop()
    assert toks == _serial_decode(engine, [1, 2, 3], 12, 93000)


def test_stream_callback_and_cancel(engine):
    sched = DecodeScheduler(engine, poll_s=0.02).start()
    try:
        got = []
        s = sched.submit([5, 6], max_new_tokens=40, on_token=got.append)
        first = s.get(timeout=30)
        s.cancel()
        leftover = s.result(timeout=30)       # drains to close
        assert got[0] == first
        assert len(got) == 1 + len(leftover) < 40
        assert engine.stats.snapshot()["counters"]["seq_cancelled"] >= 1
    finally:
        sched.stop()


def test_eos_ends_a_sequence(engine):
    oracle = _serial_decode(engine, [14, 15, 16, 17], 7, 93500)
    eos = oracle[2]
    sched = DecodeScheduler(engine, poll_s=0.02).start()
    try:
        out = sched.submit([14, 15, 16, 17], max_new_tokens=7,
                           eos_id=eos).result(timeout=30)
    finally:
        sched.stop()
    assert out == oracle[:oracle.index(eos) + 1]


def test_drain_finishes_inflight_and_refuses_new(engine):
    sched = DecodeScheduler(engine, poll_s=0.02).start()
    s = sched.submit([7, 8, 9], max_new_tokens=10)
    sched.stop(drain=True, timeout=60)
    assert s.result() == _serial_decode(engine, [7, 8, 9], 10, 94000)
    with pytest.raises(ServerClosedError):
        sched.submit([1], max_new_tokens=2)
    assert sched.snapshot()["state"] == "stopped"


def test_submit_validation(engine):
    sched = DecodeScheduler(engine, poll_s=0.02).start()
    try:
        with pytest.raises(MXNetError):
            sched.submit([], max_new_tokens=4)
        with pytest.raises(MXNetError):
            sched.submit([1] * 60, max_new_tokens=10)   # 70 > max_seq_len
        with pytest.raises(MXNetError):
            sched.submit([1], max_new_tokens=0)
        with pytest.raises(MXNetError):
            sched.submit([1], max_new_tokens=4, tenant="nope")
    finally:
        sched.stop()


def test_token_stream_buffer_and_errors():
    with pytest.raises(MXNetError):
        TokenStream(1, maxsize=1)
    s = TokenStream(1, maxsize=2)
    assert s.put(3) and not s.put(4)     # full after the second token
    s.close(ServerClosedError("gone"))
    assert s.get() == 3 and s.get() == 4
    with pytest.raises(ServerClosedError):
        s.get()
    with pytest.raises(TimeoutError):
        TokenStream(2, maxsize=2).get(timeout=0.01)


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------
class _WorkerKilled(BaseException):
    """Kills the decode worker thread (not an Exception, so the loop does
    not absorb it as a failed step)."""


def test_drained_worker_exit_is_not_a_failover(engine, monkeypatch):
    """A graceful stop drains the queue and the worker leaves; a monitor
    poll that lands after the worker left and before the monitor is
    stopped sees a dead worker while draining. It must not count a
    failover or start a new worker (the poll is made at that moment)."""
    sched = DecodeScheduler(engine, poll_s=60.0).start()
    stream = sched.submit(PROMPTS[0], max_new_tokens=BUDGETS[0])
    want = _serial_decode(engine, PROMPTS[0], BUDGETS[0], 96000)
    assert stream.result(timeout=60) == want
    stop_monitor = sched._monitor_stop.set
    seen = {}

    def poll_then_stop():
        seen["alive"] = sched._thread.is_alive()
        sched._check_worker()
        stop_monitor()

    monkeypatch.setattr(sched._monitor_stop, "set", poll_then_stop)
    sched.stop()
    assert seen == {"alive": False}
    assert sched.failovers == 0 and sched.reports == []
    assert sched.snapshot()["epoch"] == 1


def test_decode_failover_requeues_without_dup_or_drop(engine, monkeypatch):
    """The worker dies once mid-run, inside a decode step; the monitor
    requeues its running sequences with pages, position and tokens intact
    and a new worker finishes them: no duplicated and no dropped token."""
    oracle = [_serial_decode(engine, p, b, 95000 + i)
              for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
    real = engine.decode_step
    calls = [0]

    def dying_step(rows):
        calls[0] += 1
        if calls[0] == 5:
            raise _WorkerKilled("decode worker killed")
        return real(rows)

    monkeypatch.setattr(engine, "decode_step", dying_step)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    before = engine.stats.snapshot()["counters"]["seq_requeued"]
    sched = DecodeScheduler(engine, poll_s=0.02).start()
    try:
        streams = [sched.submit(p, max_new_tokens=b)
                   for p, b in zip(PROMPTS, BUDGETS)]
        results = [s.result(timeout=60) for s in streams]
        requeued = engine.stats.snapshot()["counters"]["seq_requeued"]
    finally:
        sched.stop()
    assert results == oracle
    assert sched.failovers == 1 and requeued > before
    report = sched.reports[-1]
    assert report["reason"] == "worker_dead" and report["requeued"] >= 1
    assert sched.snapshot()["epoch"] == 2


# ---------------------------------------------------------------------------
# the server facade
# ---------------------------------------------------------------------------
def test_server_facade_generate(engine):
    server = serving.InferenceServer()
    sched = server.register_generator(engine, warmup=False,
                                      tenants={"gold": 5.0})
    with pytest.raises(MXNetError):
        server.register_generator(engine)
    server.start()
    try:
        s = server.generate("tlm", [2, 4, 6], max_new_tokens=5,
                            tenant="gold")
        out = s.result(timeout=60)
        assert out == _serial_decode(engine, [2, 4, 6], 5, 96000)
        h = server.health()
        assert h["state"] == "running"
        assert h["generators"]["tlm"]["state"] == "running"
        assert h["generators"]["tlm"]["tenants"] == {"default": 100.0,
                                                     "gold": 5.0}
        with pytest.raises(MXNetError):
            server.generate("nope", [1])
    finally:
        server.stop()
    assert sched.snapshot()["state"] == "stopped"
    assert server.health()["generators"]["tlm"]["state"] == "stopped"
