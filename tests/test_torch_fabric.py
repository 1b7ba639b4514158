"""The port's serving fabric (``mxnet_tpu_torch.serving.fabric``) on the CPU,
mirroring ``tests/test_fabric.py`` against the reference.

Slices of four ``cpu(i)`` contexts stand for a host with four cards. What
is held, and how:

- slice carving, plan names and the sharded bucket ladders equal the
  reference's over the same lists, errors included;
- a ``ShardedEndpoint``'s responses through the server are bitwise the
  port's direct forward of the same chunks (each context's rows through the
  block) and within f32 1e-5 of the reference's single-device
  ``ModelEndpoint``. Not bitwise one forward over the whole bucket: oneDNN
  (and cuBLAS) pick kernels by row count, so that is not asserted;
- a ``ShardedDecodeEndpoint``'s greedy tokens equal the reference's
  ``DecodeEndpoint``'s and the port's, serial and batched, and its KV
  replicas stay bitwise equal;
- the ``FrontDoor``'s routes equal the reference's ring before and after
  each kill; failover drops nothing and stays bitwise the direct forward;
  ``check_hosts`` finds a SIGKILLed and a stopped agent of the port.
"""
import os
import signal
import threading
import time
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo.bert import TransformerLM as JaxLM
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.serving import generate as jgenerate
from mxnet_tpu.serving.fabric import FrontDoor as JaxFrontDoor
from mxnet_tpu.serving.fabric import plan_slices as jplan
from mxnet_tpu.serving.fabric import sharded as jsharded

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, config, serving
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.bert import TransformerLM, load_jax_params
from mxnet_tpu_torch.parallel import mesh as pmesh
from mxnet_tpu_torch.serving import ServingPool
from mxnet_tpu_torch.serving.fabric import (FrontDoor, ShardedDecodeEndpoint,
                                            ShardedEndpoint, SliceSpec,
                                            plan_slices)
from mxnet_tpu_torch.serving.fabric import sharded as psharded
from mxnet_tpu_torch.serving.generate import DecodeEndpoint

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

CPUS = [mt.cpu(i) for i in range(8)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _jdevices():
    import jax
    return jax.devices()


def test_exports_and_flags_are_the_references():
    import mxnet_tpu.serving.fabric as jfabric
    from mxnet_tpu import config as jcfg
    import mxnet_tpu_torch.serving.fabric as pfabric
    assert pfabric.__all__ == jfabric.__all__
    assert set(serving.__all__) == set(jserving.__all__)
    for flag in ("MXNET_FABRIC_VNODES", "MXNET_FABRIC_HEARTBEAT_S",
                 "MXNET_FABRIC_HOST_TIMEOUT_S"):
        assert config.get(flag) == jcfg.get(flag)


# ---------------------------------------------------------------------------
# slice carving and plans against the reference
# ---------------------------------------------------------------------------
CARVES = [[4, 2, 1], [3, 3], [1], [8], [8, 1], [0], [], [2, -1]]


@pytest.mark.parametrize("sizes", CARVES, ids=str)
def test_carve_slices_equals_the_reference(sizes):
    def carve(mod, devs):
        try:
            return [[devs.index(d) for d in s]
                    for s in mod.carve_slices(sizes, devices=devs)]
        except Exception as e:
            return type(e).__name__
    port, ref = carve(pmesh, CPUS), carve(jmesh, _jdevices())
    assert port == ref
    if isinstance(ref, str):
        assert port == "MXNetError"


@pytest.mark.parametrize("sizes,axes", [
    ([4, 2], None), ([4], [{"dp": 2, "tp": 2}]), ([2, 2], [{"dp": 2}]),
    ([4], [{"dp": 3}]), ([1, 1, 1], None)], ids=str)
def test_plan_slices_equals_the_reference(sizes, axes):
    def plan(fn, devs):
        try:
            return [(s.index, s.capacity, s.name, s.make_mesh().size)
                    for s in fn(sizes, devices=devs, axes=axes)]
        except Exception as e:
            return type(e).__name__
    assert plan(plan_slices, CPUS) == plan(jplan, _jdevices())


def test_slice_spec_defaults_and_errors():
    spec = plan_slices([4, 2], devices=CPUS)[0]
    assert spec.name == "slice[dp=4]" and spec.capacity == 4
    mesh = spec.make_mesh()
    assert mesh is spec.make_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.axis_size("dp"),
            mesh.size) == ({"dp": 4}, ("dp",), 4, 4)
    assert mesh.contexts == CPUS[:4]
    with pytest.raises(MXNetError):
        SliceSpec(0, CPUS[:4], axes={"dp": 2})
    with pytest.raises(MXNetError):
        SliceSpec(0, [])
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA card"):
            plan_slices([1])


@pytest.mark.parametrize("buckets,top,shard", [
    (None, 8, 4), (None, 6, 4), ([2, 8], 8, 4), ([4, 8], 8, 4),
    (None, 32, 1), (None, 32, 2), ([3, 6], 6, 3)], ids=str)
def test_sharded_buckets_equal_the_reference(buckets, top, shard):
    def ladder(mod):
        try:
            return list(mod._sharded_buckets(buckets, top, shard))
        except Exception as e:
            return type(e).__name__
    port, ref = ladder(psharded), ladder(jsharded)
    assert port == ref or (ref == "MXNetError" == port)


# ---------------------------------------------------------------------------
# ShardedEndpoint
# ---------------------------------------------------------------------------
def _mlp_weights(seed, out_dim):
    rng = onp.random.RandomState(seed)
    return [(0.3 * rng.randn(*s)).astype("float32")
            for s in ((16, 8), (16,), (out_dim, 16), (out_dim,))]


def _port_mlp(weights):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.Dense(weights[2].shape[0], in_units=16))
    net.initialize(ctx=mt.cpu())
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(mt.nd.array(w, ctx=mt.cpu()))
    return net


def _jax_mlp(weights):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu"),
                mx.gluon.nn.Dense(weights[2].shape[0]))
    net.initialize()
    net(mx.nd.array(onp.zeros((2, 8), "float32")))
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(mx.nd.array(w))
    return net


def _chunked_direct(net, x, bucket, n):
    """The direct forward of a padded bucket, chunk by chunk (each
    context's rows through the block), rows of ``x`` kept."""
    pad = onp.zeros((bucket, 8), "float32")
    pad[:len(x)] = x
    with torch.inference_mode():
        outs = [net(torch.from_numpy(c)) for c in onp.split(pad, n)]
    return torch.cat(outs)[:len(x)]


@pytest.mark.parametrize("pipeline", [False, True])
def test_sharded_endpoint_bitwise_per_chunk_through_the_server(pipeline):
    weights = _mlp_weights(21, 6)
    net = _port_mlp(weights)
    sl = plan_slices([4], devices=CPUS)[0]
    ep = ShardedEndpoint(f"fab_sh_{pipeline}", net, input_shapes=[(8,)],
                         max_batch_size=8, slice_spec=sl)
    jref = jserving.ModelEndpoint(f"fab_ref_{pipeline}", _jax_mlp(weights),
                                  input_shapes=[(8,)], max_batch_size=8)
    rng = onp.random.RandomState(7)
    batches = [rng.randn(r, 8).astype("float32") for r in (1, 3, 8, 5, 2)] \
        + [rng.randn(8).astype("float32")]          # squeeze path
    srv = serving.InferenceServer(batch_timeout_ms=1.0, pipeline=pipeline)
    jsrv = jserving.InferenceServer(batch_timeout_ms=1.0)
    try:
        srv.register(ep)
        jsrv.register(jref)
        srv.start()
        jsrv.start()
        got = [srv.predict(ep.name, b, timeout=60) for b in batches]
        want = [jsrv.predict(jref.name, b, timeout=60).asnumpy()
                for b in batches]
    finally:
        srv.stop()
        jsrv.stop()
        serving.unregister(ep.name)
        jserving.unregister(jref.name)
    assert ep.capacity == 4 and tuple(ep.buckets) == (4, 8)
    assert ep._device_label() == "cpu:dp=4"
    for b, g, w in zip(batches, got, want):
        rows = b.reshape(-1, 8)
        bucket = 4 if len(rows) <= 4 else 8
        direct = _chunked_direct(net, rows, bucket, 4)
        direct = direct[0] if b.ndim == 1 else direct
        assert g.shape == direct.shape == w.shape
        assert torch.equal(g, direct)
        onp.testing.assert_allclose(g.numpy(), w, **TOL)


def test_sharded_endpoint_concurrent_clients_within_the_reference():
    weights = _mlp_weights(22, 6)
    net = _port_mlp(weights)
    jnet = _jax_mlp(weights)
    ep = ShardedEndpoint("fab_conc", net, input_shapes=[(8,)],
                         max_batch_size=16,
                         slice_spec=plan_slices([4], devices=CPUS)[0])
    srv = serving.InferenceServer(batch_timeout_ms=2.0)
    results, errors = [], []

    def client(i):
        rng = onp.random.RandomState(100 + i)
        try:
            for _ in range(6):
                x = rng.randn(rng.randint(1, 5), 8).astype("float32")
                results.append((x, srv.predict("fab_conc", x, timeout=60)))
        except Exception as e:
            errors.append(repr(e))

    try:
        srv.register(ep)
        srv.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        srv.stop()
        serving.unregister("fab_conc")
    assert not errors and len(results) == 36
    assert ep.stats.snapshot()["counters"]["completed"] == 36
    for x, y in results:
        onp.testing.assert_allclose(y.numpy(), jnet(mx.nd.array(x)).asnumpy(),
                                    **TOL)


def test_shard_params_store_a_shard_per_context():
    weights = _mlp_weights(23, 6)
    net = _port_mlp(weights)
    sl = plan_slices([4], devices=CPUS)[0]
    ep = ShardedEndpoint("fab_shp", net, input_shapes=[(8,)],
                         max_batch_size=8, slice_spec=sl)
    flat = ShardedEndpoint("fab_flat", _port_mlp(weights),
                           input_shapes=[(8,)], max_batch_size=8,
                           slice_spec=sl, shard_params=False)
    try:
        x = onp.random.RandomState(3).randn(8, 8).astype("float32")
        with torch.inference_mode():
            a = ep._forward(ep._place((x,)))[0]
            b = flat._forward(flat._place((x,)))[0]
        assert torch.equal(a, b) and ep._placement.gathers > 0
        named = dict(net.named_parameters())
        divisible = {n for n, t in named.items() if t.shape[0] % 4 == 0}
        assert divisible and divisible != set(named)   # the (6, 16) layer
        shards = [ep._placement.shards(g) for g in range(4)]
        for g, s in enumerate(shards):
            assert set(s) == divisible
            for n, t in s.items():
                assert t.shape[0] == named[n].shape[0] // 4
                assert t.data_ptr() != named[n].data_ptr()
        for n in divisible:
            assert torch.equal(torch.cat([s[n] for s in shards]),
                               named[n].detach())
        assert all(flat._placement.shards(g) == {} for g in range(4))
        # a hot swap reaches every context's copy
        swapped = [w * 0.5 for w in weights]
        ep.hot_swap({"model": {"n_params": 4, "params": {
            f"p{i}": w for i, w in enumerate(swapped)}}})
        with torch.inference_mode():
            got = ep._forward(ep._place((x,)))[0]
        want = _chunked_direct(_port_mlp(swapped), x, 8, 4)
        assert torch.equal(got, want)
    finally:
        serving.unregister("fab_shp")
        serving.unregister("fab_flat")


def test_sharded_endpoint_refusals():
    sl = plan_slices([4], devices=CPUS)[0]
    net = _port_mlp(_mlp_weights(11, 4))
    with pytest.raises(MXNetError, match="multiple"):
        ShardedEndpoint("fab_bad1", net, input_shapes=[(8,)],
                        max_batch_size=6, slice_spec=sl)
    with pytest.raises(MXNetError, match="multiples"):
        ShardedEndpoint("fab_bad2", net, input_shapes=[(8,)],
                        max_batch_size=8, buckets=[2, 8], slice_spec=sl)
    with pytest.raises(MXNetError, match="first context"):
        ShardedEndpoint("fab_bad3", net, input_shapes=[(8,)],
                        max_batch_size=8, slice_spec=sl, ctx=mt.cpu(2))
    with pytest.raises(MXNetError, match="slice_spec or mesh"):
        ShardedEndpoint("fab_bad4", net, input_shapes=[(8,)])
    with pytest.raises(MXNetError, match="OR"):
        ShardedEndpoint("fab_bad5", net, input_shapes=[(8,)],
                        slice_spec=sl, mesh=sl.make_mesh())


# ---------------------------------------------------------------------------
# ShardedDecodeEndpoint
# ---------------------------------------------------------------------------
LM_CFG = dict(num_layers=2, units=32, hidden_size=64, num_heads=2,
              vocab_size=50, max_length=64)
ENG = dict(max_seq_len=64, max_batch_size=4, page_size=8, num_pages=64)


def _lm_weights(seed=31):
    rng = onp.random.RandomState(seed)
    named = {}
    for k, v in TransformerLM(**LM_CFG)._collect_params_with_prefix().items():
        if k.endswith("gamma"):
            named[k] = onp.ones(v.shape, onp.float32)
        elif k.endswith(("beta", "bias")):
            named[k] = onp.zeros(v.shape, onp.float32)
        else:
            named[k] = rng.normal(0.0, 0.5, v.shape).astype(onp.float32)
    return named


def _port_lm(named):
    lm = TransformerLM(**LM_CFG)
    load_jax_params(lm, named, ctx=mt.cpu())
    return lm


def _jax_lm(named):
    jlm = JaxLM(**LM_CFG)
    jlm.initialize()
    jlm(mx.nd.array(onp.zeros((1, 4), onp.int32), dtype="int32"))
    for k, p in jlm._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(named[k]))
    return jlm


def _serial(eng, prompt, budget, sid):
    eng.pool.reserve(sid, len(prompt) + budget)
    toks = [eng.prefill(prompt, eng.pool.table(sid))]
    pos = len(prompt)
    for _ in range(budget - 1):
        (t,) = eng.decode_step([(toks[-1], pos, eng.pool.table(sid))])
        toks.append(t)
        pos += 1
    eng.pool.free(sid)
    return toks


def _batched(eng, prompts, steps, base):
    for i, p in enumerate(prompts):
        eng.pool.reserve(base + i, len(p) + steps + 1)
    toks = [[eng.prefill(p, eng.pool.table(base + i))]
            for i, p in enumerate(prompts)]
    for s in range(steps):
        nxt = eng.decode_step([(toks[i][-1], len(p) + s,
                                eng.pool.table(base + i))
                               for i, p in enumerate(prompts)])
        for i, t in enumerate(nxt):
            toks[i].append(t)
    for i in range(len(prompts)):
        eng.pool.free(base + i)
    return toks


def test_sharded_decode_tokens_equal_the_reference():
    named = _lm_weights()
    sl = plan_slices([4], devices=CPUS)[0]
    sh = ShardedDecodeEndpoint("fab_dsh", _port_lm(named), slice_spec=sl,
                               **ENG)
    one = DecodeEndpoint("fab_done", _port_lm(named), ctx=mt.cpu(), **ENG)
    jeng = jgenerate.DecodeEndpoint("fab_dref", _jax_lm(named), **ENG)
    sh.warmup()
    assert sh.capacity == 4 and tuple(sh.decode_buckets) == (4,)
    assert len(sh.pool.replicas) == 4
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11]]
    for i, p in enumerate(prompts):
        want = _serial(jeng, p, 6, 900 + i)
        assert _serial(sh, p, 6, 910 + i) == want, (p, want)
        assert _serial(one, p, 6, 920 + i) == want
    want = _batched(jeng, prompts, 5, 1000)
    assert _batched(sh, prompts, 5, 1100) == want
    assert _batched(one, prompts, 5, 1200) == want
    # every context's pool replica holds the same bytes
    k0, v0 = sh.pool.replicas[0]
    for k, v in sh.pool.replicas[1:]:
        assert torch.equal(k, k0) and torch.equal(v, v0)
        assert k.data_ptr() != k0.data_ptr()


def test_sharded_decode_replicas_survive_defrag():
    named = _lm_weights(32)
    sh = ShardedDecodeEndpoint(
        "fab_ddefrag", _port_lm(named),
        slice_spec=plan_slices([2], devices=CPUS)[0], **ENG)
    one = DecodeEndpoint("fab_ddefrag1", _port_lm(named), ctx=mt.cpu(),
                         **ENG)
    for eng in (sh, one):
        eng.pool.reserve(1, 20)
        eng.prefill([1, 2, 3], eng.pool.table(1))
        eng.pool.reserve(2, 20)
        eng.prefill([4, 5], eng.pool.table(2))
        eng.pool.free(1)
    assert sh.pool.defrag() > 0
    k0, _ = sh.pool.replicas[0]
    assert torch.equal(sh.pool.replicas[1][0], k0)
    one.pool.defrag()
    t_sh = _serial_from(sh, [4, 5], 2)
    assert t_sh == _serial_from(one, [4, 5], 2)


def _serial_from(eng, prompt, sid, steps=4):
    tok = eng.prefill(prompt, eng.pool.table(sid))
    out = [tok]
    for s in range(steps):
        (tok,) = eng.decode_step([(tok, len(prompt) + s, eng.pool.table(sid))])
        out.append(tok)
    return out


# ---------------------------------------------------------------------------
# capacity-weighted pool rotation
# ---------------------------------------------------------------------------
def test_pool_capacity_weighted_rotation():
    weights = _mlp_weights(41, 4)
    sl = plan_slices([4], devices=CPUS)[0]

    def factory(rid):
        srv = serving.InferenceServer(batch_timeout_ms=1.0)
        if rid == 0:
            srv.register(ShardedEndpoint("fab_pool", _port_mlp(weights),
                                         input_shapes=[(8,)],
                                         max_batch_size=8, slice_spec=sl))
        else:
            srv.register(serving.ModelEndpoint(
                "fab_pool", _port_mlp(weights), input_shapes=[(8,)],
                max_batch_size=8, ctx=mt.cpu()), warmup=False)
        srv.start()
        return srv

    pool = ServingPool(factory, initial_replicas=2)
    try:
        caps = {r["rid"]: r["capacity"] for r in pool.snapshot()["replicas"]}
        assert caps == {0: 4, 1: 1}
        loads = {0: 0, 1: 0}
        counts = {0: 0, 1: 0}
        reps = pool._rotation()
        for _ in range(100):
            rep = min(reps, key=lambda r: loads[r.rid] / r.capacity)
            loads[rep.rid] += 1
            counts[rep.rid] += 1
        assert counts[0] == 80 and counts[1] == 20     # exactly 4:1
        r0 = next(r for r in reps if r.rid == 0)
        r1 = next(r for r in reps if r.rid == 1)
        assert ServingPool._load_of(r0) == pytest.approx(0.0)
        orig = ServingPool.__dict__["_raw_load"]
        try:
            ServingPool._raw_load = staticmethod(
                lambda rep: {0: 3, 1: 1}[rep.rid])
            assert ServingPool._load_of(r0) < ServingPool._load_of(r1)
        finally:
            ServingPool._raw_load = orig
        x = onp.ones((3, 8), "float32")
        assert pool.predict("fab_pool", x, timeout=60).shape == (3, 4)
    finally:
        pool.stop()
        serving.unregister("fab_pool")


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------
class _StubServer:
    """A serving plane for the routing comparison: tenants only."""

    def __init__(self, tenants):
        self._router = types.SimpleNamespace(names=lambda: list(tenants))

    def stop(self, drain=True, timeout=None):
        pass


def test_frontdoor_routes_equal_the_reference_through_kills():
    hosts = [f"h{i}" for i in range(5)]
    tenants = [f"tenant_{i}" for i in range(24)]
    port = FrontDoor(hosts, lambda n: _StubServer(tenants),
                     spawn_agents=False, supervise=False)
    ref = JaxFrontDoor(hosts, lambda n: _StubServer(tenants),
                       spawn_agents=False, supervise=False)
    try:
        routes = {t: port.route(t) for t in tenants}
        assert routes == {t: ref.route(t) for t in tenants}
        assert len(set(routes.values())) > 1
        moved = 0
        for victim in ("h2", "h0", "h4", "h1"):
            pr, rr = port.kill_host(victim), ref.kill_host(victim)
            moved += pr["moved"]
            assert (pr["moved"], pr["epoch"]) == (rr["moved"], rr["epoch"])
            now = {t: port.route(t) for t in tenants}
            assert now == {t: ref.route(t) for t in tenants}
            for t in tenants:     # bounded: only the victim's tenants moved
                assert now[t] == routes[t] or routes[t] == victim
            routes = now
        assert port.alive_hosts() == ref.alive_hosts() == ["h3"]
        assert port.moves == moved
        assert port.hosts_by_state() == {"alive": 1, "down": 4}
    finally:
        port.stop()
        ref.stop()


def _host_factory(tenants, weights):
    def factory(name):
        srv = serving.InferenceServer(batch_timeout_ms=1.0)
        for t in tenants:
            # one request a batch: every response is the forward of its own
            # two rows, the direct forward's shape
            srv.register(serving.ModelEndpoint(
                t, _port_mlp(weights), input_shapes=[(8,)],
                max_batch_size=2, ctx=mt.cpu()))
        srv.start()
        return srv
    return factory


def test_frontdoor_zero_drop_failover_bitwise():
    tenants = [f"fab_t{i}" for i in range(6)]
    weights = _mlp_weights(61, 4)
    x = onp.ones((2, 8), "float32")
    with torch.inference_mode():
        direct = _port_mlp(weights)(torch.from_numpy(x))
    fd = FrontDoor(["h0", "h1", "h2"], _host_factory(tenants, weights),
                   spawn_agents=False, supervise=True)
    try:
        owner_before = {t: fd.route(t) for t in tenants}
        victim = owner_before[tenants[0]]
        futs = [fd.submit(t, x) for t in tenants for _ in range(5)]
        rep = fd.kill_host(victim)
        futs += [fd.submit(t, x) for t in tenants for _ in range(3)]
        outs = [f.result(timeout=60) for f in futs]     # zero drops
        for o in outs:
            assert torch.equal(o, direct)
        assert rep["epoch"] == 1 and victim not in fd.alive_hosts()
        owner_after = {t: fd.route(t) for t in tenants}
        for t in tenants:
            if owner_before[t] == victim:
                assert owner_after[t] != victim
            else:
                assert owner_after[t] == owner_before[t]
        moved = sum(1 for t in tenants if owner_before[t] != owner_after[t])
        assert rep["moved"] == moved and fd.moves == moved
        assert fd.failovers == {victim: 1}
        assert sum(fd.requests_by_host.values()) == len(futs) + fd.resubmits
        assert fd.kill_host(victim).get("already_down") is True
    finally:
        fd.stop()
        for t in tenants:
            serving.unregister(t)


@pytest.mark.parametrize("kind", ["net_drop", "net_delay"])
def test_frontdoor_rides_out_network_faults(kind):
    """A dropped hop is re-sent under the ``frontdoor`` retry budget and a
    delayed one waits: every request resolves, bitwise the direct
    forward."""
    from mxnet_tpu_torch.resilience import faults
    from mxnet_tpu_torch.serving import tailguard
    tenants = [f"fab_net_{kind}"]
    weights = _mlp_weights(63, 4)
    x = onp.ones((2, 8), "float32")
    with torch.inference_mode():
        direct = _port_mlp(weights)(torch.from_numpy(x))
    tailguard.RETRY_BUDGETS.reset()
    fd = FrontDoor(["h0", "h1"], _host_factory(tenants, weights),
                   spawn_agents=False, supervise=False)
    try:
        with faults.inject(kind, site="frontdoor", every_n=3,
                           seconds=0.01) as inj:
            outs = [fd.submit(tenants[0], x).result(timeout=60)
                    for _ in range(9)]
        # a drop re-checks the hop, a delay passes it
        retried = inj.fires if kind == "net_drop" else 0
        assert inj.fires >= 3 and inj.calls == 9 + retried
        assert all(torch.equal(o, direct) for o in outs)
        assert sum(fd.requests_by_host.values()) == 9
    finally:
        fd.stop()
        serving.unregister(tenants[0])
        tailguard.RETRY_BUDGETS.reset()


def test_frontdoor_refuses_mismatched_tenant_sets():
    def factory(name):
        return _StubServer([f"fab_only_{name}"])
    with pytest.raises(MXNetError, match="identical tenant sets"):
        FrontDoor(["a", "b"], factory, spawn_agents=False, supervise=False)
    with pytest.raises(MXNetError, match="unique"):
        FrontDoor(["a", "a"], factory, spawn_agents=False, supervise=False)


def _wait(cond, timeout=90.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            return False
        time.sleep(0.05)
    return True


def test_check_hosts_finds_a_killed_and_a_stopped_agent():
    tenants = ["fab_hb0", "fab_hb1", "fab_hb2"]
    weights = _mlp_weights(71, 4)
    with mt.cpu():
        fd = FrontDoor(["h0", "h1", "h2"], _host_factory(tenants, weights),
                       supervise=False)
    saved = config.get("MXNET_FABRIC_HOST_TIMEOUT_S")
    pids = [fd.agent_pid(h) for h in fd.hosts()]
    try:
        assert _wait(lambda: all(fd.heartbeat_age(h) is not None
                                 for h in fd.hosts()))
        assert fd.check_hosts() == []
        assert all(fd.heartbeat_age(h) < 5.0 for h in fd.hosts())
        os.kill(fd.agent_pid("h1"), signal.SIGKILL)
        assert _wait(lambda: fd._hosts["h1"].agent.poll() is not None, 10)
        (rep,) = fd.check_hosts()
        assert (rep["host"], rep["reason"]) == ("h1", "agent_exit")
        assert fd.alive_hosts() == ["h0", "h2"]
        # a stopped agent stops beating: declared down by heartbeat age
        config.set("MXNET_FABRIC_HOST_TIMEOUT_S", 0.5)
        os.kill(fd.agent_pid("h2"), signal.SIGSTOP)
        assert _wait(lambda: fd.heartbeat_age("h2") > 1.0, 10)
        (rep,) = fd.check_hosts()
        assert (rep["host"], rep["reason"]) == ("h2", "heartbeat")
        x = onp.ones((2, 8), "float32")
        assert all(fd.route(t) == "h0" for t in tenants)
        assert fd.submit("fab_hb2", x).result(timeout=60).shape == (2, 4)
    finally:
        config.set("MXNET_FABRIC_HOST_TIMEOUT_S", saved)
        fd.stop()
        for t in tenants:
            serving.unregister(t)
    for pid in pids:      # every agent reaped
        with pytest.raises(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)
