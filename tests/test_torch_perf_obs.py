"""The port's device-memory attribution (telemetry.memstats) and drift
sentinel (telemetry.perf_sentinel) on the CPU, held against the JAX
package's on the same inputs: holder reconciliation against injected
device stats, weakref pruning and live sizers, byte counts of trees, the
disabled switch, the caching allocator's stats under the reference's names,
and the EWMA drift detector firing at the same sample as the reference's on
the same latency series."""
import gc

import numpy as onp
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu.telemetry import memstats as jmemstats
from mxnet_tpu.telemetry import perf_sentinel as jsentinel

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.telemetry import flight, memstats, perf_sentinel

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_state():
    for m in (memstats, jmemstats):
        m.reset()
    perf_sentinel.SENTINEL.reset()
    yield
    for m in (memstats, jmemstats):
        m.reset()
    perf_sentinel.SENTINEL.reset()


def _register_both(owner_p, owner_j):
    for m, o in ((memstats, owner_p), (jmemstats, owner_j)):
        m.register("serving", "ep.params", nbytes=1_000, device="gpu:0",
                   owner=o)
        m.register("train", "state", owner=o, sizer=lambda _: 2_000)


class _Owner:
    n = 100


@pytest.mark.parametrize("stats", [
    {"gpu:0": {"bytes_in_use": 5_000, "peak_bytes_in_use": 6_000}},
    {"gpu:0": {"bytes_in_use": 800, "peak_bytes_in_use": 900},
     "gpu:1": {"bytes_in_use": 10, "peak_bytes_in_use": 10}},
    {},
])
def test_memstats_reconcile_matches_reference(stats):
    """The same holders against the same injected device stats give the
    reference's reconciliation and (timestamps aside) breakdown."""
    op, oj = _Owner(), _Owner()
    _register_both(op, oj)
    got = memstats.reconcile(device_stats=stats)
    want = jmemstats.reconcile(device_stats=stats)
    assert got == want
    if "gpu:0" in stats:
        assert got["gpu:0"]["attributed"] == 1_000
        assert got["gpu:0"]["unattributed"] == \
            stats["gpu:0"]["bytes_in_use"] - 1_000
    # holders whose device the stats do not report land on "unassigned"
    assert got["unassigned"]["attributed"] == \
        2_000 + (0 if "gpu:0" in stats else 1_000)
    bp = memstats.breakdown(device_stats=stats)
    bj = jmemstats.breakdown(device_stats=stats)
    bp.pop("ts")
    bj.pop("ts")
    assert bp == bj
    assert bp["attributed_bytes"] == 3_000
    assert bp["holders"][0]["bytes"] == 2_000   # ranked, largest first


def test_memstats_weakref_pruning_and_sizer_liveness():
    o = _Owner()
    memstats.register("t", "live", owner=o, sizer=lambda ow: ow.n)
    assert memstats.holders()[0]["bytes"] == 100
    o.n = 900
    row = memstats.holders()[0]
    assert row["bytes"] == 900 and row["peak_bytes"] == 900
    del o
    gc.collect()
    assert memstats.holders() == [], "dead owner must prune its holder"


def test_memstats_nbytes_of_trees():
    x = onp.zeros((4, 4), "float32")
    tree = {"a": [x, (x, None)], "b": x}
    assert memstats.nbytes_of(tree) == jmemstats.nbytes_of(tree) == \
        3 * x.nbytes
    assert memstats.nbytes_of(mt.nd.array(x, ctx=mt.cpu())) == \
        jmemstats.nbytes_of(jnd.array(x)) == x.nbytes
    t = torch.zeros(4, 4)
    # a tensor and a view of the same memory count once; another tensor
    # counts on its own
    assert memstats.nbytes_of([t, t[:], torch.zeros(2)]) == t.nbytes + 8


def test_memstats_disabled_is_noop(monkeypatch):
    monkeypatch.setenv("MXNET_MEM_TRACK", "0")
    h = memstats.register("t", "x", nbytes=5)
    h.update(10)
    assert memstats.holders() == []


def test_device_stats_map_the_caching_allocator(monkeypatch):
    """``torch.cuda.memory_stats`` read under the reference's stat names,
    one ``gpu:<i>`` entry a card (faked here: the CPU reports nothing)."""
    assert memstats._device_stats() == {}
    raw = {"allocated_bytes.all.current": 1234,
           "allocated_bytes.all.peak": 5678,
           "reserved_bytes.all.current": 8192}

    class _Props:
        total_memory = 80 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: raw)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props())
    assert memstats._device_stats() == {"gpu:0": {
        "bytes_in_use": 1234, "peak_bytes_in_use": 5678,
        "bytes_reserved": 8192, "bytes_limit": 80 << 30}}
    assert telemetry.sample_device_memory() == 1
    fam = telemetry.REGISTRY.get("mxtpu_device_memory_bytes")
    assert fam.labels("gpu:0", "bytes_in_use").value == 1234
    assert fam.labels("gpu:0", "bytes_limit").value == 80 << 30


# ---------------------------------------------------------------------------
# drift sentinel (tests/test_perf_obs.py:388-440)
# ---------------------------------------------------------------------------
def _series(seed):
    rng = onp.random.RandomState(seed)
    base = 100.0 + rng.randn(60)
    spike = [1000.0]
    calm = 100.0 + rng.randn(5)
    regress = 300.0 + 5 * rng.randn(30)
    further = 900.0 + 10 * rng.randn(30)
    return onp.concatenate([base, spike, calm, regress, further])


@pytest.mark.parametrize("seed,params", [
    (0, dict(alpha=0.2, ratio=1.5, sustain_n=4, warmup_n=10)),
    (1, dict(alpha=0.05, ratio=1.5, sustain_n=8, warmup_n=50)),
    (2, dict(alpha=0.1, ratio=2.0, sustain_n=3, warmup_n=20)),
])
def test_drift_detector_fires_where_the_reference_fires(seed, params):
    port = perf_sentinel.DriftDetector("s", **params)
    ref = jsentinel.DriftDetector("s", **params)
    series = _series(seed)
    fired_p = [port.observe(v) for v in series]
    fired_j = [ref.observe(v) for v in series]
    assert fired_p == fired_j and any(fired_p)
    assert port.snapshot() == ref.snapshot()


def test_drift_detector_fires_on_sustained_regression_only():
    det = perf_sentinel.DriftDetector("s", alpha=0.2, ratio=1.5,
                                      sustain_n=4, warmup_n=10)
    for _ in range(40):
        assert not det.observe(100.0)
    assert not det.observe(1000.0)          # one spike never fires
    for _ in range(5):
        assert not det.observe(100.0)
    fired = [det.observe(300.0) for _ in range(30)]
    assert sum(fired) == 1                  # edge-triggered
    assert det.baseline > 200.0
    fired = [det.observe(900.0) for _ in range(30)]
    assert sum(fired) == 1


def test_sentinel_emits_flight_event_and_metric(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_PERF_WARMUP_N", "5")
    monkeypatch.setenv("MXNET_PERF_SUSTAIN_N", "3")
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path))
    flight.RECORDER.reset_rate_limit()
    fam = telemetry.REGISTRY.get("mxtpu_perf_regressions_total")
    before = fam.labels("train_step_unit").value
    for _ in range(20):
        perf_sentinel.observe("train_step_unit", 100.0)
    for _ in range(30):
        perf_sentinel.observe("train_step_unit", 500.0)
    snap = perf_sentinel.SENTINEL.snapshot()["train_step_unit"]
    assert snap["fired"] >= 1
    assert fam.labels("train_step_unit").value == before + snap["fired"]
    evs = [e for e in flight.recent_events()
           if e["kind"] == "perf_regression"]
    assert evs and evs[-1]["attrs"]["stream"] == "train_step_unit"
    assert evs[-1]["attrs"]["ratio"] > 1.5
    assert flight.list_bundles(str(tmp_path))


def test_sentinel_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv("MXNET_PERF_SENTINEL", "0")
    for _ in range(100):
        perf_sentinel.observe("off_stream", 100.0)
    assert "off_stream" not in perf_sentinel.SENTINEL.snapshot()


def test_step_paths_feed_the_sentinel():
    """A served batch feeds ``serving_step.<endpoint>``."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(2, in_units=4)
    net.initialize(ctx=mt.cpu())
    ep = serving.ModelEndpoint("t_sentinel", net, input_shapes=(4,),
                               max_batch_size=1, ctx=mt.cpu())
    ep.run_batch([onp.ones((1, 4), "float32")], 1)
    serving.unregister("t_sentinel")
    assert perf_sentinel.SENTINEL.snapshot()["serving_step.t_sentinel"][
        "n"] == 1
