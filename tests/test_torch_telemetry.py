"""The port's telemetry core (mxnet_tpu_torch.telemetry) held against the
JAX package's on the CPU: the registry's semantics and export formats, the
catalog of families (names, kinds, label names, help texts) less the
written exceptions, the Prometheus text of a port snapshot rendered by the
reference's ``prometheus_from_snapshot``, histogram percentiles, the
family deltas the same work gives in both packages (serving a small Dense
net, two ParallelTrainStep steps, a kvstore pushpull, a DataLoader epoch),
spans and the serving queue hop, and the reference's
``tools/metrics_dump.py`` rendering a port dump.

The registry is process-wide and a test worker runs many files in a row:
every check on the shared registry compares deltas, or uses a private
MetricsRegistry."""
import json
import os
import re
import subprocess
import sys
import threading

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.cache
import mxnet_tpu.embedding.feed
import mxnet_tpu.embedding.planner
import mxnet_tpu.profiler
import mxnet_tpu.serving.fabric.frontdoor
import mxnet_tpu.serving.fabric.slices
import mxnet_tpu.serving.generate
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.data import ArrayDataset as JArrayDataset
from mxnet_tpu.gluon.data import DataLoader as JDataLoader
from mxnet_tpu.telemetry.metrics import (
    prometheus_from_snapshot as ref_prometheus_from_snapshot)

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.cache
import mxnet_tpu_torch.embedding.feed
import mxnet_tpu_torch.embedding.planner
import mxnet_tpu_torch.serving.fabric.frontdoor
import mxnet_tpu_torch.serving.fabric.slices
import mxnet_tpu_torch.serving.generate
from mxnet_tpu_torch import MXNetError, profiler, serving, telemetry
from mxnet_tpu_torch.gluon import loss as ploss
from mxnet_tpu_torch.gluon import nn as pnn
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.telemetry.metrics import (
    METRIC_NAME_RE, MetricsRegistry, _quantile_from_buckets)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# registry semantics (tests/test_telemetry.py:33-206)
# ---------------------------------------------------------------------------
def test_counter_gauge_histogram_basics():
    r = MetricsRegistry()
    c = r.counter("mxtpu_test_ops_total", "ops")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(MXNetError):
        c.inc(-1)                      # counters only go up
    g = r.gauge("mxtpu_test_depth", "depth")
    g.set(7)
    g.dec(2)
    assert g.value == 5
    h = r.histogram("mxtpu_test_lat_us", "lat")
    for v in (1, 10, 100, 1000):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and s["sum"] == 1111
    assert s["min"] == 1 and s["max"] == 1000
    assert 0 < s["p50"] <= s["p95"] <= s["p99"] <= 1000


def test_labels_and_get_or_create():
    r = MetricsRegistry()
    c = r.counter("mxtpu_test_req_total", "reqs", labelnames=("ep", "event"))
    c.labels("a", "ok").inc()
    c.labels(ep="a", event="ok").inc()          # kwargs resolve identically
    c.labels("b", "err").inc(3)
    assert c.labels("a", "ok").value == 2
    assert c.labels("b", "err").value == 3
    with pytest.raises(MXNetError):
        c.inc()                                 # labeled: .labels() first
    assert r.counter("mxtpu_test_req_total",
                     labelnames=("ep", "event")) is c
    with pytest.raises(MXNetError):
        r.gauge("mxtpu_test_req_total", labelnames=("ep", "event"))
    with pytest.raises(MXNetError):
        r.counter("mxtpu_test_req_total", labelnames=("other",))


@pytest.mark.parametrize("bad", ["requests_total", "mxtpu_UPPER",
                                 "mxtpu-dash", "mxtpu_", "mxtpu_a b"])
def test_metric_name_lint(bad):
    r = MetricsRegistry()
    with pytest.raises(MXNetError):
        r.counter(bad)
    r.counter("mxtpu_fine_total")
    assert r.lint_names() == []


def test_counter_bumps_are_thread_safe():
    r = MetricsRegistry()
    c = r.counter("mxtpu_test_race_total")
    h = r.histogram("mxtpu_test_race_us")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for _ in range(2000):
                c.inc()
                h.observe(3.0)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value == 16000
    assert h.summary()["count"] == 16000


_PROM_LINE = re.compile(
    r"^(?:"
    r"# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*"
    r"|# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram|untyped)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+-]+(?: [0-9]+)?"
    r")$")


def _assert_prometheus_parses(text):
    assert text.endswith("\n")
    seen_types, samples = {}, 0
    for line in text.splitlines():
        if not line:
            continue
        assert _PROM_LINE.match(line), f"unparseable exposition line: {line!r}"
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(" ")
            assert name not in seen_types, f"duplicate TYPE for {name}"
            seen_types[name] = kind
        elif not line.startswith("#"):
            samples += 1
    assert seen_types and samples
    return seen_types


def test_prometheus_exposition_parses_line_by_line():
    with telemetry.span("test.export"):
        pass
    text = telemetry.prometheus_text()
    kinds = _assert_prometheus_parses(text)
    assert kinds.get("mxtpu_span_duration_us") == "histogram"
    assert kinds.get("mxtpu_serving_requests_total") == "counter"
    m = re.findall(r'mxtpu_span_duration_us_bucket\{name="test.export",'
                   r'le="([^"]+)"\} (\d+)', text)
    assert m and m[-1][0] == "+Inf"
    counts = [int(v) for _, v in m]
    assert counts == sorted(counts)
    count = re.search(r'mxtpu_span_duration_us_count\{name="test.export"\} '
                      r'(\d+)', text)
    assert count and int(count.group(1)) == counts[-1]


def test_snapshot_json_roundtrip_and_offline_prom():
    with telemetry.span("test.snapshot"):
        pass
    snap = telemetry.snapshot()
    rt = json.loads(json.dumps(snap))
    assert rt["metrics"].keys() == snap["metrics"].keys()
    fam = rt["metrics"]["mxtpu_span_duration_us"]
    assert fam["type"] == "histogram" and fam["bucket_bounds"]
    series = {tuple(sorted(s["labels"].items())): s for s in fam["series"]}
    s = series[(("name", "test.snapshot"),)]
    assert s["count"] >= 1 and len(s["bucket_counts"]) == \
        len(fam["bucket_bounds"]) + 1
    _assert_prometheus_parses(ref_prometheus_from_snapshot(rt))


def test_span_nesting_and_trace_inheritance():
    with telemetry.span("test.root", job="j1") as root:
        assert telemetry.current_trace_id() == root.trace_id
        with telemetry.span("test.child") as child:
            assert child.trace_id == root.trace_id
            assert child.parent_id == root.span_id
    assert telemetry.current_span() is None
    assert root.dur_us is not None and root.dur_us >= child.dur_us


def test_span_adoption_across_threads():
    with telemetry.span("test.submit") as s:
        tid = s.trace_id
    got = {}

    def worker():
        with telemetry.span("test.worker", trace_id=tid) as w:
            got["trace"] = w.trace_id
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and got["trace"] == tid


# ---------------------------------------------------------------------------
# the catalog: the reference's families less the written exceptions
# ---------------------------------------------------------------------------
def test_catalog_parity_with_the_reference():
    """After importing the same subsystems in both packages (this module's
    imports), every reference family is registered by the port with the
    same kind, label names and help text, except those NOT_REGISTERED
    names with its reason; the port registers nothing else."""
    ref, port = jtelemetry.REGISTRY, telemetry.REGISTRY
    ref_names, port_names = set(ref.names()), set(port.names())
    skipped = set(telemetry.NOT_REGISTERED)
    assert skipped <= ref_names, sorted(skipped - ref_names)
    assert not skipped & port_names, sorted(skipped & port_names)
    assert ref_names - skipped == port_names, (
        sorted(ref_names - skipped - port_names),
        sorted(port_names - ref_names))
    for name in sorted(port_names):
        a, b = ref.get(name), port.get(name)
        assert (b.kind, b.labelnames, b.help) == \
            (a.kind, a.labelnames, a.help), name
        if a.kind == "histogram":
            assert b.buckets == a.buckets, name
    assert all(telemetry.NOT_REGISTERED.values())
    # the jit cache (4), buffer donation (1), and the compile ledger's (6)
    # and the cost model's (4) families, which wait for Q1.12c
    assert len(telemetry.NOT_REGISTERED) == 15
    waiting = {n for n, why in telemetry.NOT_REGISTERED.items()
               if why.endswith("waits for Q1.12c")}
    assert waiting == {n for n in skipped if n.startswith(
        ("mxtpu_compile_", "mxtpu_cost_", "mxtpu_ir_guard_"))}
    assert len(waiting) == 10
    assert {"mxtpu_goodput_seconds_total", "mxtpu_goodput_wall_seconds",
            "mxtpu_debug_requests_total", "mxtpu_fleet_processes",
            "mxtpu_fleet_replicas", "mxtpu_fleet_health"} <= port_names


def _families(text):
    """Prometheus text as {family: its lines}, the order of families
    dropped (the reference's offline renderer sorts them)."""
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            name = line.split(" ")[2]
            if name != cur:
                cur = name
                out[cur] = []
        out[cur].append(line)
    return out


def test_port_snapshot_renders_as_the_port_exposition():
    """The reference's prometheus_from_snapshot of a port snapshot is the
    port's own exposition, family for family."""
    with telemetry.span("test.render"):
        pass
    # a scrape by a thread left running elsewhere can bump a series between
    # the two reads: take them until two agree on the whole registry
    for _ in range(3):
        snap = telemetry.snapshot()
        text = telemetry.prometheus_text()
        if _families(ref_prometheus_from_snapshot(snap)) == _families(text):
            break
    assert _families(ref_prometheus_from_snapshot(snap)) == _families(text)


def test_histogram_percentiles_match_the_reference():
    rng = onp.random.RandomState(0)
    vals = rng.lognormal(mean=6.0, sigma=1.5, size=700)
    hp = MetricsRegistry().histogram("mxtpu_test_pct_us")
    hj = jtelemetry.MetricsRegistry().histogram("mxtpu_test_pct_us")
    for v in vals:
        hp.observe(float(v))
        hj.observe(float(v))
    assert hp.summary() == hj.summary()
    for p in (1, 50, 90, 95, 99, 99.9, 100):
        assert hp.percentile(p) == hj.percentile(p)
    from mxnet_tpu.serving.stats import LatencyHistogram as JLat
    from mxnet_tpu_torch.serving.stats import LatencyHistogram as PLat
    lp, lj = PLat(), JLat()
    for v in vals:
        lp.record(float(v))
        lj.record(float(v))
    assert lp.snapshot() == lj.snapshot()


# ---------------------------------------------------------------------------
# the same work moves the same families in both packages
# ---------------------------------------------------------------------------
def _series(registry, prefix):
    """{(family, labels): value or histogram count} of counter and
    histogram families whose name starts with ``prefix``."""
    out = {}
    for name, fam in registry.snapshot()["metrics"].items():
        if not name.startswith(prefix) or fam["type"] == "gauge":
            continue
        for s in fam["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if fam["type"] == "histogram" \
                else s["value"]
    return out


def _delta(before, after, skip=()):
    return {k: after[k] - before.get(k, 0) for k in after
            if k[0] not in skip and after[k] != before.get(k, 0)}


# counters whose value is seconds (wall time), not a count of events
_TIMED = ("mxtpu_serving_compile_seconds_total",)


def test_serving_families_move_alike():
    """A small Dense net served through both packages' servers with the
    same requests and buckets gives the same delta of every
    mxtpu_serving_* counter (by label) and histogram count."""
    x = onp.random.RandomState(3).randn(5, 8).astype("float32")
    jnet = jnn.Dense(4, in_units=8)
    jnet.initialize()
    pnet = pnn.Dense(4, in_units=8)
    pnet.initialize(ctx=mt.cpu())
    deltas = []
    for pkg, srv_mod, net, reg, kw in (
            ("ref", jserving, jnet, jtelemetry.REGISTRY, {}),
            ("port", serving, pnet, telemetry.REGISTRY, {"ctx": mt.cpu()})):
        before = _series(reg, "mxtpu_serving_")
        ep = srv_mod.ModelEndpoint("t_tel_alike", net, input_shapes=(8,),
                                   max_batch_size=2, **kw)
        srv = srv_mod.InferenceServer(batch_timeout_ms=1.0, max_queue=16)
        srv.register(ep)
        srv.start()
        try:
            for row in x[:3]:
                srv.predict("t_tel_alike", row, timeout=60)
            srv.predict("t_tel_alike", x[3:5], timeout=60)
        finally:
            srv.stop()
            srv_mod.unregister("t_tel_alike")
        deltas.append(_delta(before, _series(reg, "mxtpu_serving_"),
                             skip=_TIMED))
    ref, port = deltas
    assert ref == port
    lab = (("endpoint", "t_tel_alike"), ("event", "completed"))
    assert port[("mxtpu_serving_requests_total", lab)] == 4


def test_train_kvstore_dataloader_families_move_alike():
    """Two ParallelTrainStep steps, one kvstore pushpull and one DataLoader
    epoch move the train, kvstore and dataloader families alike."""
    prefixes = ("mxtpu_train_", "mxtpu_kvstore_", "mxtpu_dataloader_")
    xs = onp.random.RandomState(0).randn(16, 8).astype("float32")
    ys = onp.random.RandomState(1).randn(16, 1).astype("float32")
    ds = onp.arange(64, dtype="float32").reshape(16, 4)

    def ref_work():
        net = jnn.Dense(1, in_units=8)
        net.initialize(mx.init.Constant(0.05))
        import jax
        step = jparallel.ParallelTrainStep(
            net, jloss.L2Loss(), mx.optimizer.SGD(learning_rate=0.1),
            jparallel.make_mesh({"dp": 1}, devices=jax.devices()[:1]))
        for _ in range(2):
            step(mx.nd.array(xs), mx.nd.array(ys))
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.zeros((64, 64)))
        kv.pushpull("w", mx.nd.ones((64, 64)), out=mx.nd.zeros((64, 64)))
        for _ in JDataLoader(JArrayDataset(ds), batch_size=4):
            pass

    def port_work():
        with mt.cpu():
            net = pnn.Dense(1, in_units=8)
            net.initialize(mt.init.Constant(0.05), ctx=mt.cpu())
            step = mt.parallel.ParallelTrainStep(
                net, ploss.L2Loss(), mt.optimizer.SGD(learning_rate=0.1),
                mt.parallel.make_mesh({"dp": 1}, ctx=mt.cpu()))
            for _ in range(2):
                step(xs, ys)
            kv = mt.kv.create("local")
            kv.init("w", mt.nd.zeros((64, 64)))
            kv.pushpull("w", mt.nd.ones((64, 64)), out=mt.nd.zeros((64, 64)))
            for _ in DataLoader(ArrayDataset(ds), batch_size=4):
                pass

    got = {}
    for pkg, reg, work in (("ref", jtelemetry.REGISTRY, ref_work),
                           ("port", telemetry.REGISTRY, port_work)):
        before = {p: _series(reg, p) for p in prefixes}
        work()
        got[pkg] = {p: _delta(before[p], _series(reg, p)) for p in prefixes}
    assert got["ref"] == got["port"]
    port = got["port"]
    assert port["mxtpu_train_"][("mxtpu_train_steps_total", ())] == 2
    assert port["mxtpu_train_"][("mxtpu_train_examples_total", ())] == 32
    assert port["mxtpu_kvstore_"][("mxtpu_kvstore_push_bytes_total",
                                   ())] == 64 * 64 * 4
    assert port["mxtpu_dataloader_"][("mxtpu_dataloader_batches_total",
                                      ())] == 4


# ---------------------------------------------------------------------------
# spans across the serving queue hop, into the profiler
# ---------------------------------------------------------------------------
@pytest.fixture
def _profiler_events():
    profiler._STATE["events"].clear()
    profiler._STATE["agg"].clear()
    profiler._STATE["running"] = True
    try:
        yield profiler._STATE["events"]
    finally:
        profiler._STATE["running"] = False
        profiler._STATE["events"].clear()
        profiler._STATE["agg"].clear()


def test_spans_feed_profiler_chrome_trace(_profiler_events):
    with telemetry.span("test.profiled", shard=3) as s:
        pass
    evs = [e for e in _profiler_events if e["name"] == "test.profiled"]
    assert len(evs) == 1
    ev = evs[0]
    assert ev["ph"] == "X" and ev["cat"] == "span"
    assert ev["args"]["trace_id"] == s.trace_id
    assert ev["args"]["span_id"] == s.span_id
    assert ev["args"]["shard"] == 3


@pytest.mark.parametrize("pipeline", [False, True])
def test_serving_trace_id_survives_queue_hop(_profiler_events, pipeline):
    """The request's trace id at submit is the trace id of the worker's
    serving.batch and serving.device_step spans (and of serving.prep in
    the pipelined server), in the serial and the pipelined server."""
    net = pnn.Dense(4, in_units=8)
    net.initialize(ctx=mt.cpu())
    ep = serving.ModelEndpoint("t_trace", net, input_shapes=(8,),
                               max_batch_size=2, ctx=mt.cpu())
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=16,
                                  pipeline=pipeline)
    srv.register(ep)
    srv.start()
    try:
        with telemetry.span("test.client") as s:
            srv.predict("t_trace", onp.ones((8,), "float32"), timeout=60)
    finally:
        srv.stop()
        serving.unregister("t_trace")
    by_name = {}
    for e in list(_profiler_events):
        by_name.setdefault(e["name"], []).append(e)
    names = ["serving.batch", "serving.device_step", "serving.prep"]
    for name in names:
        assert by_name.get(name), name
        assert by_name[name][0]["args"]["trace_id"] == s.trace_id, name
    assert by_name["serving.batch"][0]["args"]["endpoint"] == "t_trace"
    # the step ran as one profiler event, the request as one duration
    assert by_name.get("serving[t_trace]b1")
    assert by_name.get("serving[t_trace].request")


def test_trace_id_and_flight_request_ring():
    """A completed request lands in the flight ring under its trace id."""
    net = pnn.Dense(4, in_units=8)
    net.initialize(ctx=mt.cpu())
    ep = serving.ModelEndpoint("t_ring", net, input_shapes=(8,),
                               max_batch_size=2, ctx=mt.cpu())
    srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=16)
    srv.register(ep)
    srv.start()
    try:
        with telemetry.span("test.ring") as s:
            srv.predict("t_ring", onp.ones((8,), "float32"), timeout=60)
    finally:
        srv.stop()
        serving.unregister("t_ring")
    reqs = [r for r in telemetry.flight.recent_requests()
            if r["endpoint"] == "t_ring"]
    assert reqs and reqs[-1]["trace_id"] == s.trace_id and reqs[-1]["ok"]


# ---------------------------------------------------------------------------
# the reference's reader of a port dump, and the whole port's lint
# ---------------------------------------------------------------------------
def test_reference_metrics_dump_renders_port_dump(tmp_path):
    with telemetry.span("test.dumptool"):
        pass
    path = str(tmp_path / "snap.json")
    telemetry.dump(path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "metrics_dump.py"),
         path, "--prom"], capture_output=True, text=True, timeout=240,
        env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    kinds = _assert_prometheus_parses(out.stdout)
    assert kinds["mxtpu_span_duration_us"] == "histogram"
    table = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "metrics_dump.py"),
         path], capture_output=True, text=True, timeout=240, env=env,
        cwd=REPO)
    assert table.returncode == 0 and "mxtpu_span_duration_us" in table.stdout


def test_telemetry_dump_prometheus_file(tmp_path):
    path = str(tmp_path / "metrics.prom")
    telemetry.dump(path, prometheus=True)
    _assert_prometheus_parses(open(path).read())


def test_whole_port_lint_clean():
    names = telemetry.REGISTRY.names()
    assert telemetry.lint_names() == []
    assert len(names) == len(set(names))
    assert all(METRIC_NAME_RE.match(n) for n in names)


def test_quantile_estimator_is_the_reference_one():
    from mxnet_tpu.telemetry.metrics import (
        _quantile_from_buckets as ref_quantile)
    bounds = (1.0, 2.0, 4.0, 8.0)
    for counts, n, p, mx_seen in (([1, 2, 3, 4, 5], 15, 50, 20.0),
                                  ([0, 0, 0, 0, 2], 2, 99, 33.0),
                                  ([5, 0, 0, 0, 0], 5, 1, 0.5),
                                  ([0, 0, 0, 0, 0], 0, 50, 0.0)):
        assert _quantile_from_buckets(bounds, counts, n, p, mx_seen) == \
            ref_quantile(bounds, counts, n, p, mx_seen)
