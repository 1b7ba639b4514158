"""The port's goodput ledger and fleet pane (``mxnet_tpu_torch.telemetry.
goodput``, ``.fleet``, the front door's ``fleet_collect`` and
``goodput_reconcile``) held against the JAX package's on the CPU.

- ``goodput.attribute`` gives the reference's dict, key for key and bit for
  bit, on the same seeded snapshots: without and with a wall anchor, with
  the proportional rescale of overlapped work, and with the compile
  bucket's fallback when no compile-ledger series exists;
- ``goodput.account`` reconciles a live run: the published buckets sum to
  the published wall gauge within 1% (the reference's bar);
- ``merge_histogram_series`` / ``merge_snapshots``: the reference's merge of
  the port's dumps is the port's merge of them (the ``ts`` stamp aside),
  merged quantiles are exactly the concatenated observations', and
  mismatched ladders are skipped;
- a two-host ``FrontDoor`` on the CPU: three sources, both hosts' goodput
  reconciled, and the reference's ``tools/fleet_report.py`` and
  ``tools/trace_journey.py`` exit 0 on the agents' dumps and spools;
- the invariants ``tests/test_fleet.py::test_fleet_acceptance_journey_and_report``
  states, held by the port: one ordered journey across a pool's replicas
  and a second process, and a fleet report whose goodput reconciles.

The registry is process-wide and a test worker runs many files in a row:
every check on the shared registry compares deltas, knobs are set through
``monkeypatch`` and the tracing caches are reset around them."""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import pytest
import torch

from mxnet_tpu.telemetry import fleet as jfleet
from mxnet_tpu.telemetry import goodput as jgoodput

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.serving.fabric import FrontDoor
from mxnet_tpu_torch.telemetry import debug_server as dbg
from mxnet_tpu_torch.telemetry import fleet, goodput, tracing
from mxnet_tpu_torch.telemetry.metrics import MetricsRegistry

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
TOOL_TIMEOUT = 120


def _tool(name):
    sys.path.insert(0, TOOLS)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _wait(pred, timeout=60.0):
    t_end = time.time() + timeout
    while time.time() < t_end:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _mlp(seed, out_dim=3):
    mt.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=6),
            nn.Dense(out_dim, in_units=8))
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    return net


# ---------------------------------------------------------------------------
# goodput attribution: the reference's arithmetic, bit for bit
# ---------------------------------------------------------------------------
def _hist(rng, names=None, label="name"):
    if names is None:
        return {"type": "histogram", "series": [
            {"labels": {}, "sum": float(rng.uniform(0, 3e6)),
             "count": int(rng.integers(1, 100))}]}
    return {"type": "histogram", "series": [
        {"labels": {label: n}, "sum": float(rng.uniform(0, 2e6)),
         "count": int(rng.integers(1, 50))} for n in names]}


def _seeded_snap(seed, ledger):
    """Every source series goodput reads, with seeded values; ``ledger``
    adds the compile ledger's family (the port never registers it)."""
    rng = onp.random.default_rng(seed)
    m = {
        "mxtpu_serving_compile_seconds_total": {"type": "counter", "series": [
            {"labels": {"endpoint": e}, "value": float(rng.uniform(0, 4))}
            for e in ("a", "b")]},
        "mxtpu_exec_cache_deserialize_seconds_total": {
            "type": "counter", "series": [
                {"labels": {}, "value": float(rng.uniform(0, 1))}]},
        "mxtpu_dataloader_wait_us": _hist(rng),
        "mxtpu_train_step_latency_us": _hist(rng),
        "mxtpu_serving_step_latency_us": _hist(rng, ("a", "b"), "endpoint"),
        "mxtpu_decode_step_us": _hist(rng),
        "mxtpu_decode_prefill_us": _hist(rng),
        "mxtpu_checkpoint_save_duration_us": _hist(rng),
        "mxtpu_preempt_flush_duration_us": _hist(rng),
        # recovery and drain spans count; train.step must not double-count
        "mxtpu_span_duration_us": _hist(
            rng, ("checkpoint.restore", "resilience.retry",
                  "serving.failover", "serving.drain", "train.step",
                  "serving.batch")),
    }
    if ledger:
        m["mxtpu_compile_wall_seconds_total"] = {"type": "counter", "series": [
            {"labels": {"site": "s", "phase": p},
             "value": float(rng.uniform(0, 2))} for p in ("lower", "compile")]}
    return {"metrics": m}


@pytest.mark.parametrize("ledger", [False, True], ids=["fallback", "ledger"])
@pytest.mark.parametrize("elapsed", [None, 1e4, 3.0, 0.0],
                         ids=["no-anchor", "idle", "rescaled", "zero-wall"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_is_the_references(seed, elapsed, ledger):
    snap = _seeded_snap(seed, ledger)
    got, want = goodput.attribute(snap, elapsed), jgoodput.attribute(
        snap, elapsed)
    assert got == want
    assert tuple(got) == tuple(want)
    assert set(got) == set(goodput.BUCKETS)
    assert all(v >= 0.0 for v in got.values())
    if elapsed is not None:
        assert sum(got.values()) == pytest.approx(elapsed, rel=1e-9,
                                                  abs=1e-12)


def test_constants_and_families_are_the_references():
    assert goodput.BUCKETS == jgoodput.BUCKETS
    assert goodput.RECOVERY_SPANS == jgoodput.RECOVERY_SPANS
    assert goodput.DRAIN_SPANS == jgoodput.DRAIN_SPANS
    for mod_p, mod_j in ((goodput, jgoodput), (fleet, jfleet)):
        assert set(mod_p.__all__) == set(mod_j.__all__)
    assert telemetry.REGISTRY.get("mxtpu_goodput_seconds_total") \
        is goodput._GOODPUT
    assert goodput.utilization() == []          # no compile ledger yet


def test_utilization_takes_records_as_an_argument():
    """Until the port has compile records (ROADMAP Q1.12c) utilization is
    empty, and records handed in are refused rather than ignored."""
    snap = _seeded_snap(3, False)
    assert goodput.utilization(snap) == []
    assert goodput.utilization(snap, []) == []
    records = [{"fingerprint": "f" * 20, "site": "serving_bucket",
                "key": {"endpoint": "a"}, "flops": 2e9}]
    with pytest.raises(NotImplementedError, match="Q1.12c"):
        goodput.utilization(snap, records)


def test_account_reconciles_a_live_run():
    """The published counter series sum to the published wall gauge within
    1%, and stay so on a second accounting (monotone counter, deltas)."""
    goodput.reset()
    with telemetry.span("checkpoint.restore"):
        time.sleep(0.02)
    time.sleep(0.01)
    buckets = goodput.account()
    assert buckets["retry_recovery"] > 0.0 and buckets["idle"] >= 0.0

    def reconciled():
        snap = telemetry.REGISTRY.snapshot()
        fam = snap["metrics"]["mxtpu_goodput_seconds_total"]
        total = sum(s["value"] for s in fam["series"])
        wall = snap["metrics"]["mxtpu_goodput_wall_seconds"]["series"][0][
            "value"]
        assert wall > 0.0
        assert abs(total - wall) <= 0.01 * wall
        return {s["labels"]["bucket"]: s["value"] for s in fam["series"]}

    first = reconciled()
    # a bucket is emitted once it holds time: the zero ones have no series
    assert first == pytest.approx({b: v for b, v in buckets.items() if v})
    time.sleep(0.01)
    goodput.account()
    second = reconciled()
    assert all(second[b] >= first[b] for b in first)   # monotone
    goodput.reset()
    assert goodput.wall_seconds() < 1.0
    snap = telemetry.REGISTRY.snapshot()
    assert all(s["value"] == 0.0 for s in
               snap["metrics"]["mxtpu_goodput_seconds_total"]["series"])


# ---------------------------------------------------------------------------
# merging: the reference's merge of the port's dumps is the port's merge
# ---------------------------------------------------------------------------
def _seeded_registry(seed, bounds):
    rng = onp.random.default_rng(seed)
    reg = MetricsRegistry()
    h = reg.histogram("mxtpu_test_lat_us", "t", labelnames=("endpoint",),
                      buckets=bounds)
    for ep in ("e", "f"):
        child = h.labels(ep)
        for v in rng.gamma(2.0, 300.0, int(rng.integers(20, 200))):
            child.observe(float(v))
    c = reg.counter("mxtpu_test_ops_total", "ops", labelnames=("kind",))
    c.labels("x").inc(int(rng.integers(1, 50)))
    c.labels("y").inc(int(rng.integers(1, 50)))
    reg.gauge("mxtpu_test_depth", "depth").set(float(rng.integers(0, 9)))
    return reg


def _ladder(seed):
    rng = onp.random.default_rng(seed)
    return sorted(float(v) for v in set(rng.integers(1, 5000, 12)))


def _strip_ts(merged):
    merged = dict(merged)
    merged.pop("ts")
    return merged


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_snapshots_of_port_dumps_is_the_references(seed, tmp_path):
    bounds = _ladder(seed)
    paths = []
    for i in range(3):
        p = tmp_path / f"rep{i}.json"
        p.write_text(json.dumps(_seeded_registry(seed * 10 + i,
                                                 bounds).snapshot()))
        paths.append(p)
    live = tmp_path / "live.json"
    with telemetry.span("test.merge"):
        pass
    telemetry.dump(str(live))                 # the port's own dump file
    paths.append(live)
    snaps = {p.name: json.loads(p.read_text()) for p in paths}
    got, want = fleet.merge_snapshots(snaps), jfleet.merge_snapshots(snaps)
    assert _strip_ts(got) == _strip_ts(want)
    fam = got["metrics"]["mxtpu_test_lat_us"]
    assert fam["label_names"] == ["replica", "endpoint"]
    alls = [s for s in fam["series"] if s["labels"]["replica"] == "ALL"]
    assert sorted(s["labels"]["endpoint"] for s in alls) == ["e", "f"]
    for s in alls:                      # element-wise bucket-count sums
        parts = [x for x in fam["series"] if x["labels"]["replica"] != "ALL"
                 and x["labels"]["endpoint"] == s["labels"]["endpoint"]]
        assert s["bucket_counts"] == [sum(c) for c in zip(
            *(x["bucket_counts"] for x in parts))]
    ops = got["metrics"]["mxtpu_test_ops_total"]["series"]
    for kind in ("x", "y"):
        rows = [s for s in ops if s["labels"]["kind"] == kind]
        (total,) = [s["value"] for s in rows
                    if s["labels"]["replica"] == "ALL"]
        assert total == sum(s["value"] for s in rows
                            if s["labels"]["replica"] != "ALL")
    # gauges get no ALL row: a sum would be a value no process reported
    assert all(s["labels"]["replica"] != "ALL" for s in
               got["metrics"]["mxtpu_test_depth"]["series"])


def test_merged_quantiles_equal_concatenated_observations(tmp_path):
    """Through the reference's ``tools/metrics_dump.py`` multi-file path
    on two port dumps: the ALL row is the histogram of every observation."""
    rng = onp.random.default_rng(5)
    obs_a, obs_b = rng.gamma(2.0, 200.0, 400), rng.gamma(3.0, 80.0, 250)

    def snap_with(obs):
        reg = MetricsRegistry()
        child = reg.histogram("mxtpu_test_lat_us", "t",
                              labelnames=("endpoint",)).labels("e")
        for v in obs:
            child.observe(float(v))
        return reg.snapshot()

    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(snap_with(obs_a)))
    pb.write_text(json.dumps(snap_with(obs_b)))
    ref = snap_with(onp.concatenate([obs_a, obs_b]))
    ref_s = ref["metrics"]["mxtpu_test_lat_us"]["series"][0]
    for merged in (_tool("metrics_dump").load_merged([str(pa), str(pb)]),
                   fleet.merge_snapshots({"a.json": json.loads(pa.read_text()),
                                          "b.json": json.loads(pb.read_text())
                                          })):
        fam = merged["metrics"]["mxtpu_test_lat_us"]
        (all_row,) = [s for s in fam["series"]
                      if s["labels"]["replica"] == "ALL"]
        assert all_row["count"] == ref_s["count"]
        assert all_row["bucket_counts"] == ref_s["bucket_counts"]
        for q in ("p50", "p95", "p99", "min", "max"):
            assert all_row[q] == ref_s[q], q
        assert all_row["sum"] == pytest.approx(ref_s["sum"])


def test_merge_skips_mismatched_bucket_ladders():
    bounds = [1.0, 2.0]
    bad = [{"bucket_counts": [1, 0, 0], "count": 1, "sum": 1.0, "min": 1.0,
            "max": 1.0},
           {"bucket_counts": [1, 0], "count": 1, "sum": 1.0, "min": 1.0,
            "max": 1.0}]
    with pytest.raises(ValueError):
        fleet.merge_histogram_series(bounds, bad)
    fam = {"type": "histogram", "help": "", "label_names": [],
           "bucket_bounds": bounds}
    sa = {"metrics": {"mxtpu_test_m": dict(fam, series=[
        {"labels": {}, "count": 1, "sum": 1.0, "mean": 1.0, "min": 1.0,
         "max": 1.0, "p50": 1, "p95": 1, "p99": 1,
         "bucket_counts": [1, 0, 0]}])}}
    sb = {"metrics": {"mxtpu_test_m": dict(
        fam, bucket_bounds=[5.0, 9.0, 11.0], series=[
            {"labels": {}, "count": 1, "sum": 5.0, "mean": 5.0, "min": 5.0,
             "max": 5.0, "p50": 5, "p95": 5, "p99": 5,
             "bucket_counts": [1, 0, 0, 0]}])}}
    merged = fleet.merge_snapshots({"a": sa, "b": sb})
    series = merged["metrics"]["mxtpu_test_m"]["series"]
    assert {s["labels"]["replica"] for s in series} == {"a", "b"}   # no ALL
    assert _strip_ts(merged) == _strip_ts(
        jfleet.merge_snapshots({"a": sa, "b": sb}))


def test_collector_skips_half_written_dumps(tmp_path, monkeypatch):
    good = tmp_path / "good.json"
    telemetry.dump(str(good))
    (tmp_path / "half.json").write_text('{"metrics": {"mxtpu_')
    (tmp_path / "gone.json").mkdir()               # unreadable as a file
    monkeypatch.setenv("MXNET_FLEET_DUMP_GLOB", str(tmp_path / "*.json"))
    doc = fleet.FleetCollector(local_label="me").collect()
    assert set(doc["sources"]) == {"good.json", "me"}
    assert doc["processes"] == 2
    assert telemetry.REGISTRY.get("mxtpu_fleet_processes").value == 2
    coll = fleet.FleetCollector(include_local=False, glob="")
    coll.add_file(str(tmp_path / "half.json"))
    assert coll.collect()["processes"] == 0


# ---------------------------------------------------------------------------
# the front door's fleet pane, with the reference's readers on its files
# ---------------------------------------------------------------------------
def _host_factory(tenant, net):
    def factory(name):
        srv = serving.InferenceServer(batch_timeout_ms=1.0)
        srv.register(serving.ModelEndpoint(tenant, net, input_shapes=(6,),
                                           max_batch_size=4, ctx=mt.cpu()))
        srv.start()
        return srv
    return factory


def _run_tool(args):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True,
                          timeout=TOOL_TIMEOUT)


def _attached():
    return {id(o) for o in (*dbg.attached_servers(), *dbg.attached_pools(),
                            *dbg.attached_autoscalers())}


def _detach_new(before):
    """Detach what the test attached (servers start attached), leaving
    other tests' attachments alone."""
    for s in dbg.attached_servers():
        if id(s) not in before:
            dbg.detach(s)
    for p in dbg.attached_pools():
        if id(p) not in before:
            dbg.detach_pool(p)
    for a in dbg.attached_autoscalers():
        if id(a) not in before:
            dbg.detach_autoscaler(a)


def test_frontdoor_fleet_pane_and_the_reference_readers(tmp_path,
                                                        monkeypatch):
    spool, work = tmp_path / "spool", tmp_path / "fabric"
    work.mkdir()
    tid = telemetry.new_trace_id()
    monkeypatch.setenv("MXNET_SPAN_SPOOL_DIR", str(spool))
    monkeypatch.setenv("MXNET_TRACE_ID", tid)
    monkeypatch.setenv("MXNET_FABRIC_HEARTBEAT_S", "0.1")
    tenant = "gf_fd"
    net = _mlp(31)
    x = onp.random.default_rng(31).standard_normal((2, 6)).astype("float32")
    before = _attached()
    with mt.cpu():
        fd = FrontDoor(["h0", "h1"], _host_factory(tenant, net),
                       supervise=False, workdir=str(work))
    try:
        ticks = {}

        def three_ticks():
            for h in ("h0", "h1"):
                try:
                    snap = json.loads((work / f"dump-{h}.json").read_text())
                except (OSError, ValueError):
                    return False
                wall = snap["metrics"]["mxtpu_goodput_wall_seconds"][
                    "series"][0]["value"]
                ticks.setdefault(h, set()).add(wall)
            return all(len(v) >= 3 for v in ticks.values()) and \
                len(ticks) == 2
        outs = [fd.submit(tenant, x).result(timeout=60) for _ in range(6)]
        assert _wait(three_ticks, 90)
        doc = fd.fleet_collect()
        assert set(doc["sources"]) == {f"frontdoor-{os.getpid()}",
                                       "host-h0", "host-h1"}
        assert doc["processes"] == 3
        merged = doc["merged"]["metrics"]["mxtpu_serving_requests_total"]
        for key in {tuple(sorted((k, v) for k, v in s["labels"].items()
                                 if k != "replica"))
                    for s in merged["series"]}:
            rows = [s for s in merged["series"] if tuple(sorted(
                (k, v) for k, v in s["labels"].items() if k != "replica"))
                == key]
            parts = [s["value"] for s in rows
                     if s["labels"]["replica"] != "ALL"]
            alls = [s["value"] for s in rows
                    if s["labels"]["replica"] == "ALL"]
            assert alls == ([sum(parts)] if len(parts) > 1 else [])
        rec = fd.goodput_reconcile()
        assert set(rec) == {"h0", "h1"}
        assert all(r["ok"] and r["wall_s"] > 0 for r in rec.values()), rec
        dumps = [str(work / "dump-h0.json"), str(work / "dump-h1.json")]
        with ThreadPoolExecutor(2) as ex:
            report, journey = ex.map(_run_tool, [
                [os.path.join(TOOLS, "fleet_report.py")] + dumps
                + ["--verify"],
                [os.path.join(TOOLS, "trace_journey.py"), str(spool),
                 "--trace", tid, "--json"]])
    finally:
        fd.stop()
        serving.unregister(tenant)
        _detach_new(before)
        monkeypatch.undo()
        tracing._reset_spool_for_tests()
    with torch.inference_mode():
        direct = net(torch.from_numpy(x))
    assert all(torch.equal(o, direct) for o in outs)
    assert report.returncode == 0, report.stderr[-2000:]
    assert "goodput ledger" in report.stdout and "MISMATCH" not in \
        report.stdout
    assert journey.returncode == 0, journey.stderr[-2000:]
    hops = json.loads(journey.stdout)["hops"]
    agents = [h for h in hops if h["name"] == "fabric.host_agent"]
    assert sorted(h["attrs"]["host"] for h in agents) == ["h0", "h1"]
    assert len({h["pid"] for h in agents}) == 2
    assert os.getpid() not in {h["pid"] for h in agents}


# ---------------------------------------------------------------------------
# the acceptance journey's invariants (tests/test_fleet.py:423), held by the
# port: a pooled burst and a second process -> one journey + one report
# ---------------------------------------------------------------------------
class _StubMonitor:
    burn_threshold = 14.0

    def __init__(self):
        self.fast_burn = 0.0
        self.alert = False

    def check_all(self):
        return [{"endpoint": "e", "fast_burn": self.fast_burn,
                 "slow_burn": self.fast_burn, "alert_active": self.alert}]


# the restarted process: the port only; serves one request, accounts its
# goodput and leaves its dump and spool lines for the fleet tools
_RESTART_CHILD_SRC = """\
import os
import numpy as np
import torch
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.telemetry import goodput

torch.set_num_threads(1)
mt.random.seed(11)
net = nn.HybridSequential()
net.add(nn.Dense(8, activation="relu", in_units=6), nn.Dense(3, in_units=8))
net.initialize(mt.init.Xavier(), ctx=mt.cpu())
srv = serving.InferenceServer(batch_timeout_ms=1.0)
srv.register(serving.ModelEndpoint("gf_fleet_ep", net, input_shapes=(6,),
                                   max_batch_size=4, ctx=mt.cpu()))
srv.start()
srv.submit("gf_fleet_ep", np.ones((1, 6), "float32")).result(timeout=60)
srv.stop()
serving.unregister("gf_fleet_ep")
goodput.account()
telemetry.dump(os.environ["FLEET_DUMP"])
telemetry.spool_flush()
"""


def test_acceptance_journey_and_report_invariants(tmp_path, monkeypatch,
                                                  capsys):
    spool, dumps = tmp_path / "spool", tmp_path / "dumps"
    dumps.mkdir()
    name = "gf_fleet_ep"
    tid = telemetry.new_trace_id()
    monkeypatch.setenv("MXNET_SPAN_SPOOL_DIR", str(spool))
    monkeypatch.setenv("MXNET_TRACE_ID", tid)
    tracing._reset_spool_for_tests()
    goodput.reset()
    before = _attached()
    nets = {}

    def factory(rid):
        srv = serving.InferenceServer(batch_timeout_ms=20.0, max_queue=64)
        nets[rid] = _mlp(11)
        srv.register(serving.ModelEndpoint(name, nets[rid], input_shapes=(6,),
                                           max_batch_size=4, ctx=mt.cpu()))
        return srv

    try:
        pool = serving.ServingPool(factory, initial_replicas=2)
        mon = _StubMonitor()
        asc = serving.Autoscaler(pool, monitor=mon, min_replicas=1,
                                 max_replicas=3, up_n=2, down_n=3,
                                 cooldown_s=0.0, queue_high=0.9,
                                 queue_low=0.5)
        try:
            mon.alert, mon.fast_burn = True, 20.0   # one transition: 2 -> 3
            asc.tick(now=0.0)
            act = asc.tick(now=1.0)
            assert act and act["action"] == "up" and pool.size() == 3
            xs = onp.random.default_rng(3).standard_normal(
                (12, 6)).astype("float32")
            futs = [pool.submit(name, xs[i]) for i in range(12)]
            outs = torch.stack([f.result(timeout=60) for f in futs])
        finally:
            pool.stop(drain=True)
            serving.unregister(name)
        env = dict(os.environ, FLEET_DUMP=str(dumps / "child.json"),
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        child = subprocess.run([sys.executable, "-c", _RESTART_CHILD_SRC],
                               env=env, capture_output=True, text=True,
                               timeout=TOOL_TIMEOUT)
        assert child.returncode == 0, child.stderr[-2000:]
        telemetry.spool_flush()
        goodput.account()
        parent_dump = str(dumps / "parent.json")
        telemetry.dump(parent_dump)
    finally:
        _detach_new(before)
        monkeypatch.undo()
        tracing._reset_spool_for_tests()
        goodput.reset()
    # every replica serves the same weights: within f32 sum order of the
    # direct forward (a batch's row count picks the CPU product's blocking)
    with torch.inference_mode():
        direct = nets[0](torch.from_numpy(xs))
    assert torch.allclose(outs, direct, rtol=1e-6, atol=1e-6)

    # -- the reference's tools/trace_journey.py: ONE ordered timeline -------
    trace_journey = _tool("trace_journey")
    assert trace_journey.main([str(spool), "--trace", tid, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    hops, procs = doc["hops"], doc["processes"]
    walls = [h["t0_wall"] for h in hops]
    assert walls == sorted(walls)
    pids = {p for p in procs if p.startswith("pid=")}
    reps = {p for p in procs if p.startswith("replica=")}
    assert f"pid={os.getpid()}" in pids and len(pids) == 2
    assert len(reps) >= 2
    served = {(h.get("attrs") or {}).get("replica") for h in hops
              if h["name"] == "pool.submit"}
    assert reps == {f"replica={r}" for r in served}
    assert trace_journey.main([str(spool), "--trace", tid]) == 0
    rendered = capsys.readouterr().out
    assert all(p in rendered for p in pids | reps)

    # -- the reference's tools/fleet_report.py over the same run ------------
    fleet_report = _tool("fleet_report")
    paths = [str(dumps / "child.json"), parent_dump]
    report = fleet_report.build_report(paths, spool_dir=str(spool), trace=tid)
    assert report["goodput_ok"]
    for label, gp in report["goodput"].items():
        assert gp["wall_s"] is not None and gp["wall_s"] > 0.0, label
        assert abs(gp["sum_s"] - gp["wall_s"]) <= 0.01 * gp["wall_s"], label
    fam = report["merged"]["metrics"]["mxtpu_span_duration_us"]
    assert any(s["labels"].get("replica") == "ALL" for s in fam["series"])
    assert report["journey"]["processes"] == procs
    assert fleet_report.main(paths + ["--spool-dir", str(spool), "--trace",
                                      tid, "--verify"]) == 0
    capsys.readouterr()
