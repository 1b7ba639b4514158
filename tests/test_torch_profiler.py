"""The port's profiler (mxnet_tpu_torch.profiler) on the CPU: the nine cases
of the JAX package's tests/test_profiler.py (every op dispatch and a
hybridized block's call recorded without annotations, nothing recorded
when stopped, the chrome-trace dump and its schema, atomic counters, the
JSON aggregate, the continuous dump), telemetry spans in the same chrome
trace, and the ``profile_all`` session on ``torch.profiler`` exported as a
chrome trace."""
import json
import os
import threading

import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler, telemetry
from mxnet_tpu_torch.gluon import nn

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_profiler_state():
    profiler._STATE["running"] = False
    profiler._STATE["events"].clear()
    profiler._STATE["agg"].clear()
    with mt.cpu():
        yield
    if profiler._STATE["torch_session"] is not None:
        profiler.stop()
    profiler._STATE["running"] = False
    profiler._STATE["events"].clear()
    profiler._STATE["agg"].clear()
    profiler.set_config()


def test_eager_ops_recorded_without_annotations():
    a = mt.nd.ones((4, 4))
    b = mt.nd.ones((4, 4))
    profiler.start()
    c = (a + b) * 2
    d = mt.nd.dot(c, c)
    d.wait_to_read()
    profiler.stop()
    table = profiler.dumps()
    assert "dot" in table
    agg = profiler._STATE["agg"]
    assert any(v[0] >= 1 for v in agg.values())
    for name, (count, total, mn, mx_) in agg.items():
        assert count >= 1
        assert total >= 0.0


def test_ops_not_recorded_when_stopped():
    a = mt.nd.ones((2, 2))
    _ = a + a
    assert not profiler._STATE["agg"]


def test_cached_op_path_recorded():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(4))
    net.initialize(ctx=mt.cpu())
    net.hybridize()
    x = mt.nd.ones((2, 16))
    net(x)
    profiler.start()
    y = net(x)
    y.wait_to_read()
    profiler.stop()
    table = profiler.dumps()
    assert "CachedOp[HybridSequential]" in table
    # the hybridized children ran inside the one event
    assert "CachedOp[Dense]" not in table


def test_chrome_trace_dump(tmp_path):
    fname = str(tmp_path / "profile.json")
    profiler.set_config(filename=fname)
    a = mt.nd.ones((4,))
    profiler.start()
    (a * 3).wait_to_read()
    profiler.stop()
    profiler.dump()
    with open(fname) as f:
        trace = json.load(f)
    assert "traceEvents" in trace
    assert len(trace["traceEvents"]) >= 1
    ev = trace["traceEvents"][0]
    assert {"name", "ph", "ts", "dur"} <= set(ev)


def test_counter_increment_is_atomic_under_threads():
    c = profiler.Counter("race_counter")
    n_threads, n_iter = 8, 5000

    def bump():
        for _ in range(n_iter):
            c.increment()

    threads = [threading.Thread(target=bump) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == n_threads * n_iter
    threads = [threading.Thread(target=lambda: [c.decrement()
                                                for _ in range(n_iter)])
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert c.value == 0


def test_counter_events_emitted_under_lock_while_running():
    profiler.start()
    c = profiler.Counter("tracked", value=10)
    c.increment(5)
    c.decrement(3)
    profiler.stop()
    evs = [e for e in profiler._STATE["events"] if e["name"] == "tracked"]
    assert [e["args"]["value"] for e in evs] == [15, 12]
    assert all(e["ph"] == "C" for e in evs)


def test_dumps_json_format():
    a = mt.nd.ones((4, 4))
    profiler.start()
    mt.nd.dot(a, a).wait_to_read()
    profiler.stop()
    table = json.loads(profiler.dumps(format="json"))
    assert "dot" in table
    row = table["dot"]
    assert row["count"] >= 1
    assert row["total_us"] >= row["min_us"] >= 0
    assert row["max_us"] >= row["avg_us"] > 0 or row["total_us"] == 0
    assert "Name" in profiler.dumps()
    with pytest.raises(ValueError):
        profiler.dumps(format="csv")


def test_continuous_dump_appends_and_clears(tmp_path):
    fname = str(tmp_path / "cont.json")
    profiler.set_config(filename=fname, continuous_dump=True)
    a = mt.nd.ones((8,))
    profiler.start()
    (a + a).wait_to_read()
    profiler.dump(finished=False)
    assert profiler._STATE["events"] == []
    n_first = len(open(fname).read().strip().splitlines())
    (a * 2).wait_to_read()
    (a * 3).wait_to_read()
    profiler.dump(finished=False)
    assert profiler._STATE["events"] == []
    assert len(open(fname).read().strip().splitlines()) > n_first
    profiler.stop()
    profiler.dump(finished=True)
    events = json.loads(open(fname).read())
    assert isinstance(events, list) and len(events) >= 3
    assert all("name" in e for e in events[:-1])


def test_chrome_trace_schema(tmp_path):
    fname = str(tmp_path / "schema.json")
    profiler.set_config(filename=fname)
    a = mt.nd.ones((4, 4))
    profiler.start()
    mt.nd.dot(a, a).wait_to_read()
    with profiler.scope("user_scope"):
        (a + 1).wait_to_read()
    with telemetry.span("test.schema_span"):
        pass
    c = profiler.Counter("schema_counter")
    c.increment(7)
    profiler.Marker("schema_marker").mark()
    t = profiler.Task("schema_task")
    t.start()
    t.stop()
    profiler.stop()
    profiler.dump()
    trace = json.loads(open(fname).read())
    events = trace["traceEvents"]
    assert len(events) >= 5
    phases = set()
    for ev in events:
        assert {"name", "ph", "ts", "pid"} <= set(ev), f"bad event {ev}"
        assert isinstance(ev["ts"], int)
        phases.add(ev["ph"])
        if ev["ph"] == "X":
            assert "dur" in ev and ev["dur"] >= 0
        if ev["ph"] == "C":
            assert "args" in ev and "value" in ev["args"]
    assert {"X", "C", "i"} <= phases
    span_evs = [e for e in events if e["name"] == "test.schema_span"]
    assert span_evs and "trace_id" in span_evs[0]["args"]


def test_spans_land_in_the_chrome_trace_with_their_trace_id(tmp_path):
    fname = str(tmp_path / "spans.json")
    profiler.set_config(filename=fname)
    profiler.start()
    with telemetry.span("test.outer", shard=1) as outer:
        with telemetry.span("test.inner"):
            (mt.nd.ones((2,)) + 1).wait_to_read()
    profiler.stop()
    profiler.dump()
    events = json.load(open(fname))["traceEvents"]
    by = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert by["test.outer"]["args"]["trace_id"] == outer.trace_id
    assert by["test.inner"]["args"]["trace_id"] == outer.trace_id
    assert by["test.inner"]["args"]["parent_id"] == outer.span_id
    assert by["test.outer"]["args"]["shard"] == 1


def test_profile_all_session_exports_a_torch_trace():
    """``profile_all`` runs a torch.profiler session from start() to stop()
    and exports it as a chrome trace; op dispatch and scopes are its
    record_function ranges."""
    profiler.set_config(profile_all=True)
    profiler.start()
    with profiler.scope("unit.session_scope"):
        mt.nd.dot(mt.nd.ones((8, 8)), mt.nd.ones((8, 8))).wait_to_read()
    profiler.stop()
    path = profiler.torch_trace_path()
    assert path and os.path.isfile(path)
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "unit.session_scope" in names and "dot" in names
    assert profiler._STATE["torch_session"] is None
