"""The port's flight recorder, reporter and span spool (mxnet_tpu_torch.
telemetry) on the CPU, held against the JAX package's readers: the bounded
rings, bundle dumps (directory gating, per-kind rate limit, rotation,
atomic writes), the crash hooks, the reference's ``load_bundle`` and
``tools/flight_inspect.py`` on a port bundle (with the reference bundle's
keys), the ``oom`` bundle an out-of-memory error writes through the port's
RetryPolicy, the reporter's final tick, the shared quantile estimator and
the reference's ``read_spool``/``journey`` on the port's spool files.

Knobs are set through ``monkeypatch`` (the port reads the environment at
every use); hooks and reporters are undone in a ``finally``."""
import io
import json
import os
import sys
import threading
from contextlib import redirect_stdout

import numpy as onp
import pytest
import torch

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.telemetry import flight as jflight
from mxnet_tpu.telemetry import tracing as jtracing

from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.resilience import faults
from mxnet_tpu_torch.resilience.retry import RetryPolicy
from mxnet_tpu_torch.telemetry import flight, memstats, tracing
from mxnet_tpu_torch.telemetry.metrics import REGISTRY

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _import_tool(name):
    sys.path.insert(0, TOOLS)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _counter_value(name, **labels):
    fam = REGISTRY.snapshot()["metrics"].get(name, {})
    for s in fam.get("series", []):
        if s.get("labels", {}) == labels:
            return s.get("value", 0.0)
    return 0.0


def _recorder(d="", **kw):
    return flight.FlightRecorder(span_capacity=8, event_capacity=8,
                                 request_capacity=8, directory=d, **kw)


# ---------------------------------------------------------------------------
# rings (tests/test_flight.py:82-130)
# ---------------------------------------------------------------------------
def test_rings_are_bounded_and_ordered():
    rec = flight.FlightRecorder(span_capacity=4, event_capacity=4,
                                request_capacity=4, directory="")
    for i in range(10):
        rec.record_event("unit_kind", {"i": i})
    evs = rec.recent_events()
    assert len(evs) == 4
    assert [e["attrs"]["i"] for e in evs] == [6, 7, 8, 9]
    for i in range(10):
        rec.record_request(f"trace{i}", "ep", 100.0 + i, rows=1)
    reqs = rec.recent_requests()
    assert len(reqs) == 4
    assert reqs[-1]["trace_id"] == "trace9" and reqs[-1]["ok"] is True


def test_spans_feed_flight_ring_with_trace_ids():
    flight.RECORDER.clear()
    with telemetry.span("flightring.outer"):
        with telemetry.span("flightring.inner"):
            pass
    spans = {s["name"]: s for s in flight.recent_spans()}
    assert "flightring.outer" in spans and "flightring.inner" in spans
    assert spans["flightring.inner"]["trace_id"] == \
        spans["flightring.outer"]["trace_id"]
    assert spans["flightring.inner"]["parent_id"] == \
        spans["flightring.outer"]["span_id"]
    assert spans["flightring.outer"]["dur_us"] is not None


def test_event_attrs_always_json_serializable():
    rec = _recorder()
    entry = rec.record_event("unit_kind", {"obj": object(), "n": 3})
    json.dumps(entry)
    assert entry["attrs"]["n"] == 3
    assert "object" in entry["attrs"]["obj"]


def test_public_event_api_reaches_process_recorder():
    before = _counter_value("mxtpu_flight_events_total", kind="unit_marker")
    telemetry.event("unit_marker", detail=1)
    last = flight.recent_events()[-1]
    assert last["kind"] == "unit_marker" and last["attrs"]["detail"] == 1
    assert _counter_value("mxtpu_flight_events_total",
                          kind="unit_marker") == before + 1


# ---------------------------------------------------------------------------
# bundles (tests/test_flight.py:132-220)
# ---------------------------------------------------------------------------
def test_dump_writes_complete_bundle(tmp_path):
    rec = _recorder(str(tmp_path), keep=8, min_interval_s=0.0)
    rec.record_event("boom", {"why": "unit"})
    rec.record_request("tid1", "ep1", 123.0, rows=2)
    path = rec.dump(trigger="unit_dump", attrs={"a": 1})
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("flight-")
    b = jflight.load_bundle(path)            # the reference's reader
    assert b["schema"] == 2
    assert b["trigger"] == {"kind": "unit_dump", "attrs": {"a": 1}}
    assert "compile_records" in b and "memstats" in b
    assert b["events"][-1]["kind"] == "boom"
    assert b["requests"][-1]["trace_id"] == "tid1"
    assert b["fingerprint"]["pid"] == os.getpid()
    assert "MXNET_FLIGHT_DIR" in b["config"]
    assert b["metrics"]["metrics"]
    assert any("MainThread" in k for k in b["threads"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_bundle_has_the_reference_bundle_keys(tmp_path):
    """A port bundle and a reference bundle carry the same sections, with
    the same keys in each section that is a record."""
    port = flight.load_bundle(_recorder(str(tmp_path / "p")).dump(
        trigger="keys"))
    ref = jflight.load_bundle(jflight.FlightRecorder(
        span_capacity=8, event_capacity=8, request_capacity=8,
        directory=str(tmp_path / "r")).dump(trigger="keys"))
    assert set(port) == set(ref)
    for sec in ("trigger", "compile_records", "fingerprint", "metrics"):
        assert set(port[sec]) == set(ref[sec]), sec
    assert set(port["memstats"]) == set(ref["memstats"]) or \
        not ref["memstats"]


def test_trigger_records_always_dumps_only_with_directory(tmp_path):
    rec = _recorder()
    assert rec.trigger("watchdog_stall", watch="w") is None
    assert rec.recent_events()[-1]["kind"] == "watchdog_stall"

    rec2 = _recorder(str(tmp_path), keep=8, min_interval_s=60.0)
    before = _counter_value("mxtpu_flight_dumps_suppressed_total")
    p1 = rec2.trigger("circuit_open", scope="s")
    assert p1 and os.path.exists(p1)
    assert rec2.trigger("circuit_open", scope="s") is None
    assert rec2.recent_events()[-1]["kind"] == "circuit_open"
    assert _counter_value("mxtpu_flight_dumps_suppressed_total") == \
        before + 1
    assert rec2.trigger("failover", reason="r")
    rec2.reset_rate_limit()
    assert rec2.trigger("circuit_open", scope="s")


def test_trigger_respects_live_config_directory(tmp_path, monkeypatch):
    flight.RECORDER.reset_rate_limit()
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path))
    p = flight.trigger("unit_cfg_dir", note="x")
    assert p and p.startswith(str(tmp_path))
    monkeypatch.setenv("MXNET_FLIGHT_DIR", "")
    assert flight.trigger("unit_cfg_dir_off") is None


def test_trigger_never_raises_on_a_broken_directory(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    rec = _recorder(str(blocker / "sub"), min_interval_s=0.0)
    assert rec.trigger("unit_broken_disk") is None
    assert rec.recent_events()[-1]["kind"] == "unit_broken_disk"


def test_rotation_keeps_newest(tmp_path):
    rec = _recorder(str(tmp_path), keep=3, min_interval_s=0.0)
    paths = [rec.dump(trigger=f"t{i}") for i in range(6)]
    left = flight.list_bundles(str(tmp_path))
    assert len(left) == 3
    assert left == sorted(paths[-3:])
    assert jflight.list_bundles(str(tmp_path)) == left


def test_unhandled_thread_exception_dumps_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path))
    flight.RECORDER.reset_rate_limit()
    flight.install_excepthooks()
    flight.install_excepthooks()  # idempotent
    try:
        def boom():
            raise ValueError("synthetic crash for the flight recorder")
        t = threading.Thread(target=boom, name="flight-crash-test")
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        flight.uninstall_excepthooks()
    bundles = flight.list_bundles(str(tmp_path))
    assert bundles, "thread crash must leave a bundle"
    b = jflight.load_bundle(bundles[-1])
    assert b["trigger"]["kind"] == "unhandled_exception"
    assert b["trigger"]["attrs"]["error"] == "ValueError"
    assert b["trigger"]["attrs"]["thread"] == "flight-crash-test"


def test_flight_inspect_renders_port_bundle(tmp_path):
    flight_inspect = _import_tool("flight_inspect")
    flight.RECORDER.clear()
    with telemetry.span("inspect.step", examples=4):
        pass
    telemetry.event("failover", reason="unit")
    flight.record_request("tidx", "epx", 1234.0, rows=2)
    path = flight.RECORDER.dump(
        path=str(tmp_path / "flight-unit-0000-failover.json"),
        trigger="failover", attrs={"reason": "unit"})
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flight_inspect.main([str(tmp_path)]) == 0
    out = buf.getvalue()
    assert "trigger: failover" in out
    assert "inspect.step" in out and "trace " in out
    assert "== completed requests" in out and "tidx" in out
    assert "metrics snapshot" in out
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert flight_inspect.main([path, "--json"]) == 0
    assert json.loads(buf.getvalue())["trigger"]["kind"] == "failover"


# ---------------------------------------------------------------------------
# the oom bundle through the port's RetryPolicy (tests/test_perf_obs.py:325)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["torch_oom", "injected"])
def test_oom_fires_flight_bundle_with_holder_breakdown(tmp_path,
                                                       monkeypatch, how):
    """An out-of-memory error raised through the port's RetryPolicy (a
    ``torch.OutOfMemoryError``, or the ``device_oom`` fault) writes one
    ``oom`` bundle whose memstats section holds the ranked holders, read by
    the reference's load_bundle and flight_inspect."""
    memstats.reset()

    class Owner:
        pass
    o = Owner()
    memstats.register("serving", "big.params", nbytes=4 << 20, owner=o,
                      device="gpu:0")
    memstats.register("numerics", "snapshots", nbytes=1 << 20, owner=o)
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path))
    flight.RECORDER.reset_rate_limit()
    try:
        pol = RetryPolicy(max_attempts=2, base_ms=0.01, sleep=lambda s: None)
        if how == "torch_oom":
            def fn():
                raise torch.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB")
            with pytest.raises(torch.OutOfMemoryError):
                pol.run(fn, site="train_step")
        else:
            with faults.inject("device_oom", site="train_step", every_n=1):
                with pytest.raises(Exception):
                    pol.run(lambda: faults.check("train_step"),
                            site="train_step")
        bundles = flight.list_bundles(str(tmp_path))
        # both attempts hit the oom; the per-kind rate limit keeps one
        assert len(bundles) == 1
        b = jflight.load_bundle(bundles[-1])
        assert b["trigger"]["kind"] == "oom"
        assert b["trigger"]["attrs"]["site"] == "train_step"
        holders = [h["holder"] for h in b["memstats"]["holders"]]
        assert holders[:2] == ["big.params", "snapshots"]
        text = _import_tool("flight_inspect").render(b, path=bundles[-1])
        assert "== memstats" in text and "big.params" in text
        assert "4.0MiB" in text
    finally:
        memstats.reset()


# ---------------------------------------------------------------------------
# reporter and the shared estimator (tests/test_flight.py:496, :510)
# ---------------------------------------------------------------------------
def test_reporter_final_tick_once_and_stop_idempotent(tmp_path):
    path = str(tmp_path / "final.json")
    rep = telemetry.periodic_logger(9999.0, path=path)
    try:
        rep.stop()
        assert os.path.exists(path), "stop() must flush one final snapshot"
        first = open(path).read()
        json.loads(first)
        rep.stop()
        assert open(path).read() == first
    finally:
        rep.stop()
    assert not rep._thread.is_alive()


def test_periodic_logger_writes_snapshot(tmp_path):
    path = str(tmp_path / "telemetry.json")
    rep = telemetry.periodic_logger(0.05, path=path)
    try:
        import time
        deadline = time.time() + 10
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        rep.stop()
    snap = json.load(open(path))
    assert "mxtpu_span_duration_us" in snap["metrics"]
    assert not rep._thread.is_alive()


def test_latency_histogram_uses_shared_quantile_impl():
    from mxnet_tpu_torch.serving.stats import _BOUNDS, LatencyHistogram
    from mxnet_tpu_torch.telemetry.metrics import _quantile_from_buckets
    h = LatencyHistogram()
    rng = onp.random.RandomState(0)
    for v in rng.lognormal(mean=6.0, sigma=1.0, size=500):
        h.record(float(v))
    for p in (50, 90, 95, 99, 99.9):
        assert h.percentile(p) == _quantile_from_buckets(
            _BOUNDS, h.counts, h.n, p, h.max_us)
    assert h.percentile(50) <= h.percentile(95) <= h.percentile(99) <= \
        h.max_us
    assert LatencyHistogram().percentile(50) == 0.0


# ---------------------------------------------------------------------------
# the span spool, read by the reference
# ---------------------------------------------------------------------------
def test_reference_reads_port_spool(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_SPAN_SPOOL_DIR", str(tmp_path))
    tracing._reset_spool_for_tests()
    try:
        with telemetry.span("spool.root", job="j") as root:
            with telemetry.span("spool.child"):
                pass
        telemetry.spool_flush()
        lines = jtracing.read_spool(str(tmp_path))
        hops = jtelemetry.journey(root.trace_id, str(tmp_path))
        assert [h["name"] for h in hops] == ["spool.root", "spool.child"]
        assert all(h["pid"] == os.getpid() for h in hops)
        assert hops[0]["attrs"] == {"job": "j"}
        assert hops == telemetry.journey(root.trace_id, str(tmp_path))
        assert len(lines) >= 2
    finally:
        tracing._reset_spool_for_tests()


def test_trace_id_inherited_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_ID", "00000000deadbeef")
    tracing._reset_spool_for_tests()
    try:
        with telemetry.span("inherit.root") as s:
            pass
        assert s.trace_id == "00000000deadbeef"
    finally:
        monkeypatch.delenv("MXNET_TRACE_ID")
        tracing._reset_spool_for_tests()
