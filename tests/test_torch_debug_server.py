"""The port's debug server (``mxnet_tpu_torch.telemetry.debug_server``) held
against the cases of ``tests/test_flight.py:253-386`` and
``tests/test_fleet.py:337-420`` on the CPU: every page answers, the scrape
counter counts each page, ``/flightz?dump=1`` writes a bundle the
reference's ``load_bundle`` and ``tools/flight_inspect.py`` read,
``/healthz`` follows an attached server's state, pooled pages name every
replica, ``/fleetz`` is JSON carrying goodput, and concurrent scrapes do
not perturb serving (bitwise). ``/compilez`` and ``/costz`` answer 501 and
name ROADMAP Q1.12c, and the port's page list is the reference's less
those two.

Every fetch goes through an opener with no proxy and a timeout, to a
server on 127.0.0.1 with an ephemeral port. Each test stops its server and
detaches what it attached in a ``finally``; the attachments other files'
tests left in the worker are set aside and restored."""
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as onp
import pytest
import torch

from mxnet_tpu.telemetry import debug_server as jdbg
from mxnet_tpu.telemetry import flight as jflight

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.telemetry import debug_server as dbg
from mxnet_tpu_torch.telemetry import flight, goodput
from mxnet_tpu_torch.telemetry.metrics import REGISTRY

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
FETCH_TIMEOUT = 30
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))
SCRAPED = ("/metricsz", "/metricsz?json=1", "/statusz", "/tracez", "/memz",
           "/fleetz")


def _get(url, timeout=FETCH_TIMEOUT):
    """(status, body) of one GET, 4xx/5xx included; never via a proxy."""
    try:
        with _OPENER.open(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _counter(name, **labels):
    fam = REGISTRY.snapshot()["metrics"].get(name, {})
    for s in fam.get("series", []):
        if s.get("labels", {}) == labels:
            return s.get("value", 0.0)
    return 0.0


@pytest.fixture
def attachments():
    """Set aside what other tests left attached; restore it afterwards
    and drop whatever the test attached."""
    prior = (dbg.attached_servers(), dbg.attached_pools(),
             dbg.attached_autoscalers())
    for s in prior[0]:
        dbg.detach(s)
    for p in prior[1]:
        dbg.detach_pool(p)
    for a in prior[2]:
        dbg.detach_autoscaler(a)
    try:
        yield
    finally:
        for s in dbg.attached_servers():
            dbg.detach(s)
        for p in dbg.attached_pools():
            dbg.detach_pool(p)
        for a in dbg.attached_autoscalers():
            dbg.detach_autoscaler(a)
        for s in prior[0]:
            dbg.attach(s)
        for p in prior[1]:
            dbg.attach_pool(p)
        for a in prior[2]:
            dbg.attach_autoscaler(a)


def _mlp(seed):
    mt.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=6),
            nn.Dense(4, in_units=16))
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    return net


def _pages(index_text):
    (line,) = [ln for ln in index_text.splitlines()
               if ln.startswith("pages:")]
    return set(line.split()[1:])


# ---------------------------------------------------------------------------
# pages
# ---------------------------------------------------------------------------
def test_debug_server_serves_all_pages(attachments):
    telemetry.event("unit_page_probe")
    before = {p: _counter("mxtpu_debug_requests_total", page=p)
              for p in ("index", "metricsz", "healthz", "statusz", "tracez",
                        "flightz", "memz", "fleetz")}
    srv = dbg.DebugServer(port=0).start()
    try:
        assert srv.host == "127.0.0.1" and srv.port > 0
        st, body = _get(srv.url + "/")
        assert st == 200 and "/metricsz" in body
        st, body = _get(srv.url + "/metricsz")
        assert st == 200 and "mxtpu_flight_events_total" in body
        st, body = _get(srv.url + "/healthz")
        assert st == 200 and json.loads(body)["ok"] is True
        st, body = _get(srv.url + "/statusz")
        assert st == 200 and "== flight recorder ==" in body
        st, body = _get(srv.url + "/tracez")
        assert st == 200 and body.startswith("tracez:")
        st, body = _get(srv.url + "/flightz")
        assert st == 200 and "recent_events" in json.loads(body)
        st, body = _get(srv.url + "/memz")
        assert st == 200 and "== holders" in body
        st, body = _get(srv.url + "/fleetz")
        assert st == 200 and "goodput" in json.loads(body)
        st, body = _get(srv.url + "/nope")
        assert st == 404 and "/metricsz" in body
    finally:
        srv.stop()
    after = {p: _counter("mxtpu_debug_requests_total", page=p)
             for p in before}
    assert all(after[p] - before[p] == 1 for p in before), (before, after)


@pytest.mark.parametrize("page", ["/compilez", "/costz"])
def test_compile_ledger_pages_answer_501_naming_q1_12c(page):
    before = _counter("mxtpu_debug_requests_total", page=page[1:])
    srv = dbg.DebugServer(port=0).start()
    try:
        st, body = _get(srv.url + page)
    finally:
        srv.stop()
    assert st == 501
    assert body.startswith(f"{page}: ") and "Q1.12c" in body
    assert _counter("mxtpu_debug_requests_total", page=page[1:]) == before


def test_page_list_is_the_references_less_the_compile_ledger_pages():
    ref = jdbg.DebugServer(port=0).start()
    port = dbg.DebugServer(port=0).start()
    try:
        st_r, ref_index = _get(ref.url + "/")
        st_p, port_index = _get(port.url + "/")
        st_404, not_found = _get(port.url + "/missing")
    finally:
        ref.stop()
        port.stop()
    assert st_r == st_p == 200 and st_404 == 404
    want = _pages(ref_index) - {"/compilez", "/costz"}
    assert _pages(port_index) == want == set(dbg.PAGES)
    assert _pages(not_found) == want
    for page in ("/compilez", "/costz"):
        assert f"{page}: 501" in port_index and "Q1.12c" in port_index


def test_metricsz_json_is_the_dump_shape(tmp_path):
    srv = dbg.DebugServer(port=0).start()
    try:
        st, body = _get(srv.url + "/metricsz?json=1")
    finally:
        srv.stop()
    assert st == 200
    scraped = json.loads(body)
    dumped = tmp_path / "d.json"
    telemetry.dump(str(dumped))
    on_disk = json.loads(dumped.read_text())
    assert set(scraped) == set(on_disk)
    assert set(scraped["metrics"]) <= set(on_disk["metrics"])
    assert "mxtpu_debug_requests_total" in scraped["metrics"]


def test_flightz_dump_writes_a_bundle_the_references_read(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_DIR", str(tmp_path))
    flight.RECORDER.reset_rate_limit()
    srv = dbg.DebugServer(port=0).start()
    try:
        st, body = _get(srv.url + "/flightz?dump=1")
    finally:
        srv.stop()
    body = json.loads(body)
    assert st == 200 and body["dumped"] and body["bundles"]
    (bundle,) = flight.list_bundles(str(tmp_path))
    assert jflight.load_bundle(bundle)["trigger"]["kind"] == "flightz"
    proc = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "flight_inspect.py"),
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "flightz" in proc.stdout


class _FakeServer:
    def __init__(self):
        self.h = {"state": "running", "circuit": "healthy", "endpoints": {}}

    def health(self):
        return self.h


def test_healthz_reflects_attached_server_state(attachments):
    fake = _FakeServer()
    dbg.attach(fake)
    assert dbg.healthz()[0] == 200
    fake.h["circuit"] = "open"
    st, body = dbg.healthz()
    assert st == 503 and body["ok"] is False
    fake.h = {"state": "stopped", "circuit": "healthy", "endpoints": {}}
    assert dbg.healthz()[0] == 503
    assert fleet_status() == "down"
    dbg.detach(fake)
    assert dbg.healthz()[0] == 200


def fleet_status():
    from mxnet_tpu_torch.telemetry import fleet
    status = fleet.health_rollup()["status"]
    assert REGISTRY.get("mxtpu_fleet_health").value == \
        {"ok": 0, "degraded": 1, "down": 2}[status]
    return status


def test_healthz_follows_a_real_server_through_stop(attachments):
    """start() attaches; stop() leaves it attached, as in the reference,
    so /healthz answers 503 with state stopped until it is detached."""
    name = "dbg_health_ep"
    srv = serving.InferenceServer(batch_timeout_ms=1.0)
    srv.register(serving.ModelEndpoint(name, _mlp(3), input_shapes=(6,),
                                       max_batch_size=4, ctx=mt.cpu()))
    web = dbg.DebugServer(port=0).start()
    try:
        srv.start()
        assert srv in dbg.attached_servers()
        st, body = _get(web.url + "/healthz")
        assert st == 200 and json.loads(body)["servers"][0]["state"] == \
            "running"
        assert json.loads(body)["servers"][0]["endpoints"] == [name]
        assert fleet_status() == "ok"
        srv.stop()
        st, body = _get(web.url + "/healthz")
        assert st == 503
        assert json.loads(body)["servers"][0]["state"] == "stopped"
        assert fleet_status() == "down"
        dbg.detach(srv)
        st, body = _get(web.url + "/healthz")
        assert st == 200 and json.loads(body)["servers"] == []
    finally:
        web.stop()
        srv.stop()
        serving.unregister(name)


# ---------------------------------------------------------------------------
# concurrent scrapes during live serving: bitwise outputs, every scrape 200
# ---------------------------------------------------------------------------
def test_concurrent_scrapes_do_not_perturb_serving(attachments):
    name = "dbg_scrape_ep"
    net = _mlp(11)
    # one request fills a bucket, so each response is one forward of its
    # own rows, the direct forward's shape
    srv = serving.InferenceServer(batch_timeout_ms=2.0, max_queue=256)
    srv.register(serving.ModelEndpoint(name, net, input_shapes=(6,),
                                       max_batch_size=4, ctx=mt.cpu()),
                 slo_ms=60_000.0)
    srv.start()
    web = dbg.DebugServer(port=0).start()
    stop = threading.Event()
    statuses, errors = [], []
    made = {p: 0 for p in SCRAPED}
    before = {p: _counter("mxtpu_debug_requests_total",
                          page=p.split("?")[0][1:]) for p in SCRAPED}

    def scraper(page):
        while not stop.is_set():
            try:
                st, _ = _get(web.url + page)
                statuses.append(st)
                made[page] += 1
            except Exception as e:    # recorded, asserted below
                errors.append(repr(e))
                return

    scrapers = [threading.Thread(target=scraper, args=(p,), daemon=True)
                for p in SCRAPED]
    for t in scrapers:
        t.start()
    rng = onp.random.default_rng(12)
    xs = [rng.standard_normal((4, 6)).astype("float32") for _ in range(24)]
    results = [None] * len(xs)
    try:
        def client(i):
            results[i] = srv.predict(name, xs[i], timeout=60)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(xs))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(120)
    finally:
        stop.set()
        for t in scrapers:
            t.join(30)
        web.stop()
        srv.stop()
        serving.unregister(name)
        from mxnet_tpu_torch.telemetry.slo import MONITOR
        MONITOR.unregister(name)
    assert not errors, errors
    assert statuses and all(s == 200 for s in statuses)
    after = {p: _counter("mxtpu_debug_requests_total",
                         page=p.split("?")[0][1:]) for p in SCRAPED}
    assert after["/metricsz"] - before["/metricsz"] == \
        made["/metricsz"] + made["/metricsz?json=1"]
    for p in SCRAPED[2:]:
        assert after[p] - before[p] == made[p], p
    with torch.inference_mode():
        for i, x in enumerate(xs):
            assert torch.equal(net(torch.from_numpy(x)), results[i]), i


# ---------------------------------------------------------------------------
# pooled pages and the fleet pane
# ---------------------------------------------------------------------------
class _StubMonitor:
    burn_threshold = 14.0

    def __init__(self):
        self.fast_burn = 0.0
        self.alert = False

    def check_all(self):
        return [{"endpoint": "e", "fast_burn": self.fast_burn,
                 "slow_burn": self.fast_burn, "alert_active": self.alert}]


def test_pooled_statusz_names_every_replica(attachments):
    name = "dbg_statusz_ep"

    def factory(rid):
        srv = serving.InferenceServer(batch_timeout_ms=1.0, max_queue=64)
        srv.register(serving.ModelEndpoint(name, _mlp(11), input_shapes=(6,),
                                           max_batch_size=4, ctx=mt.cpu()))
        return srv

    pool = serving.ServingPool(factory, initial_replicas=3)
    mon = _StubMonitor()
    asc = serving.Autoscaler(pool, monitor=mon, min_replicas=1,
                             max_replicas=3, up_n=2, down_n=3,
                             cooldown_s=5.0, queue_high=0.9, queue_low=0.5)
    try:
        assert pool in dbg.attached_pools()
        assert asc in dbg.attached_autoscalers()
        page = dbg.statusz()
        assert "== serving pool ==" in page
        assert "pool: replicas=3" in page
        for rid in (0, 1, 2):
            assert f"replica {rid}: state=running" in page
        assert "autoscaler: replicas [1..3]" in page
        assert "over_polls=0/2" in page and "idle_polls=0/3" in page
        assert "cooldown=no" in page and "cooldown_s=5.0" in page
        code, body = dbg.healthz()
        assert code == 200 and body["ok"]
        assert any(p.get("replicas") == 3
                   and sorted(p.get("rotation", [])) == [0, 1, 2]
                   for p in body.get("pools", []))
        roll = telemetry.fleet.health_rollup()
        assert roll["status"] == "ok"
        assert roll["replicas"] == {"rotation": 3, "draining": 0}
        mon.alert = True
        asc.tick(now=0.0)
        assert asc.tick(now=1.0) is None and pool.size() == 3   # at max
    finally:
        pool.stop(drain=True)
        serving.unregister(name)


def test_fleetz_page_is_json_and_carries_goodput(attachments):
    doc = dbg.fleetz()
    json.dumps(doc)
    assert doc["processes"] >= 1
    assert "merged" in doc and "health" in doc
    assert set(doc["goodput"]["buckets"]) == set(goodput.BUCKETS)
    assert doc["goodput"]["wall_s"] > 0
    assert doc["health"]["status"] == "ok"
    assert doc["utilization"] == []


# ---------------------------------------------------------------------------
# the environment-driven start
# ---------------------------------------------------------------------------
def test_autostart_is_off_by_default_and_best_effort(monkeypatch):
    monkeypatch.delenv("MXNET_DEBUG_PORT", raising=False)
    assert dbg._autostart() is None
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    try:
        monkeypatch.setenv("MXNET_DEBUG_PORT", str(taken.getsockname()[1]))
        assert dbg._autostart() is None       # port taken: stays off
    finally:
        taken.close()
    free = socket.socket()
    free.bind(("127.0.0.1", 0))
    port = free.getsockname()[1]
    free.close()
    monkeypatch.setenv("MXNET_DEBUG_PORT", str(port))
    web = dbg._autostart()
    try:
        assert web is not None and web.port == port
        assert _get(web.url + "/healthz")[0] in (200, 503)
    finally:
        if web is not None:
            web.stop()
