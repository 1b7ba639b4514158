"""Live HTTP introspection for a running process (stdlib-only; the port
of ``mxnet_tpu/telemetry/debug_server.py``).

Off by default; ``MXNET_DEBUG_PORT`` (or an explicit ``DebugServer(port)``)
starts a ``ThreadingHTTPServer`` on localhost serving the -z pages:

  /metricsz   Prometheus text exposition (``telemetry.prometheus_text()``)
  /healthz    JSON liveness: 200 when every attached InferenceServer is
              running and no circuit is OPEN, else 503 — a load balancer
              can point straight at it
  /statusz    human summary: per-endpoint latency quantiles from the
              histogram buckets, batch occupancy, prep/step overlap, queue
              depths, SLO burn rates, checkpoint staleness, flight state
  /tracez     recent finished spans grouped by trace id (flight span ring)
  /flightz    flight bundle listing; ``/flightz?dump=1`` triggers a manual
              bundle right now
  /memz       device-memory attribution: ``torch.cuda.memory_stats``
              (read on the scrape) reconciled against the holder table
  /fleetz     fleet plane (JSON): merged per-replica metrics (local registry
              + MXNET_FLEET_DUMP_GLOB snapshot files), worst-of health
              rollup across attached servers/pools/autoscalers, and the
              goodput wall-time attribution

``/metricsz?json=1`` serves the registry snapshot as JSON — the same shape
``telemetry.dump()`` writes — so a FleetCollector in another process can
scrape this one instead of reading its dump file.

``/compilez`` and ``/costz`` answer 501: the compile ledger and the cost
model they render wait for ROADMAP Q1.12c.

The handler only ever *reads* — registry snapshots, ring copies, ``health()``
dicts, the caching allocator's counters — so scraping cannot perturb
serving beyond a snapshot's cost, and concurrent scrapes are safe by
construction (each request gets its own handler thread; shared state is
behind the registry/ring locks). No page waits for the card.
"""
from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from .metrics import REGISTRY
from . import flight as _flight

__all__ = ["DebugServer", "attach", "detach", "attached_servers",
           "attach_pool", "detach_pool", "attached_pools",
           "attach_autoscaler", "detach_autoscaler", "attached_autoscalers"]

_SCRAPES = REGISTRY.counter(
    "mxtpu_debug_requests_total",
    "Debug-server HTTP requests served, by page.",
    labelnames=("page",))

# InferenceServers that want to appear on /healthz + /statusz register here
# (weakly: a dead server drops off the page instead of pinning memory).
_ATTACHED: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()
# ServingPools and Autoscalers get their own weak registries: a pooled
# deployment's replica membership and scaling state render on the same
# pages, and drop off when the pool is garbage-collected.
_ATTACHED_POOLS: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()
_ATTACHED_AUTOSCALERS: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()
_ATTACH_LOCK = threading.Lock()


#: the pages this server answers (``/compilez`` and ``/costz`` with 501)
PAGES = ("/metricsz[?json=1]", "/healthz", "/statusz", "/tracez",
         "/flightz[?dump=1]", "/memz", "/fleetz")
#: reference pages whose modules the port does not have yet
NOT_PORTED = {"/compilez": "the compile ledger", "/costz": "the cost model"}
_PAGE_LIST = ("pages: " + " ".join(PAGES) + "\n"
              + "".join(f"{p}: 501, {what} waits for ROADMAP Q1.12c\n"
                        for p, what in NOT_PORTED.items()))


def _cfg(name, default):
    """Knob read tolerating the partially initialized package."""
    try:
        from .. import config
    except ImportError:
        return default
    return config.get(name)


def attach(server):
    """Expose an InferenceServer on /healthz and /statusz (idempotent)."""
    with _ATTACH_LOCK:
        _ATTACHED[id(server)] = server


def detach(server):
    with _ATTACH_LOCK:
        _ATTACHED.pop(id(server), None)


def attached_servers() -> List[object]:
    with _ATTACH_LOCK:
        return list(_ATTACHED.values())


def attach_pool(pool):
    """Expose a ServingPool (replica membership, per-replica load) on
    /healthz, /statusz and /fleetz (idempotent, weak)."""
    with _ATTACH_LOCK:
        _ATTACHED_POOLS[id(pool)] = pool


def detach_pool(pool):
    with _ATTACH_LOCK:
        _ATTACHED_POOLS.pop(id(pool), None)


def attached_pools() -> List[object]:
    with _ATTACH_LOCK:
        return list(_ATTACHED_POOLS.values())


def attach_autoscaler(asc):
    """Expose an Autoscaler (cooldown, hysteresis poll counts, action
    history) on /statusz and /fleetz (idempotent, weak)."""
    with _ATTACH_LOCK:
        _ATTACHED_AUTOSCALERS[id(asc)] = asc


def detach_autoscaler(asc):
    with _ATTACH_LOCK:
        _ATTACHED_AUTOSCALERS.pop(id(asc), None)


def attached_autoscalers() -> List[object]:
    with _ATTACH_LOCK:
        return list(_ATTACHED_AUTOSCALERS.values())


# -- page renderers (module functions so tests can call them directly) --------

def healthz() -> "tuple[int, Dict]":
    """(http_status, body): 200 iff every attached server is running with no
    OPEN circuit. A process with nothing attached is alive by definition."""
    servers = attached_servers()
    body: Dict = {"ok": True, "servers": []}
    for srv in servers:
        try:
            h = srv.health()
        except Exception as e:
            body["servers"].append({"error": repr(e)})
            body["ok"] = False
            continue
        entry = {"state": h.get("state"), "circuit": h.get("circuit"),
                 "endpoints": sorted(h.get("endpoints", {}))}
        body["servers"].append(entry)
        if h.get("state") != "running" or h.get("circuit") == "open":
            body["ok"] = False
    pools = attached_pools()
    if pools:
        body["pools"] = []
        for pool in pools:
            try:
                ps = pool.snapshot()
            except Exception as e:
                body["pools"].append({"error": repr(e)})
                body["ok"] = False
                continue
            body["pools"].append({
                "replicas": ps.get("size", 0),
                "rotation": [r.get("rid") for r in ps.get("replicas", [])],
                "queue_pressure": ps.get("queue_pressure")})
            if not ps.get("size"):
                body["ok"] = False
    return (200 if body["ok"] else 503), body


def _fmt_us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.0f}us"


def _gauge_series(snap: Dict, name: str):
    fam = snap["metrics"].get(name)
    if not fam:
        return []
    return [(s.get("labels", {}), s.get("value", 0.0))
            for s in fam["series"]]


def statusz() -> str:
    """The one-page human summary an on-call engineer reads first."""
    from .reporter import sample_device_memory
    sample_device_memory()
    snap = REGISTRY.snapshot()
    lines = [f"mxnet_tpu_torch statusz  ts={time.strftime('%Y-%m-%d %H:%M:%S')}"]

    lines.append("")
    lines.append("== serving ==")
    servers = attached_servers()
    if not servers:
        lines.append("(no InferenceServer attached)")
    for srv in servers:
        try:
            h = srv.health()
        except Exception as e:
            lines.append(f"server: health() failed: {e!r}")
            continue
        lines.append(
            f"server: state={h.get('state')} circuit={h.get('circuit')} "
            f"worker_epoch={h.get('worker_epoch')} "
            f"failovers={h.get('failovers')} "
            f"watchdog_stalls={h.get('watchdog_stalls')} "
            f"prep_overlap_ratio={h.get('prep_overlap_ratio', 0):.2f}")
        for name, ep in sorted(h.get("endpoints", {}).items()):
            lines.append(
                f"  endpoint {name}: circuit={ep.get('circuit')} "
                f"pending={ep.get('pending_requests')} "
                f"rows={ep.get('pending_rows')} "
                f"slo_ms={ep.get('slo_ms')} "
                f"weights_epoch={ep.get('weights_epoch')}")

    pools = attached_pools()
    autoscalers = attached_autoscalers()
    if pools or autoscalers:
        lines.append("")
        lines.append("== serving pool ==")
        for pool in pools:
            try:
                ps = pool.snapshot()
            except Exception as e:
                lines.append(f"pool: snapshot() failed: {e!r}")
                continue
            lines.append(f"pool: replicas={ps.get('size', 0)} "
                         f"queue_pressure={ps.get('queue_pressure', 0):.3f}")
            for r in ps.get("replicas", []):
                lines.append(f"  replica {r.get('rid')}: "
                             f"state={r.get('state')} load={r.get('load')}")
        for asc in autoscalers:
            try:
                asnap = asc.snapshot()
            except Exception as e:
                lines.append(f"autoscaler: snapshot() failed: {e!r}")
                continue
            lines.append(
                f"autoscaler: replicas "
                f"[{asnap.get('min_replicas')}..{asnap.get('max_replicas')}] "
                f"over_polls={asnap.get('over_polls')}/{asnap.get('up_n')} "
                f"idle_polls={asnap.get('idle_polls')}/{asnap.get('down_n')} "
                f"cooldown={'yes' if asnap.get('in_cooldown') else 'no'} "
                f"(cooldown_s={asnap.get('cooldown_s')} "
                f"last_action_age_s={asnap.get('last_action_age_s')})")
            for act in asnap.get("actions", [])[-5:]:
                lines.append(f"  action: {act.get('action')} "
                             f"rid={act.get('rid')} -> "
                             f"replicas={act.get('replicas')}")

    lat = snap["metrics"].get("mxtpu_serving_request_latency_us")
    if lat and any(s.get("count") for s in lat["series"]):
        lines.append("")
        lines.append("== request latency (from histogram buckets) ==")
        for s in lat["series"]:
            if not s.get("count"):
                continue
            ep = s.get("labels", {}).get("endpoint", "?")
            lines.append(
                f"  {ep}: n={s['count']} p50={_fmt_us(s['p50'])} "
                f"p95={_fmt_us(s['p95'])} p99={_fmt_us(s['p99'])} "
                f"mean={_fmt_us(s['mean'])} max={_fmt_us(s['max'])}")

    rows = []
    for labels, v in _gauge_series(snap, "mxtpu_serving_queue_depth"):
        rows.append(f"  queue_depth{{{labels.get('endpoint', '?')}}}={v:g}")
    for labels, v in _gauge_series(snap, "mxtpu_serving_batch_occupancy"):
        rows.append(f"  occupancy{{{labels.get('endpoint', '?')}}}={v:.2f}")
    for _labels, v in _gauge_series(snap, "mxtpu_serving_prep_overlap_ratio"):
        rows.append(f"  prep_overlap_ratio={v:.2f}")
    if rows:
        lines.append("")
        lines.append("== queues / pipeline ==")
        lines.extend(rows)

    from . import slo as _slo
    objectives = _slo.MONITOR.snapshot()
    if objectives:
        lines.append("")
        lines.append("== slo burn ==")
        for st in objectives:
            alert = "ALERT" if st["alert_active"] else "ok"
            lines.append(
                f"  {st['endpoint']}: fast={st['fast_burn']:.2f}x "
                f"slow={st['slow_burn']:.2f}x [{alert}] "
                f"target={st['target']:.4%} "
                f"threshold={_fmt_us(st['threshold_us'])}")

    ck = _gauge_series(snap, "mxtpu_checkpoint_last_step")
    if ck:
        lines.append("")
        lines.append("== checkpoint ==")
        for labels, v in ck:
            label = ",".join(f"{k}={val}" for k, val in sorted(labels.items()))
            lines.append(f"  last_step{{{label}}}={v:g}")
        saves = _gauge_series(snap, "mxtpu_checkpoint_saves_total")
        for labels, v in saves:
            lines.append(f"  saves_total={v:g}")

    lines.append("")
    lines.append("== flight recorder ==")
    d = _flight.RECORDER.directory
    lines.append(f"  dir={d or '(unset: ring-only, no bundles)'} "
                 f"spans={len(_flight.RECORDER._spans)} "
                 f"events={len(_flight.RECORDER._events)} "
                 f"requests={len(_flight.RECORDER._requests)}")
    for ev in _flight.recent_events()[-5:]:
        lines.append(f"  last: {ev['kind']} "
                     f"@{time.strftime('%H:%M:%S', time.localtime(ev['ts']))}"
                     f" {ev['attrs']}")
    return "\n".join(lines) + "\n"


def tracez(limit_traces: int = 50) -> str:
    """Recent finished spans grouped by trace id, newest trace first."""
    spans = _flight.recent_spans()
    by_trace: Dict[str, List[Dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    groups = sorted(by_trace.items(),
                    key=lambda kv: max(s["t0_us"] for s in kv[1]),
                    reverse=True)[:limit_traces]
    lines = [f"tracez: {len(spans)} spans in ring, {len(by_trace)} traces "
             f"(showing {len(groups)})"]
    for trace_id, group in groups:
        group.sort(key=lambda s: s["t0_us"])
        t0 = group[0]["t0_us"]
        lines.append("")
        lines.append(f"trace {trace_id}")
        for s in group:
            dur = s["dur_us"] if s["dur_us"] is not None else 0
            attrs = f" {s['attrs']}" if s["attrs"] else ""
            lines.append(f"  +{(s['t0_us'] - t0) / 1e3:9.3f}ms "
                         f"{_fmt_us(dur):>10} {s['name']}{attrs}")
    return "\n".join(lines) + "\n"


def flightz(do_dump: bool = False) -> Dict:
    body: Dict = {"dir": _flight.RECORDER.directory or None}
    if do_dump:
        body["dumped"] = _flight.dump(trigger="flightz")
    d = _flight.RECORDER.directory
    body["bundles"] = [
        {"path": p, "bytes": _safe_size(p)} for p in _flight.list_bundles(d)
    ] if d else []
    body["recent_events"] = _flight.recent_events()[-20:]
    return body


def _fmt_bytes(v: float) -> str:
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024.0 or unit == "GiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{v:.0f}B"
        v /= 1024.0
    return f"{v:.1f}GiB"


def memz() -> str:
    """Device-memory attribution page. Refreshes the device-memory gauges
    on demand (the page IS the scrape: ``torch.cuda.memory_stats``, a host
    read of the caching allocator) before reconciling the holder table."""
    from .reporter import sample_device_memory
    from . import memstats as _memstats
    sample_device_memory()
    bd = _memstats.breakdown()
    lines = [f"memz  ts={time.strftime('%Y-%m-%d %H:%M:%S')}"]
    lines.append("")
    lines.append("== devices (memory_stats vs attributed holders) ==")
    if not bd["devices"]:
        lines.append("  (backend reports no memory_stats; holders only)")
    for dev, st in sorted(bd["devices"].items()):
        lines.append(
            f"  {dev}: in_use={_fmt_bytes(st['bytes_in_use'])} "
            f"peak={_fmt_bytes(st['peak_bytes_in_use'])} "
            f"attributed={_fmt_bytes(st['attributed'])} "
            f"unattributed={_fmt_bytes(st['unattributed'])}")
    lines.append("")
    lines.append(f"== holders (top {len(bd['holders'])} of "
                 f"{bd['holders_total']}, "
                 f"attributed={_fmt_bytes(bd['attributed_bytes'])}) ==")
    for h in bd["holders"]:
        dev = f" dev={h['device']}" if h["device"] else ""
        lines.append(f"  {_fmt_bytes(h['bytes']):>10}  "
                     f"peak={_fmt_bytes(h['peak_bytes']):>10}  "
                     f"{h['subsystem']}/{h['holder']}{dev}")
    if bd["holders_omitted_bytes"]:
        lines.append(f"  ... omitted holders: "
                     f"{_fmt_bytes(bd['holders_omitted_bytes'])}")
    return "\n".join(lines) + "\n"


def fleetz() -> Dict:
    """The fleet pane as one JSON document: merged per-replica metrics
    (local registry + MXNET_FLEET_DUMP_GLOB snapshot files), the worst-of
    health rollup, and this process's goodput attribution + per-executable
    utilization estimates (none until the compile ledger, Q1.12c).
    ``tools/fleet_report.py`` renders the offline equivalent from dump
    files alone."""
    from . import fleet as _fleet
    from . import goodput as _goodput
    body = _fleet.collect()
    body["goodput"] = {
        "wall_s": round(_goodput.wall_seconds(), 3),
        "buckets": {k: round(v, 3)
                    for k, v in _goodput.account().items()},
    }
    body["utilization"] = _goodput.utilization()
    return body


def _safe_size(p: str) -> Optional[int]:
    import os
    try:
        return os.path.getsize(p)
    except OSError:
        return None


class _Handler(BaseHTTPRequestHandler):
    # one access-log line per scrape would swamp real logs: stay quiet
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send(self, status: int, body: str, ctype: str = "text/plain"):
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", f"{ctype}; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 — http.server API
        url = urlparse(self.path)
        page = url.path.rstrip("/") or "/"
        try:
            if page == "/metricsz":
                q = parse_qs(url.query)
                if q.get("json", ["0"])[0] in ("1", "true", "yes"):
                    # snapshot JSON (the telemetry.dump() shape): the scrape
                    # form of a reporter dump file, for FleetCollectors in
                    # other processes
                    from . import snapshot
                    self._send(200, json.dumps(snapshot(), indent=1,
                                               sort_keys=True),
                               ctype="application/json")
                else:
                    from . import prometheus_text
                    self._send(200, prometheus_text())
            elif page == "/healthz":
                status, body = healthz()
                self._send(status, json.dumps(body, indent=1),
                           ctype="application/json")
            elif page == "/statusz":
                self._send(200, statusz())
            elif page == "/tracez":
                self._send(200, tracez())
            elif page == "/flightz":
                q = parse_qs(url.query)
                body = flightz(do_dump=q.get("dump", ["0"])[0] in
                               ("1", "true", "yes"))
                self._send(200, json.dumps(body, indent=1, default=repr),
                           ctype="application/json")
            elif page in NOT_PORTED:
                self._send(501, f"{page}: {NOT_PORTED[page]} waits for "
                                f"ROADMAP Q1.12c\n" + _PAGE_LIST)
                return
            elif page == "/memz":
                self._send(200, memz())
            elif page == "/fleetz":
                self._send(200, json.dumps(fleetz(), indent=1, default=repr),
                           ctype="application/json")
            elif page == "/":
                self._send(200, "mxnet_tpu_torch debug server\n"
                           + _PAGE_LIST)
            else:
                self._send(404, f"no such page: {page}\n" + _PAGE_LIST)
                return
            _SCRAPES.labels(page.lstrip("/") or "index").inc()
        except BrokenPipeError:
            pass
        except Exception as e:
            try:
                self._send(500, f"debug page {page} failed: {e!r}\n")
            except Exception:
                pass


class DebugServer:
    """Localhost HTTP introspection server. ``port=0`` binds an ephemeral
    port (tests); read ``.port`` for the actual one."""

    def __init__(self, port: Optional[int] = None, host: Optional[str] = None):
        if port is None:
            port = int(_cfg("MXNET_DEBUG_PORT", 0))
        if host is None:
            host = str(_cfg("MXNET_DEBUG_HOST", "127.0.0.1"))
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "DebugServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mxtpu-debug-server")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _autostart() -> Optional[DebugServer]:
    """Env-driven start (called once from the package's ``__init__``): a
    nonzero MXNET_DEBUG_PORT makes every process self-introspectable."""
    port = int(_cfg("MXNET_DEBUG_PORT", 0))
    if port <= 0:
        return None
    try:
        return DebugServer(port).start()
    except OSError:
        # port taken (multi-process on one host): introspection is
        # best-effort, never fatal
        return None
