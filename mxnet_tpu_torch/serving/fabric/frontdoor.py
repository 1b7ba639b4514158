"""Multi-host serving front door: membership by heartbeat, consistent-hash
tenant routing, and cross-host failover with zero client-visible errors
(the port of ``mxnet_tpu/serving/fabric/frontdoor.py``).

A :class:`FrontDoor` fronts N *hosts*. Each host is one serving plane — an
``InferenceServer`` (built by the caller's ``host_factory``, endpoints
registered and started) plus a **host agent subprocess**, the stand-in for
a process-group member. The agent runs a tiny real workload at startup (a
two-layer net served through the port's ``InferenceServer`` on the context
the front door names, inside a ``fabric.host_agent`` span that joins the
parent's journey through the inherited ``MXNET_TRACE_ID``), then
heartbeats: every tick it rewrites its heartbeat file, re-attributes
goodput (``goodput.account()``: buckets reconcile to wall exactly) and
rewrites its telemetry dump, so a SIGKILLed host leaves a recent dump for
the post-mortem pane. A silent host is detected by heartbeat age
(:meth:`check_hosts`), a dead agent by its exit, never by an RPC that would
hang. An agent exits at its deadline (:data:`AGENT_TIMEOUT_S`) or when
its parent process is gone, and :meth:`stop` kills and reaps every agent.

Routing is a consistent-hash ring (``MXNET_FABRIC_VNODES`` virtual nodes
per host, md5 positions): a tenant maps to the first **alive** host at or
after its hash. Rebalancing is bounded by construction — when a host dies,
exactly the tenants whose walk landed on it move (to the next survivor
clockwise); every other tenant keeps its host.

Failover rides the same fencing discipline as the intra-host supervisor
(each host also gets a :class:`~..supervisor.PoolSupervisor`): killing a
host bumps the front door's epoch, fails the host's queued work with
``ServerClosedError`` via ``stop(drain=False)``, and the front door's
wrapper future catches exactly that and resubmits on the rerouted survivor
under the ``frontdoor`` retry budget — the client's future resolves
normally.

Telemetry: ``moves``, ``failovers`` (by host), ``resubmits`` and
``requests_by_host`` are this front door's share of the reference's
``mxtpu_fabric_*`` counters, and ``mxtpu_fabric_hosts`` counts hosts by
liveness; a host's failover fires the ``host_down`` flight trigger and
records a ``fabric_host_down`` event. :meth:`fleet_collect` merges every
agent's dump with this process's registry into one fleet view, and
:meth:`goodput_reconcile` checks each host's goodput ledger against its
own wall clock.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from ... import config as _config
from ... import telemetry as _telemetry
from ...base import Context, MXNetError, current_context
from ...resilience import faults as _faults
from ...resilience.faults import FaultInjected
from .. import tailguard as _tailguard
from ..errors import ServerClosedError, ServerOverloadError
from ...telemetry import flight as _flight
from ...telemetry.fleet import FleetCollector
from ...telemetry.metrics import Baseline
from ..supervisor import PoolSupervisor

__all__ = ["FrontDoor"]

_HOSTS_G = _telemetry.gauge(
    "mxtpu_fabric_hosts",
    "Front-door hosts by liveness ('alive'/'down').",
    labelnames=("state",))
_MOVES_C = _telemetry.counter(
    "mxtpu_fabric_tenant_moves_total",
    "Tenants rehashed to a different host after a membership change — "
    "bounded rebalancing means only a dead host's tenants ever move.")
_FAILOVERS_C = _telemetry.counter(
    "mxtpu_fabric_host_failovers_total",
    "Host-down failovers the front door executed, by host.",
    labelnames=("host",))
_RESUBMITS_C = _telemetry.counter(
    "mxtpu_fabric_resubmits_total",
    "In-flight requests resubmitted on a survivor after their host died.")
_REQS_C = _telemetry.counter(
    "mxtpu_fabric_requests_total",
    "Requests routed through the front door, by host.",
    labelnames=("host",))

# The process-group member: a real subprocess a host, importing only the
# port. Startup serves a tiny real workload on FABRIC_CTX (its spans join
# the parent's journey via the inherited MXNET_TRACE_ID), then each tick
# rewrites the heartbeat file (tmp + rename: a reader never sees half a
# beat), re-attributes goodput and rewrites this host's telemetry dump
# (tmp + rename too). It exits at its deadline or when its parent is gone.
_HOST_AGENT_SRC = """\
import os, time
import numpy as np
import torch
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.telemetry import goodput

host = os.environ["FABRIC_HOST"]
hb = os.environ["FABRIC_HB_PATH"]
dump = os.environ["FABRIC_DUMP_PATH"]
tick_s = float(os.environ["FABRIC_TICK_S"])
deadline = time.time() + float(os.environ["FABRIC_AGENT_MAX_S"])
parent = int(os.environ["FABRIC_PARENT_PID"])
kind, index = os.environ["FABRIC_CTX"].split(":")
ctx = mt.Context(kind, int(index))
torch.set_num_threads(1)

mt.random.seed(0)
with ctx, telemetry.span("fabric.host_agent", host=host):
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=6), nn.Dense(4, in_units=8))
    net.initialize(mt.init.Xavier(), ctx=ctx)
    name = "fabric_probe_" + host
    srv = serving.InferenceServer(batch_timeout_ms=1.0)
    srv.register(serving.ModelEndpoint(name, net, input_shapes=(6,),
                                       max_batch_size=4, ctx=ctx))
    srv.start()
    for _ in range(3):
        srv.submit(name, np.zeros((2, 6), "float32")).result(timeout=30)
    srv.stop()
    serving.unregister(name)
telemetry.spool_flush()
while time.time() < deadline and os.getppid() == parent:
    tmp = hb + ".tmp"
    with open(tmp, "w") as f:
        f.write(repr(time.time()))
    os.replace(tmp, hb)
    goodput.account()
    telemetry.dump(dump)
    time.sleep(tick_s)
"""

_PKG_ROOT = str(Path(__file__).resolve().parents[3])
#: an agent's lifetime; past it the agent exits and check_hosts declares
#: its host down
AGENT_TIMEOUT_S = 3600.0


def _hash(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class _Host:
    __slots__ = ("name", "server", "supervisor", "agent", "hb_path",
                 "dump_path", "alive")

    def __init__(self, name, server):
        self.name = name
        self.server = server
        self.supervisor = None
        self.agent = None
        self.hb_path = ""
        self.dump_path = ""
        self.alive = True


class FrontDoor:
    """Route tenants across host serving planes; survive a host dying.

    Parameters
    ----------
    hosts : sequence of str
        Host names (process-group members).
    host_factory : callable(name) -> InferenceServer
        Builds one host's serving plane: a STARTED server with this
        fabric's endpoints registered. Every host must register the same
        tenant set — the ring may land any tenant on any host.
    spawn_agents : bool
        Launch the per-host agent subprocess (heartbeats). On by default;
        tests that only exercise routing may turn it off.
    supervise : bool
        Attach a PoolSupervisor to each host's server for intra-host
        worker/prep failover. On by default.
    workdir : str, optional
        Where heartbeat files and the agents' telemetry dumps live
        (default: a fresh tempdir, removed at :meth:`stop`).

    Each agent runs its probe workload on :func:`current_context` as it
    stands when the FrontDoor is built (``gpu(0)`` unless the caller is
    inside ``with cpu():``).
    """

    def __init__(self, hosts: Sequence[str],
                 host_factory: Callable[[str], object],
                 spawn_agents: bool = True, supervise: bool = True,
                 workdir: Optional[str] = None):
        names = list(hosts)
        if len(set(names)) != len(names) or not names:
            raise MXNetError(f"need unique, non-empty host names: {names}")
        self.epoch = 0
        # this front door's share of the fabric families
        self._own = Baseline({"moves": _MOVES_C, "resubmits": _RESUBMITS_C})
        self._requests = Baseline({n: _REQS_C.labels(n) for n in names})
        self._failovers = Baseline()
        self._lock = threading.RLock()
        self._own_workdir = workdir is None
        self._workdir = workdir or tempfile.mkdtemp(prefix="mxtpu-fabric-")
        self._vnodes = int(_config.get("MXNET_FABRIC_VNODES"))
        self._agent_ctx = Context(current_context())
        self._hosts: Dict[str, _Host] = {}
        self._owner: Dict[str, str] = {}      # tenant -> host, for move count
        for n in names:
            h = _Host(n, host_factory(n))
            h.hb_path = os.path.join(self._workdir, f"hb-{n}")
            h.dump_path = os.path.join(self._workdir, f"dump-{n}.json")
            if supervise:
                h.supervisor = PoolSupervisor(h.server).start()
            self._hosts[n] = h
        tenant_sets = {n: frozenset(h.server._router.names())
                       for n, h in self._hosts.items()}
        if len(set(tenant_sets.values())) != 1:
            self.stop(drain=False)
            raise MXNetError(
                f"hosts must register identical tenant sets, got "
                f"{ {n: sorted(s) for n, s in tenant_sets.items()} }")
        self._ring = self._build_ring()
        self._set_hosts_gauge()
        if spawn_agents:
            for h in self._hosts.values():
                self._spawn_agent(h)

    # -- membership -----------------------------------------------------
    def _build_ring(self) -> List:
        ring = []
        for n in self._hosts:
            for v in range(self._vnodes):
                ring.append((_hash(f"{n}#{v}"), n))
        ring.sort()
        return ring

    def _spawn_agent(self, h: _Host):
        env = dict(os.environ)
        env["FABRIC_HOST"] = h.name
        env["FABRIC_HB_PATH"] = h.hb_path
        env["FABRIC_DUMP_PATH"] = h.dump_path
        env["FABRIC_TICK_S"] = str(_config.get("MXNET_FABRIC_HEARTBEAT_S"))
        env["FABRIC_AGENT_MAX_S"] = str(AGENT_TIMEOUT_S)
        env["FABRIC_PARENT_PID"] = str(os.getpid())
        env["FABRIC_CTX"] = (f"{self._agent_ctx.device_type}:"
                             f"{self._agent_ctx.device_id}")
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        h.agent = subprocess.Popen(
            [sys.executable, "-c", _HOST_AGENT_SRC], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    @staticmethod
    def _reap(h: _Host):
        """SIGKILL the host's agent if it runs, and wait for it."""
        if h.agent is not None and h.agent.poll() is None:
            h.agent.send_signal(signal.SIGKILL)
            h.agent.wait(timeout=10)

    def hosts(self) -> List[str]:
        return list(self._hosts)

    def alive_hosts(self) -> List[str]:
        return [n for n, h in self._hosts.items() if h.alive]

    def hosts_by_state(self) -> Dict[str, int]:
        """Hosts alive and down (``mxtpu_fabric_hosts``)."""
        up = len(self.alive_hosts())
        return {"alive": up, "down": len(self._hosts) - up}

    def _set_hosts_gauge(self):
        for state, n in self.hosts_by_state().items():
            _HOSTS_G.labels(state).set(n)

    @property
    def moves(self) -> int:
        return int(self._own["moves"])

    @property
    def resubmits(self) -> int:
        return int(self._own["resubmits"])

    @property
    def failovers(self) -> Dict[str, int]:
        return self._failovers.as_dict()

    @property
    def requests_by_host(self) -> Dict[str, int]:
        return self._requests.as_dict()

    def tenants(self) -> List[str]:
        h = next(iter(self._hosts.values()))
        return list(h.server._router.names())

    def heartbeat_age(self, name: str) -> Optional[float]:
        """Seconds since host ``name``'s agent last beat (None before its
        first beat)."""
        try:
            with open(self._hosts[name].hb_path) as f:
                return time.time() - float(f.read().strip())
        except (OSError, ValueError):
            return None

    def agent_pid(self, name: str) -> Optional[int]:
        agent = self._hosts[name].agent
        return agent.pid if agent is not None else None

    # -- routing --------------------------------------------------------
    def route(self, tenant: str) -> str:
        """The first alive host at/after the tenant's ring position.
        Bounded rebalancing falls out of the walk: a dead host only
        reroutes the tenants that previously landed on it."""
        with self._lock:
            if not any(h.alive for h in self._hosts.values()):
                raise ServerClosedError("fabric: every host is down")
            pos = _hash(tenant)
            idx = 0
            for i, (p, _) in enumerate(self._ring):
                if p >= pos:
                    idx = i
                    break
            for step in range(len(self._ring)):
                _, name = self._ring[(idx + step) % len(self._ring)]
                if self._hosts[name].alive:
                    prev = self._owner.get(tenant)
                    if prev is not None and prev != name:
                        _MOVES_C.inc()
                    self._owner[tenant] = name
                    return name
            raise ServerClosedError("fabric: every host is down")

    def submit(self, tenant: str, inputs, deadline_ms: Optional[float] = None
               ) -> Future:
        """Route and enqueue; the returned future hides host death. When
        the serving host dies before this request resolves, the request is
        resubmitted on the rerouted survivor behind the same future —
        callers never see the dead host's ServerClosedError.

        ``deadline_ms`` mints the request's end-to-end
        :class:`~..tailguard.Deadline` here, at ingress — the one budget
        every downstream tier decrements."""
        deadline = _tailguard.Deadline(deadline_ms) \
            if deadline_ms is not None else None
        out: Future = Future()
        self._submit_once(tenant, inputs, deadline_ms, out,
                          tries=len(self._hosts), deadline=deadline)
        return out

    def _submit_once(self, tenant, inputs, deadline_ms, out: Future,
                     tries: int, deadline=None):
        if deadline is not None:
            deadline.check("ingress")
        # the network hop between client and serving plane: net_delay
        # sleeps in place; net_drop (a partition) raises and is absorbed by
        # re-sending under the frontdoor retry budget
        while True:
            try:
                _faults.check("frontdoor")
                break
            except FaultInjected as e:
                if not e.retryable or not _tailguard.retry_allowed(
                        "frontdoor"):
                    raise
                if deadline is not None:
                    deadline.check("ingress")
        host = self.route(tenant)
        h = self._hosts[host]
        _REQS_C.labels(host).inc()
        # one routed request = one unit of real work funding the frontdoor
        # tier's retry budget
        _tailguard.retry_deposit("frontdoor")
        try:
            inner = h.server.submit(tenant, inputs, deadline_ms=deadline_ms,
                                    deadline=deadline)
        except (ServerClosedError, ServerOverloadError):
            # overload on a LIVE host is the caller's backpressure signal;
            # only a dead host's rejection reroutes (race with kill_host)
            if h.alive or tries <= 1 or not self.alive_hosts() \
                    or not _tailguard.retry_allowed("frontdoor"):
                raise
            _RESUBMITS_C.inc()
            return self._submit_once(tenant, inputs, deadline_ms, out,
                                     tries - 1, deadline=deadline)

        def _done(f: Future):
            exc = f.exception()
            if exc is None:
                out.set_result(f.result())
                return
            # ServerClosedError from a host marked down == the host died
            # with this request in flight: replay it on a survivor (same
            # propagated deadline), under the frontdoor retry budget
            if isinstance(exc, ServerClosedError) and not h.alive \
                    and tries > 1 and self.alive_hosts() \
                    and _tailguard.retry_allowed("frontdoor"):
                _RESUBMITS_C.inc()
                try:
                    self._submit_once(tenant, inputs, deadline_ms, out,
                                      tries - 1, deadline=deadline)
                except Exception as e:          # survivors full/closed
                    out.set_exception(e)
                return
            out.set_exception(exc)

        inner.add_done_callback(_done)

    # -- failure handling -----------------------------------------------
    def kill_host(self, name: str, reason: str = "host_down") -> Dict:
        """Take one host out: SIGKILL its agent, fail its serving plane
        (queued work raises ServerClosedError → the wrapper futures replay
        on survivors), bump the epoch fence and rehash. Returns a report
        naming the host, the epoch and how many tenants moved."""
        with self._lock:
            h = self._hosts.get(name)
            if h is None:
                raise MXNetError(f"unknown host {name!r}: {self.hosts()}")
            if not h.alive:
                return {"host": name, "epoch": self.epoch, "moved": 0,
                        "already_down": True}
            before = dict(self._owner)
            h.alive = False              # routing excludes it from here on
            self.epoch += 1
            epoch = self.epoch
        self._set_hosts_gauge()
        if h.agent is not None and h.agent.poll() is None:
            h.agent.send_signal(signal.SIGKILL)
        if h.supervisor is not None:
            h.supervisor.stop()
        h.server.stop(drain=False)       # fails inflight -> resubmission
        # reaped after the failover: a card process takes a few hundred ms
        # to tear its CUDA context down
        self._reap(h)
        moved = 0
        for t in self.tenants():
            new = self.route(t)
            if before.get(t) == name and new != name:
                moved += 1
        self._failovers.add(name, _FAILOVERS_C.labels(name)).inc()
        report = {"host": name, "reason": reason, "epoch": epoch,
                  "moved": moved, "survivors": self.alive_hosts()}
        _flight.trigger("host_down", **report)
        _telemetry.event("fabric_host_down", **report)
        return report

    def check_hosts(self) -> List[Dict]:
        """Heartbeat-age failure detector: a host whose agent has exited,
        or has not beaten within MXNET_FABRIC_HOST_TIMEOUT_S, is declared
        dead and failed over exactly like :meth:`kill_host`."""
        timeout_s = float(_config.get("MXNET_FABRIC_HOST_TIMEOUT_S"))
        reports = []
        for n, h in list(self._hosts.items()):
            if not h.alive or h.agent is None:
                continue
            age = self.heartbeat_age(n)
            dead_proc = h.agent.poll() is not None
            if dead_proc or (age is not None and age > timeout_s):
                reports.append(self.kill_host(
                    n, reason="agent_exit" if dead_proc else "heartbeat"))
        return reports

    # -- one pane of glass ----------------------------------------------
    def fleet_collect(self, include_local: bool = True) -> Dict:
        """The fleet collector over every host agent's dump (plus this
        front-door process when ``include_local``)."""
        coll = FleetCollector(include_local=include_local,
                              local_label=f"frontdoor-{os.getpid()}",
                              glob="")
        for n, h in self._hosts.items():
            if os.path.exists(h.dump_path):
                coll.add_file(h.dump_path, label=f"host-{n}")
        return coll.collect()

    def goodput_reconcile(self, tol: float = 0.01) -> Dict[str, Dict]:
        """Per-host goodput ledger check from each host's own dump: the
        bucket seconds must sum to that host's wall clock within ``tol``."""
        out = {}
        for n, h in self._hosts.items():
            if not os.path.exists(h.dump_path):
                continue
            with open(h.dump_path) as f:
                snap = json.load(f)
            mets = snap.get("metrics", {})
            wall = max((float(s.get("value", 0.0)) for s in
                        mets.get("mxtpu_goodput_wall_seconds",
                                 {}).get("series", [])), default=0.0)
            total = sum(float(s.get("value", 0.0)) for s in
                        mets.get("mxtpu_goodput_seconds_total",
                                 {}).get("series", []))
            out[n] = {"wall_s": wall, "buckets_sum_s": total,
                      "ok": abs(total - wall) <= tol * max(wall, 1e-9)}
        return out

    # -- lifecycle ------------------------------------------------------
    def stop(self, drain: bool = True):
        """Stop every surviving host plane and reap the agents (and remove
        the heartbeat directory the front door made itself)."""
        for h in self._hosts.values():
            if h.supervisor is not None:
                h.supervisor.stop()
            self._reap(h)
            if h.alive:
                h.alive = False
                h.server.stop(drain=drain)
        if self._own_workdir:
            shutil.rmtree(self._workdir, ignore_errors=True)

    def __repr__(self):
        return (f"FrontDoor(hosts={self.hosts()}, "
                f"alive={self.alive_hosts()}, epoch={self.epoch})")
