"""The host parameter service of ``dist_async`` (the port's own copy of
``mxnet_tpu/kvstore/async_ps.py``).

In async mode (``kvstore_dist_server.h:336-382``) the server applies EACH
worker's pushed gradient to the stored weight the moment it arrives: no
aggregation barrier, no waiting on stragglers; a pull returns the weight as
it is then. Collectives are bulk-synchronous, so asynchrony runs beside
them on the host network, as the reference's runs over the ps-lite TCP
van: rank 0 holds the weights in host memory and applies its process's
updater to each arriving push (``KVStore._server_apply``, on CPU tensors);
the card's memory is touched only by a worker's pull, which copies to the
caller's device. The service binds the port after the launcher's
coordinator port (``MXNET_TPU_COORDINATOR``).

Optional bounded staleness (``MXNET_KVSTORE_ASYNC_MAX_STALENESS`` >= 0): a
push from a worker more than S whole-model clocks ahead of the slowest
worker waits until the gap closes (stale-synchronous parallel); -1, the
default, is the reference's unbounded behaviour.

Wire protocol: length-prefixed pickles, one persistent connection per
worker:
  ("init", key, ndarray)        -> "ok"    first writer wins
  ("push", key, ndarray, rank)  -> "ok"    applies updater(key, grad, weight)
  ("pull", key)                 -> ndarray
  ("clock", rank)               -> int     pushes applied for rank
  ("shutdown",)                 -> "ok"
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Callable, Dict, Optional

import numpy as onp


def _send(sock, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)


def _recv(sock):
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    n = struct.unpack("<Q", hdr)[0]
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return pickle.loads(bytes(buf))


def service_address() -> tuple:
    """The service binds next to the launcher's coordinator port."""
    coord = os.environ.get("MXNET_TPU_COORDINATOR", "127.0.0.1:29400")
    host, port = coord.rsplit(":", 1)
    return host, int(port) + 1


class AsyncParameterServer:
    """Rank-0-hosted async parameter service (one thread per worker)."""

    def __init__(self, updater: Callable, num_workers: int,
                 max_staleness: int = -1, address=None):
        self._updater = updater
        self._num_workers = num_workers
        self._max_staleness = max_staleness
        self._weights: Dict = {}
        self._key_locks: Dict = {}
        self._state_lock = threading.Lock()
        self._clock_cv = threading.Condition()
        self._clocks = [0] * num_workers          # whole-model push rounds
        self._per_rank_pushes = [0] * num_workers
        self._num_keys_hint: Optional[int] = None
        host, port = address or service_address()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(num_workers + 2)
        self._stopping = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- server internals ---------------------------------------------------
    def _accept_loop(self):
        while not self._stopping.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        try:
            while True:
                msg = _recv(conn)
                op = msg[0]
                if op == "init":
                    _, key, val = msg
                    with self._state_lock:
                        if key not in self._weights:  # first writer wins
                            self._weights[key] = onp.array(val)
                            self._key_locks[key] = threading.Lock()
                    _send(conn, "ok")
                elif op == "push":
                    _, key, grad, rank = msg
                    self._maybe_wait_for_stragglers(rank)
                    with self._key_locks[key]:
                        # applied on arrival
                        self._updater(key, grad, self._weights[key])
                    self._advance_clock(rank)
                    _send(conn, "ok")
                elif op == "pull":
                    _, key = msg
                    with self._key_locks[key]:
                        out = self._weights[key].copy()
                    _send(conn, out)
                elif op == "clock":
                    _, rank = msg
                    _send(conn, self._per_rank_pushes[rank])
                elif op == "shutdown":
                    _send(conn, "ok")
                    self.stop()
                    return
        except (ConnectionError, OSError):
            return

    def _maybe_wait_for_stragglers(self, rank):
        if self._max_staleness < 0:
            return
        with self._clock_cv:
            while (self._clocks[rank] - min(self._clocks)
                   > self._max_staleness):
                if not self._clock_cv.wait(timeout=60.0):
                    raise TimeoutError(
                        f"rank {rank} blocked >60s at staleness bound "
                        f"{self._max_staleness} (clocks={self._clocks})")

    def _advance_clock(self, rank):
        with self._clock_cv:
            self._per_rank_pushes[rank] += 1
            if self._num_keys_hint:
                self._clocks[rank] = (self._per_rank_pushes[rank]
                                      // self._num_keys_hint)
            else:
                self._clocks[rank] = self._per_rank_pushes[rank]
            self._clock_cv.notify_all()

    def set_num_keys(self, n: int):
        """One clock tick = one whole-model push (n keys)."""
        self._num_keys_hint = max(int(n), 1)

    def stop(self):
        self._stopping.set()
        try:
            self._srv.close()
        except OSError:
            pass


class AsyncPSClient:
    """Per-process client; thread-safe via a connection lock."""

    def __init__(self, rank: int, address=None, timeout=120.0):
        import time
        self._rank = rank
        self._lock = threading.Lock()
        host, port = address or service_address()
        deadline = time.monotonic() + timeout
        last = None
        while True:
            try:
                self._sock = socket.create_connection((host, port), timeout=5)
                break
            except OSError as e:   # server not up yet
                last = e
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"async PS at {host}:{port} unreachable: {last}")
                time.sleep(0.05)
        self._sock.settimeout(300.0)

    def _call(self, *msg):
        with self._lock:
            _send(self._sock, msg)
            return _recv(self._sock)

    def init(self, key, value):
        return self._call("init", key, onp.asarray(value))

    def push(self, key, grad):
        return self._call("push", key, onp.asarray(grad), self._rank)

    def pull(self, key):
        return self._call("pull", key)

    def clock(self, rank=None):
        return self._call("clock", self._rank if rank is None else rank)

    def shutdown_server(self):
        try:
            return self._call("shutdown")
        except ConnectionError:
            return "ok"

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
