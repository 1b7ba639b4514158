#!/usr/bin/env python
"""Launch a multi-process job of the port on this machine (the
counterpart of the repo's ``tools/launch.py``, ``--launcher local``).

Starts ``-n`` copies of the command, each with the variables that
``mxnet_tpu_torch.parallel.collectives.initialize_distributed`` (and every
``dist_*`` kvstore) reads: ``MXNET_TPU_COORDINATOR`` (127.0.0.1 and a free
port), ``MXNET_TPU_NUM_WORKERS`` and ``MXNET_TPU_WORKER_ID``, plus the
DMLC names of the reference's launcher and a shared heartbeat directory
(``MXNET_KVSTORE_HEARTBEAT_DIR``) unless one is set. The workers' standard
output and error pass through. When a worker exits non-zero every other
worker is killed; past ``--timeout`` seconds all are. The exit code is 0
when every worker exited 0, else 1 (124 on the timeout).

Usage::

    python mxnet_tpu_torch/tools/launch.py -n 2 [--timeout S] [--env K=V]
        -- python3 worker.py

It imports nothing of the port (nor torch), so it starts at once.
"""
import argparse
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now; the next one up must be free too
    (the dist_async parameter service binds it)."""
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        if port >= 65535:
            continue
        probe = socket.socket()
        try:
            probe.bind(("127.0.0.1", port + 1))
        except OSError:
            continue
        finally:
            probe.close()
        return port


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def launch_local(num_workers, command, extra_env=(), port=None,
                 timeout=None) -> int:
    """Run ``num_workers`` copies of ``command``; 0 when all exit 0, 1 when
    one fails (the others killed), 124 when ``timeout`` seconds pass."""
    port = port or free_port()
    own_dir = not os.environ.get("MXNET_KVSTORE_HEARTBEAT_DIR")
    hb_dir = tempfile.mkdtemp(prefix="mxnet_heartbeat_") if own_dir else \
        os.environ["MXNET_KVSTORE_HEARTBEAT_DIR"]
    try:
        return _run(num_workers, command, extra_env, port, timeout, hb_dir)
    finally:
        if own_dir:
            shutil.rmtree(hb_dir, ignore_errors=True)


def _run(num_workers, command, extra_env, port, timeout, hb_dir):
    procs = []
    for wid in range(num_workers):
        env = dict(os.environ)
        env["MXNET_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        env["MXNET_TPU_NUM_WORKERS"] = str(num_workers)
        env["MXNET_TPU_WORKER_ID"] = str(wid)
        env["DMLC_NUM_WORKER"] = str(num_workers)
        env["DMLC_ROLE"] = "worker"
        env["MXNET_KVSTORE_HEARTBEAT_DIR"] = hb_dir
        for kv in extra_env:
            k, _, v = kv.partition("=")
            env[k] = v
        procs.append(subprocess.Popen(command, env=env))

    def on_signal(signum, frame):
        _stop(procs)
        sys.exit(1)

    prev = signal.signal(signal.SIGTERM, on_signal)
    prev_int = signal.signal(signal.SIGINT, on_signal)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
                print(f"launch: worker(s) {bad} exited {[codes[i] for i in bad]}"
                      "; stopping the others", file=sys.stderr, flush=True)
                _stop(procs)
                return 1
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                print(f"launch: timeout after {timeout} s; stopping every "
                      "worker", file=sys.stderr, flush=True)
                _stop(procs)
                return 124
            time.sleep(0.05)
    finally:
        signal.signal(signal.SIGTERM, prev)
        signal.signal(signal.SIGINT, prev_int)


def run(num_workers, command, timeout, env=None, cwd=None):
    """This launcher in a subprocess of its own: ``num_workers`` copies of
    ``command`` with a ``timeout`` (seconds, passed to the launcher and,
    with a margin, to the subprocess); returns the ``CompletedProcess``
    with the workers' standard output and error captured as text."""
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), "-n", str(num_workers),
         "--timeout", str(timeout), "--"] + list(command),
        env=env, cwd=cwd, capture_output=True, text=True,
        timeout=timeout + 30)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Launch a local "
                                     "multi-process job")
    parser.add_argument("-n", "--num-workers", required=True, type=int)
    parser.add_argument("-s", "--num-servers", type=int, default=0,
                        help="accepted as the reference's launcher does; "
                             "allreduce needs no server processes")
    parser.add_argument("--launcher", default="local", choices=["local"])
    parser.add_argument("--env", action="append", default=[],
                        help="extra K=V environment for every worker")
    parser.add_argument("-p", "--port", type=int, default=None)
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds before every worker is killed")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command:
        parser.error("no command given")
    return launch_local(args.num_workers, args.command, args.env, args.port,
                        args.timeout)


if __name__ == "__main__":
    sys.exit(main())
