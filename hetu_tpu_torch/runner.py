"""``python -m hetu_tpu_torch.runner``: start the worker processes of a
data-parallel job on this machine (counterpart of the local-worker part
of ``hetu_tpu/runner.py``, the reference's ``heturun``).

    python -m hetu_tpu_torch.runner -w 2 \\
        python -m hetu_tpu_torch.examples.cnn_main --model mlp \\
        --dataset CIFAR10 --comm-mode AllReduce
    python -m hetu_tpu_torch.runner -c examples/cnn/settings/local_w4.yml \\
        python -m hetu_tpu_torch.examples.cnn_main ...

``-w N`` or a cluster yaml whose nodes list ``workers:`` starts N copies
of the command, one per device, each with ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``WORKER_ID``, ``HETU_NUM_WORKER`` and
``HETU_INIT_METHOD``: a ``file://`` store in a temporary directory that
the runner removes when the job ends, so no port is taken.
``multihost.initialize`` (and ``ht.mpi_nccl_init``) read them. Each
worker on a card joins over NCCL, which needs a card per worker; on the
CPU the workers join over gloo.

The runner exits with the first non-zero exit code of a worker, after
stopping the others (a peer left waiting in a collective would never
return), and with 0 when every worker does. Parameter-server roles,
remote hosts over ssh, ``--elastic``, ``--pilot`` and
``--telemetry-dir`` raise, naming the slice that brings them.
"""
from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

_LOCAL_HOSTS = ("localhost", "127.0.0.1")


def parse_cluster(path: str) -> int:
    """The number of workers a cluster yaml asks for on this machine."""
    import yaml     # only for -c: -w runs where PyYAML is not installed
    with open(path) as f:
        nodes = yaml.safe_load(f)["nodes"]
    workers = 0
    for node in nodes:
        if node.get("servers", 0):
            raise NotImplementedError(
                f"{path}: parameter-server roles (servers:) arrive with "
                "slice 4b")
        if node.get("host", "localhost") not in _LOCAL_HOSTS:
            raise NotImplementedError(
                f"{path}: host {node['host']!r}: workers on other machines "
                "(over ssh) arrive with slice 3b; this runner starts local "
                "workers")
        workers += int(node.get("workers", 0))
    return workers


def _stop(procs, grace_s: float = 10.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run(command, n_workers: int) -> int:
    """Run ``n_workers`` copies of ``command``; the job's exit code."""
    store_dir = tempfile.mkdtemp(prefix="hetu_run_")
    env = dict(os.environ, WORLD_SIZE=str(n_workers),
               HETU_NUM_WORKER=str(n_workers),
               HETU_INIT_METHOD="file://" + os.path.join(store_dir, "store"))
    procs = []
    try:
        for rank in range(n_workers):
            procs.append(subprocess.Popen(command, env=dict(
                env, RANK=str(rank), LOCAL_RANK=str(rank),
                WORKER_ID=str(rank))))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:   # a worker killed by signal s exits 128 + s
                return failed[0] if failed[0] > 0 else 128 - failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        _stop(procs)
        shutil.rmtree(store_dir, ignore_errors=True)


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m hetu_tpu_torch.runner")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("-w", "--workers", type=int,
                       help="number of local worker processes")
    group.add_argument("-c", "--config",
                       help="cluster yaml (nodes: host/workers)")
    parser.add_argument("--elastic", action="store_true",
                        help="not ported: slice 9")
    parser.add_argument("--pilot", action="store_true",
                        help="not ported: slice 9")
    parser.add_argument("--telemetry-dir", default="",
                        help="not ported: slice 10")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the worker command, e.g. python train.py ...")
    args = parser.parse_args(argv)
    if args.elastic or args.pilot:
        raise NotImplementedError(
            "--elastic and --pilot arrive with slice 9 (robustness)")
    if args.telemetry_dir:
        raise NotImplementedError("--telemetry-dir arrives with slice 10 "
                                  "(telemetry)")
    if not args.command:
        parser.error("no worker command given")
    n = args.workers if args.config is None else parse_cluster(args.config)
    if n < 1:
        parser.error(f"need at least one worker, got {n}")
    signal.signal(signal.SIGTERM, _terminated)
    return run(args.command, n)


if __name__ == "__main__":
    sys.exit(main())
