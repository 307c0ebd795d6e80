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

``--devices cuda:0,cuda:1`` gives rank r the r-th device (``HETU_DEVICE``;
default ``cuda:LOCAL_RANK``) and prints the rank -> device map;
``--backend gloo`` asks for gloo by name (``HETU_BACKEND``). Two ranks on
one card need both, since NCCL refuses them: they meet over gloo, which
stages their CUDA tensors through host memory::

    python -m hetu_tpu_torch.runner -w 2 --devices cuda:0,cuda:0 \
        --backend gloo python -m hetu_tpu_torch.examples.gpipe --stages 2

A cluster yaml whose nodes list ``servers: N`` also starts a
parameter-server scheduler and N servers on this machine, as light
processes (``ps/_light_role.py``), and gives every worker the
reference's ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT``,
``DMLC_NUM_WORKER``/``DMLC_NUM_SERVER`` and ``DMLC_ROLE=worker``; a
worker starts its agent with ``ht.worker_init()`` (or its first PS
executor) and closes it with ``ht.worker_finish()``:

    # cluster.yml: nodes: [{host: localhost, servers: 1, workers: 1,
    #                       chief: true}]
    python -m hetu_tpu_torch.runner -c cluster.yml python -m \
        hetu_tpu_torch.examples.ctr_main --comm Hybrid

The runner exits with the first non-zero exit code of a worker, after
stopping the others (a peer left waiting in a collective would never
return), or of a scheduler or server that exits before the workers are
done, and with 0 when every worker does; then it stops the servers and
reaps the roles. Remote hosts over ssh, ``--elastic``, ``--pilot`` and
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


def parse_cluster(path: str) -> tuple[int, int]:
    """The numbers of workers and of PS servers a cluster yaml asks for on
    this machine."""
    import yaml     # only for -c: -w runs where PyYAML is not installed
    with open(path) as f:
        nodes = yaml.safe_load(f)["nodes"]
    workers = servers = 0
    for node in nodes:
        if node.get("host", "localhost") not in _LOCAL_HOSTS:
            raise NotImplementedError(
                f"{path}: host {node['host']!r}: workers on other machines "
                "(over ssh) arrive with slice 3b; this runner starts local "
                "workers")
        workers += int(node.get("workers", 0))
        servers += int(node.get("servers", 0))
    return workers, servers


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


def _code(c: int) -> int:
    """An exit code; a process killed by signal s exits 128 + s."""
    return c if c > 0 else 128 - c


def run(command, n_workers: int, n_servers: int = 0, devices=None,
        backend=None) -> int:
    """Run ``n_workers`` copies of ``command``, beside a PS scheduler and
    ``n_servers`` servers when ``n_servers > 0``; the job's exit code.
    ``devices``: each rank's device, ``backend``: the process group's."""
    store_dir = tempfile.mkdtemp(prefix="hetu_run_")
    env = dict(os.environ, WORLD_SIZE=str(n_workers),
               HETU_NUM_WORKER=str(n_workers),
               HETU_INIT_METHOD="file://" + os.path.join(store_dir, "store"))
    if backend:
        env["HETU_BACKEND"] = backend
    procs, roles = [], []
    stopfile = os.path.join(store_dir, "ps_stop")
    try:
        if n_servers:
            from .ps import local_cluster as lc
            base = lc.ps_env(lc.free_port(), n_workers, n_servers)
            roles.append(("scheduler", lc.spawn_light_role("scheduler",
                                                           base)))
            for i in range(n_servers):
                roles.append((f"server {i}",
                              lc.spawn_light_server(i, base, stopfile)))
            env.update(base, DMLC_ROLE="worker")
        for rank in range(n_workers):
            renv = dict(env, RANK=str(rank), LOCAL_RANK=str(rank),
                        WORKER_ID=str(rank))
            if devices:
                renv["HETU_DEVICE"] = devices[rank]
            procs.append(subprocess.Popen(command, env=renv))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return _code(failed[0])
            if all(c == 0 for c in codes):
                return 0
            for name, p in roles:
                if p.poll() is not None:
                    print(f"hetu_tpu_torch.runner: the PS {name} exited "
                          f"with code {p.returncode} before the workers "
                          "were done", file=sys.stderr)
                    return _code(p.returncode) or 1
            time.sleep(0.05)
    finally:
        _stop(procs)
        if roles:
            from .ps import local_cluster as lc
            with open(stopfile, "w") as f:
                f.write("stop")
            lc.reap_light_procs([p for _, p in roles])
        shutil.rmtree(store_dir, ignore_errors=True)


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m hetu_tpu_torch.runner")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("-w", "--workers", type=int,
                       help="number of local worker processes")
    group.add_argument("-c", "--config",
                       help="cluster yaml (nodes: host/servers/workers)")
    parser.add_argument("--devices", default="",
                        help="each rank's device, comma-separated (default "
                             "cuda:LOCAL_RANK), e.g. cuda:0,cuda:0")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="the process group's backend (default NCCL on "
                             "a card, gloo on the CPU)")
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
    n, servers = ((args.workers, 0) if args.config is None
                  else parse_cluster(args.config))
    if n < 1:
        parser.error(f"need at least one worker, got {n}")
    devices = [d.strip() for d in args.devices.split(",") if d.strip()]
    if devices:
        if len(devices) != n:
            parser.error(f"--devices names {len(devices)} devices for {n} "
                         "workers")
        print("hetu_tpu_torch.runner: " + ", ".join(
            f"rank {r} -> {d}" for r, d in enumerate(devices)), flush=True)
    signal.signal(signal.SIGTERM, _terminated)
    return run(args.command, n, servers, devices, args.backend)


if __name__ == "__main__":
    sys.exit(main())
