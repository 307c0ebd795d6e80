"""A parameter-server cluster on this machine: a scheduler and N servers as
light processes, with the calling process as worker 0 (counterpart of
``hetu_tpu/ps/local_cluster.py``, without its high-availability stack,
which comes with slice 9).

    with local_cluster(n_servers=1):
        ex = ht.Executor(..., comm_mode="Hybrid")
        ...

The scheduler takes a free port of ``127.0.0.1``; each server binds a
port the system assigns and registers it with the scheduler. A cluster
that has not come up within ``startup_s`` seconds raises, naming the role
that failed; the processes are always reaped on the way out.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

from ._build import build

_LIGHT_MAIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_light_role.py")


def ps_env(port: int, n_workers: int, n_servers: int,
           host: str = "127.0.0.1") -> dict:
    """The ``DMLC_*`` variables every role of one cluster shares."""
    return {"DMLC_PS_ROOT_URI": host,
            "DMLC_PS_ROOT_PORT": str(port),
            "DMLC_NUM_WORKER": str(n_workers),
            "DMLC_NUM_SERVER": str(n_servers)}


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn_light_role(role: str, env_extra: dict) -> subprocess.Popen:
    """Start a scheduler or a server as a light process: ``_light_role.py``
    run by file path, which loads the built library and no package."""
    env = os.environ.copy()
    env.update(env_extra)
    env["DMLC_ROLE"] = role
    env["HETU_PS_LIB"] = build()
    return subprocess.Popen([sys.executable, _LIGHT_MAIN], env=env)


def spawn_light_server(idx: int, base_env: dict, stopfile: str,
                       port: str = "0") -> subprocess.Popen:
    """Start server ``idx``; it stops when ``stopfile`` appears. ``port``
    ``"0"`` binds a port the system assigns, registered with the
    scheduler."""
    return spawn_light_role("server", {**base_env, "SERVER_ID": str(idx),
                                       "DMLC_PS_SERVER_URI": "127.0.0.1",
                                       "DMLC_PS_SERVER_PORT": port,
                                       "HETU_PS_STOPFILE": stopfile})


def reap_light_procs(procs, timeout: float = 15.0):
    """Wait for the processes, within one deadline for all of them; kill
    and wait for those still running after it."""
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _role_name(i: int) -> str:
    return "scheduler" if i == 0 else f"server {i - 1}"


def _start_worker(procs, startup_s: float):
    """Start this process's worker agent (``worker_init``) while watching
    the cluster's processes (``procs``: the scheduler, then the servers).
    Raises if one of them exits first, or if the agent has not registered
    within ``startup_s`` seconds, naming the role; the caller reaps the
    processes."""
    from . import worker_init
    done = threading.Event()
    error: list = []

    def _init():
        try:
            worker_init()
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            error.append(e)
        done.set()

    t = threading.Thread(target=_init, name="hetu-ps-worker-init",
                         daemon=True)
    t.start()
    deadline = time.monotonic() + startup_s
    while not done.wait(0.05):
        dead = [(_role_name(i), p.returncode) for i, p in enumerate(procs)
                if p.poll() is not None]
        late = time.monotonic() > deadline
        if dead or late:
            # the agent is blocked on its registration. Stop the servers,
            # give the agent a moment to reach the scheduler, then stop the
            # scheduler: its closed socket ends the registration at once
            # (an agent still retrying its connection gives up in 60 s)
            for p in procs[1:]:
                if p.poll() is None:
                    p.kill()
            done.wait(2.0)
            if procs[0].poll() is None:
                procs[0].kill()
            done.wait(65.0)
            if dead:
                raise RuntimeError(
                    "the PS cluster did not come up: "
                    + ", ".join(f"{r} exited with code {c}" for r, c in dead))
            raise RuntimeError(
                f"the PS cluster did not come up within {startup_s:g} s: "
                "the worker could not register with the scheduler and "
                f"{len(procs) - 1} server(s)")
    if error:
        raise error[0]


@contextlib.contextmanager
def local_cluster(n_servers: int = 1, n_workers: int = 1, port: int = None,
                  startup_s: float = 60.0):
    """Start a scheduler and ``n_servers`` servers, make this process
    worker 0, yield the scheduler's port; on the way out close the worker
    agent, stop the servers and reap every process.

    With ``n_workers == 1`` the worker agent is started here, within
    ``startup_s`` seconds. With more, the other workers are the caller's
    to start (with ``DMLC_ROLE=worker`` and their ``WORKER_ID``); the
    agent of this process then starts with the first executor of comm
    mode PS or Hybrid, and registers when all of them have."""
    from . import worker_finish
    port = port or free_port()
    stopdir = tempfile.mkdtemp(prefix="hetu_ps_stop_")
    stopfile = os.path.join(stopdir, "stop")
    base = ps_env(port, n_workers, n_servers)
    saved = {k: os.environ.get(k) for k in
             list(base) + ["DMLC_ROLE", "WORKER_ID"]}
    procs = []
    try:
        procs.append(spawn_light_role("scheduler", base))
        for i in range(n_servers):
            procs.append(spawn_light_server(i, base, stopfile))
        os.environ.update(base)
        os.environ.update({"DMLC_ROLE": "worker", "WORKER_ID": "0"})
        if n_workers == 1:
            _start_worker(procs, startup_s)
        yield port
    finally:
        try:
            worker_finish()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            with open(stopfile, "w") as f:
                f.write("stop")
            reap_light_procs(procs)
            shutil.rmtree(stopdir, ignore_errors=True)
