"""The parameter server (counterpart of ``hetu_tpu/ps``): a host-resident
key-value store with server-side optimizers for the sparse embedding
tables of the PS and Hybrid comm modes, and the bounded-staleness
embedding cache (``cstable.py``). The C++ core is the port's own copy under
``csrc/ps`` and ``csrc/cache``, built by ``_build.py``; this package holds
the Python client, the role entry points and the local launcher.

A worker process holds one agent (``worker_init``), which every executor
of the process shares; ``worker_finish`` drains the executors' PS traffic
and closes it.
"""
from __future__ import annotations

import weakref

_NOT_READY = ("The parameter-server worker is not initialized: start the "
              "cluster (hetu_tpu_torch.runner with servers:, or "
              "ps.local_cluster) and call worker_init() first.")

_worker = None
_runtimes: "weakref.WeakSet" = weakref.WeakSet()


def _register_runtime(rt):
    """A ``PSRuntime`` registers here so ``worker_finish`` drains it."""
    _runtimes.add(rt)


def _register_worker(worker):
    global _worker
    _worker = worker


def scheduler_init():
    from .server import start_scheduler_from_env
    start_scheduler_from_env()


def scheduler_finish():
    from .server import stop_scheduler
    stop_scheduler()


def server_init():
    from .server import start_server_from_env
    start_server_from_env()


def server_finish():
    from .server import stop_server
    stop_server()


def worker_init():
    """Start this process's worker agent from the ``DMLC_*`` environment."""
    from .client import PSClient
    PSClient.from_env()


def worker_finish():
    """Drain and stop every live runtime's PS traffic, then close the
    agent. The streams are drained before the sockets close: a request in
    flight at teardown would leave a thread blocked in ``recv``."""
    global _worker
    for rt in list(_runtimes):
        try:
            rt.drain()
            rt.shutdown()
        except Exception:  # noqa: BLE001 — teardown goes on for the others
            pass
    if _worker is not None:
        w, _worker = _worker, None
        # a socket error in the teardown window must not turn a finished
        # run into a failed one: it is printed
        w.close(raise_on_error=False)


def get_worker_communicate():
    if _worker is None:
        raise RuntimeError(_NOT_READY)
    return _worker
