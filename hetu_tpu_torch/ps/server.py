"""Scheduler and server role entry points over the native library
(counterpart of ``hetu_tpu/ps/server.py``). The role and the cluster come
from the ``DMLC_*`` environment, under the reference's names
(``DMLC_ROLE``, ``DMLC_PS_ROOT_URI``/``PORT``, ``DMLC_NUM_WORKER``/
``SERVER``). A local cluster starts these roles through
``_light_role.py`` instead, which loads no Python package."""
from __future__ import annotations

import ctypes

from ._build import build

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
        _lib.LastError.restype = ctypes.c_char_p
    return _lib


def _check(lib):
    err = lib.LastError()
    if err:
        raise RuntimeError(err.decode())


def start_scheduler_from_env():
    lib = _load()
    lib.Init()
    _check(lib)


def scheduler_wait():
    """Block until every node has checked out; a window with no progress
    past ``DMLC_PS_SCHED_WAIT_TIMEOUT_MS`` raises, naming the ranks that
    never checked out."""
    lib = _load()
    lib.SchedulerWait()
    _check(lib)


def stop_scheduler():
    _load().Finalize()


def start_server_from_env():
    lib = _load()
    lib.Init()
    _check(lib)
    lib.StartServer()
    _check(lib)


def stop_server():
    _load().Finalize()
