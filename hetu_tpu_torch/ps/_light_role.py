"""A scheduler or server process, run by file path and never imported
(counterpart of ``hetu_tpu/ps/_light_main.py``).

Both roles are C++ loops over TCP that need ``ctypes`` and the built
library, nothing else: run as ``python .../_light_role.py``, a role
starts in the time of an interpreter start and a ``dlopen``, without
importing torch or the package.

Environment: ``HETU_PS_LIB`` is the built library (the parent has built
it); ``DMLC_ROLE`` is ``scheduler`` (Init, wait for every node to check
out, Finalize) or ``server`` (Init, StartServer, wait for the file
``HETU_PS_STOPFILE`` to appear, Finalize); the cluster comes from the
other ``DMLC_*`` variables.
"""
import ctypes
import os
import sys
import time


def main():
    lib = ctypes.CDLL(os.environ["HETU_PS_LIB"])
    lib.LastError.restype = ctypes.c_char_p
    lib.Init()
    err = lib.LastError()
    if err:
        raise RuntimeError(err.decode())
    role = os.environ["DMLC_ROLE"]
    if role == "scheduler":
        lib.SchedulerWait()
        # the wait is bounded (DMLC_PS_SCHED_WAIT_TIMEOUT_MS): on a timeout
        # the library names the ranks that never checked out
        err = lib.LastError()
        lib.Finalize()
        if err:
            print(f"[hetu ps scheduler] {err.decode()}", file=sys.stderr)
            return 1
    elif role == "server":
        lib.StartServer()
        err = lib.LastError()
        if err:
            raise RuntimeError(err.decode())
        stopfile = os.environ["HETU_PS_STOPFILE"]
        while not os.path.exists(stopfile):
            time.sleep(0.05)
        lib.Finalize()
    else:
        raise SystemExit(f"unsupported role for the light launcher: {role!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
