"""Build the parameter server's C++ library (``csrc/ps``, ``csrc/cache``)
with ``g++`` into ``csrc/build/libhetu_ps-<hash>.so``.

The server, scheduler, worker agent and embedding cache are host code
(C++17, no dependency past the standard library), one shared library
loaded with ``ctypes``. The hash covers every source and header of the
two directories and the flags, so an edited file rebuilds and an
unchanged tree is reused. Several processes may build at once (test
workers, a cluster's roles): the build holds a file lock in the build
directory, compiles to a temporary name and moves it into place, so no
process loads a half-written library. A missing ``g++`` or a failed
compile raises with the compiler's stderr; nothing falls back.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

# the translation units; capi.cc includes every header of csrc/ps, and the
# cache shares the worker agent's process globals, so both link into one
# library
SOURCES = ("ps/capi.cc", "cache/cache_capi.cc")
HEADERS = ("ps/net.h", "ps/store.h", "ps/server.h", "ps/scheduler.h",
           "ps/worker.h", "ps/ring.h", "ps/chaos.h", "cache/cache.h")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")


class PSBuildError(RuntimeError):
    """``g++`` is missing or refused the parameter server's sources."""


def library_path() -> str:
    """The built library's path: its hash covers the sources, the headers
    and the flags."""
    digest = hashlib.sha256()
    for rel in SOURCES + HEADERS:
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhetu_ps-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, built first if it is not there yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise PSBuildError("g++ not found on PATH: the parameter server of "
                           "hetu_tpu_torch is built from its C++ sources")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libhetu_ps.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):      # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-I", CSRC, "-o", tmp,
               *(os.path.join(CSRC, s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise PSBuildError(
                f"g++ failed on the parameter server (exit "
                f"{proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
                f"{proc.stdout}")
        os.replace(tmp, out)
    return out
