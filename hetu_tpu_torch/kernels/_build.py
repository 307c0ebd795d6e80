"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles alone into
``csrc/build/<name>-<hash>.so``, where the hash covers the source and the
flags, so an edited source rebuilds and an unchanged one is reused. The
build runs at first use (or from :func:`build_all`, which starts one
``nvcc`` per source, all at once). A missing ``nvcc`` or a failed build
raises with nvcc's stderr; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")

# -fmad=false: the kernels round after every multiply, where the plain
# PyTorch versions do, so the two agree to the last bit where the
# arithmetic allows it (the loops are memory-bound; FMA buys nothing)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises :class:`KernelBuildError` if neither has it."""
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin")
    path = os.environ.get("PATH", "") + os.pathsep + cuda_bin
    nvcc = shutil.which("nvcc", path=path)
    if nvcc is None:
        raise KernelBuildError(
            f"nvcc not found on PATH or in {cuda_bin}: the CUDA kernels of "
            "hetu_tpu_torch are built from source and need the CUDA toolkit")
    return nvcc


def _source(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def library_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(nvcc: str, name: str):
    """Start nvcc for one source; returns (final path, tmp path, process) or
    (path, None, None) when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp, proc) -> str:
    if proc is None:
        return out
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stderr}{stdout}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` in parallel; returns ``{name: .so path}``."""
    nvcc = find_nvcc()
    started = [(name, *_start(nvcc, name)) for name in sources()]
    return {name: _finish(name, out, tmp, proc)
            for name, out, tmp, proc in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _finish(name, *_start(find_nvcc(), name))
            lib = _libs[name] = ctypes.CDLL(out)
        return lib
