"""Build the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles alone into
``csrc/build/<name>-<hash>.so``, where the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and an unchanged one is reused. The
build runs at first use (or from :func:`build_all`, which starts one
``nvcc`` per source, all at once). A missing ``nvcc`` or a failed build
raises with nvcc's stderr; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
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


def headers() -> list[str]:
    """The ``csrc/*.cuh`` headers a source may include."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def library_path(name: str) -> str:
    """The built library's path: its hash covers the source, every header
    of ``csrc/`` and the flags."""
    digest = hashlib.sha256()
    for path in [_source(name)] + [os.path.join(CSRC, h) for h in headers()]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
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


# the SASS instructions resources() counts: the tensor cores' (wgmma,
# mma.sync) and cp.async's
SASS_OPS = ("HGMMA", "HMMA", "LDGSTS")


def resources(name: str) -> list[dict]:
    """Compile ``csrc/<name>.cu`` once more, with ``-Xptxas -v``, into a
    temporary directory (not the build directory) and read back, per
    kernel: ptxas's registers, spill bytes and static shared memory, and
    the count of each of :data:`SASS_OPS` in its SASS
    (``cuobjdump -sass``)."""
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, name + ".so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                               _source(name)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n"
                                   f"{proc.stderr}{proc.stdout}")
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
            capture_output=True, text=True, check=True).stdout
    return read_resources(proc.stdout + proc.stderr, sass)


def read_resources(ptxas: str, sass: str) -> list[dict]:
    """Per kernel, in the order ptxas compiled them: its registers, spill
    bytes and static shared memory from ptxas's ``-v`` report, and the
    count of each of :data:`SASS_OPS` in ``cuobjdump -sass``'s listing."""
    kernels, fn = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernels.setdefault(m.group(1), {"kernel": m.group(1)})
            continue
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pattern, line)
            if m and fn is not None:
                fn[key] = int(m.group(1))
    fn = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = kernels.setdefault(m.group(1), {"kernel": m.group(1)})
            fn.update({op: 0 for op in SASS_OPS})
        elif fn is not None:
            for op in SASS_OPS:
                fn[op] += re.search(rf"\b{op}\b", line) is not None
    filt = shutil.which("c++filt")
    if filt and kernels:
        names = subprocess.run([filt], input="\n".join(kernels),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for name, k in zip(names, kernels.values()):
            k["kernel"] = name
    return list(kernels.values())
