"""CacheSparseTable: the worker-side embedding cache with bounded
staleness (counterpart of ``hetu_tpu/cstable.py``).

The cache holds up to ``limit`` rows of a PS table (``InitTensor`` kind 2,
versioned rows) and serves a batch's rows from it, pulling a row from the
server when it is missing or more than ``bound`` versions stale; pushed
gradients update the cached rows and reach the server within ``bound``
updates. The policy (``LRU``, ``LFU``, ``LFUOpt``) chooses what to evict.
The store is the C++ cache of ``csrc/cache`` in the parameter server's
library, through ``ctypes``. With the quantized PS wire on, the rows are
dequantized before they reach the cache, so cached rows are float32.
"""
from __future__ import annotations

import ctypes
import json

import numpy as np

from .ps._build import build

_POLICY = {"lru": 0, "lfu": 1, "lfuopt": 2}

_u64p = ctypes.POINTER(ctypes.c_ulonglong)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_long)

_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
        _lib.CacheCreate.restype = ctypes.c_void_p
        _lib.CacheCreate.argtypes = [ctypes.c_int, ctypes.c_long,
                                     ctypes.c_long, ctypes.c_long,
                                     ctypes.c_int]
        for name in ("CacheEmbeddingLookup", "CacheEmbeddingUpdate",
                     "CacheEmbeddingPushPull", "CacheSize", "CacheLimit",
                     "CacheKeys"):
            getattr(_lib, name).restype = ctypes.c_long
        for name in ("CacheLastError", "CachePerfJson", "CacheRepr"):
            getattr(_lib, name).restype = ctypes.c_char_p
        for name in ("CacheDestroy", "CacheSetBounds", "CacheBypass",
                     "CachePerfEnabled", "CacheInsertOne"):
            getattr(_lib, name).restype = None
        _lib.CacheWait.restype = ctypes.c_int
        _lib.CacheCount.restype = ctypes.c_int
        _lib.CacheLookupOne.restype = ctypes.c_int
        for name in ("CacheDestroy", "CacheSetBounds", "CacheBypass",
                     "CachePerfEnabled", "CacheWait", "CacheSize",
                     "CacheLimit", "CachePerfJson", "CacheRepr"):
            fn = getattr(_lib, name)
            fn.argtypes = ([ctypes.c_void_p] +
                           {"CacheSetBounds": [ctypes.c_long, ctypes.c_long],
                            "CacheBypass": [ctypes.c_int],
                            "CachePerfEnabled": [ctypes.c_int],
                            "CacheWait": [ctypes.c_long]}.get(name, []))
    return _lib


class _Wait:
    """Async wait handle (reference wait_t futures, cstable.py:47)."""

    def __init__(self, lib, handle, ticket, keepalive):
        self._lib = lib
        self._handle = handle
        self._ticket = ticket
        # OUTPUT buffers must outlive the async op (results land in them);
        # input keys/grads are copied at enqueue in the C++ layer, so a
        # discarded wait handle is safe for fire-and-forget updates
        self._keepalive = keepalive

    def wait(self):
        if self._lib.CacheWait(ctypes.c_void_p(self._handle),
                               ctypes.c_long(self._ticket)) != 0:
            raise RuntimeError(self._lib.CacheLastError().decode())
        self._keepalive = None


def _keys_arr(keys):
    if hasattr(keys, "asnumpy"):
        keys = keys.asnumpy()
    arr = np.asarray(keys)
    if arr.dtype != np.uint64:
        arr = arr.astype(np.uint64)
    return np.ascontiguousarray(arr).ravel()


def _f32_arr(x):
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return np.ascontiguousarray(x, dtype=np.float32)


class CacheSparseTable:
    """Bounded-staleness cached view of a PS cache-table parameter.

    Args mirror the reference (cstable.py:20): limit = max cached lines,
    (length, width) = full table shape, node_id = PS tensor id, policy in
    {LRU, LFU, LFUOpt}, bound = staleness bound for both pull and push.
    """

    def __init__(self, limit, length, width, node_id, policy="LRU",
                 bound=100):
        from . import ps as ps_pkg
        comm = ps_pkg.get_worker_communicate()  # ensures worker Init ran
        lib = _load()
        self._lib = lib
        self._width = int(width)
        self._length = int(length)
        self._node_id = int(node_id)
        self._handle = lib.CacheCreate(
            ctypes.c_int(_POLICY[policy.lower()]), ctypes.c_long(int(limit)),
            ctypes.c_long(int(length)), ctypes.c_long(int(width)),
            ctypes.c_int(int(node_id)))
        if not self._handle:
            raise RuntimeError(lib.CacheLastError().decode())
        lib.CacheSetBounds(ctypes.c_void_p(self._handle),
                           ctypes.c_long(int(bound)),
                           ctypes.c_long(int(bound)))
        comm.BarrierWorker()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.CacheDestroy(ctypes.c_void_p(self._handle))
            self._handle = None

    # -- main async API ----------------------------------------------------
    def embedding_lookup(self, keys, dest, sync=False):
        k = _keys_arr(keys)
        d = _f32_arr(dest)
        assert d.shape == (k.size, self._width), (d.shape, k.size, self._width)
        ticket = self._lib.CacheEmbeddingLookup(
            ctypes.c_void_p(self._handle), k.ctypes.data_as(_u64p),
            ctypes.c_long(k.size), d.ctypes.data_as(_f32p))
        wait = _Wait(self._lib, self._handle, ticket, (d,))
        if sync:
            wait.wait()
            return d
        return wait

    def embedding_update(self, keys, grads, sync=False):
        k = _keys_arr(keys)
        g = _f32_arr(grads)
        assert g.shape == (k.size, self._width)
        ticket = self._lib.CacheEmbeddingUpdate(
            ctypes.c_void_p(self._handle), k.ctypes.data_as(_u64p),
            g.ctypes.data_as(_f32p), ctypes.c_long(k.size))
        wait = _Wait(self._lib, self._handle, ticket, None)
        if sync:
            wait.wait()
            return None
        return wait

    def embedding_push_pull(self, pullkeys, dest, pushkeys, grads,
                            sync=False):
        pk = _keys_arr(pullkeys)
        d = _f32_arr(dest)
        uk = _keys_arr(pushkeys)
        g = _f32_arr(grads)
        assert d.shape == (pk.size, self._width)
        assert g.shape == (uk.size, self._width)
        ticket = self._lib.CacheEmbeddingPushPull(
            ctypes.c_void_p(self._handle), pk.ctypes.data_as(_u64p),
            ctypes.c_long(pk.size), d.ctypes.data_as(_f32p),
            uk.ctypes.data_as(_u64p), g.ctypes.data_as(_f32p),
            ctypes.c_long(uk.size))
        wait = _Wait(self._lib, self._handle, ticket, (d,))
        if sync:
            wait.wait()
            return d
        return wait

    # -- properties / config ----------------------------------------------
    @property
    def width(self):
        return self._width

    @property
    def limit(self):
        return self._lib.CacheLimit(ctypes.c_void_p(self._handle))

    def __len__(self):
        return self._lib.CacheSize(ctypes.c_void_p(self._handle))

    def bypass(self):
        self._lib.CacheBypass(ctypes.c_void_p(self._handle), 1)

    def undobypass(self):
        self._lib.CacheBypass(ctypes.c_void_p(self._handle), 0)

    def perf_enabled(self, enable=True):
        """Arm the per-batch perf log behind :attr:`perf`."""
        self._lib.CachePerfEnabled(ctypes.c_void_p(self._handle),
                                   int(bool(enable)))

    @property
    def perf(self):
        return json.loads(
            self._lib.CachePerfJson(ctypes.c_void_p(self._handle)).decode())

    # -- perf helpers (reference cstable.py:165-187) -----------------------
    def overall_miss_rate(self, include_cold_start=False):
        perf = self.perf
        if not include_cold_start:
            perf = [x for x in perf if x["is_full"]]
        pull = [x for x in perf if x["type"] == "Pull"]
        if not pull:
            return -1
        return (sum(x["num_miss"] for x in pull)
                / max(1, sum(x["num_unique"] for x in pull)))

    def overall_data_rate(self, include_cold_start=False):
        perf = self.perf
        if not include_cold_start:
            perf = [x for x in perf if x["is_full"]]
        if not perf:
            return -1
        return (sum(x["num_transfered"] for x in perf)
                / max(1, sum(x["num_all"] for x in perf)))

    # -- single-key debug API ----------------------------------------------
    def lookup(self, key):
        out = np.zeros(self._width, np.float32)
        ver = ctypes.c_long()
        ups = ctypes.c_long()
        found = self._lib.CacheLookupOne(
            ctypes.c_void_p(self._handle), ctypes.c_ulonglong(int(key)),
            out.ctypes.data_as(_f32p), ctypes.byref(ver), ctypes.byref(ups))
        if not found:
            return None
        return {"key": int(key), "data": out, "version": ver.value,
                "updates": ups.value}

    def count(self, key):
        return self._lib.CacheCount(ctypes.c_void_p(self._handle),
                                    ctypes.c_ulonglong(int(key)))

    def insert(self, key, embedding):
        e = _f32_arr(embedding).ravel()
        assert e.size == self._width
        self._lib.CacheInsertOne(ctypes.c_void_p(self._handle),
                                 ctypes.c_ulonglong(int(key)),
                                 e.ctypes.data_as(_f32p))

    def keys(self):
        cap = self._lib.CacheSize(ctypes.c_void_p(self._handle)) + 16
        out = np.zeros(cap, np.uint64)
        n = self._lib.CacheKeys(ctypes.c_void_p(self._handle),
                                out.ctypes.data_as(_u64p), ctypes.c_long(cap))
        return out[:min(n, cap)].tolist()

    def __repr__(self):
        return self._lib.CacheRepr(ctypes.c_void_p(self._handle)).decode()
