"""Worker-side parameter-server client: a ``ctypes`` facade over the
native worker agent (counterpart of ``hetu_tpu/ps/client.py``).

The methods keep the reference C API's names (``InitTensor``,
``SparsePull``, ``SparsePush``, ``DDPushPull``, ``Wait``,
``BarrierWorker``, ...). Arrays cross as numpy buffers on the host. A
tensor on the card is copied to the host by the PS runtime
(``graph/ps_runtime.py``), never here: the client refuses one.

An RPC is asynchronous: ``Pull``, ``DDPushPull`` and the sparse forms
return at once, and ``Wait(node)`` blocks until every request on that tensor
has completed. The numpy buffers of a request are kept alive until then.
"""
from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

from ._build import build

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_long)

_INIT_TYPE = {"constant": 0, "uniform": 1, "normal": 2, "truncated_normal": 3}
_OPT_TYPE = {"sgd": 0, "momentum": 1, "nesterov": 2, "adagrad": 3, "adam": 4}


def load_lib() -> ctypes.CDLL:
    """The parameter server's library, built first if needed, with the
    return types of the entry points the client reads."""
    lib = ctypes.CDLL(build())
    lib.LastError.restype = ctypes.c_char_p
    lib.SetPushOpts.argtypes = [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                ctypes.c_float]
    lib.rank.restype = ctypes.c_int
    lib.nrank.restype = ctypes.c_int
    return lib


def _host(arr):
    if hasattr(arr, "asnumpy"):      # NDArray
        arr = arr.asnumpy()
    if getattr(arr, "is_cuda", False):
        raise TypeError("the PS client takes host arrays; copy a tensor on "
                        "the card to the host first (the PS runtime does)")
    return arr


def _as_f32(arr) -> np.ndarray:
    return np.ascontiguousarray(_host(arr), dtype=np.float32)


def _as_i64(arr) -> np.ndarray:
    return np.ascontiguousarray(_host(arr), dtype=np.int64)


class PSClient:
    """The worker agent of this process; one per process. ``Init`` reads
    the cluster from the ``DMLC_*`` environment (``ps/local_cluster.py``,
    ``runner.py``) and registers with the scheduler."""

    def __init__(self):
        self._lib = load_lib()
        self._lib.Init()
        self._check()
        # buffers of in-flight requests, by tensor id, kept until Wait
        self._staging: dict[int, list] = {}
        from . import _register_worker
        _register_worker(self)

    @classmethod
    def from_env(cls) -> "PSClient":
        return cls()

    def _check(self):
        err = self._lib.LastError()
        if err:
            raise RuntimeError(err.decode())

    def _stage(self, node: int, *arrays):
        self._staging.setdefault(node, []).extend(arrays)

    # -- lifecycle ----------------------------------------------------------
    def close(self, *, raise_on_error: bool | None = None):
        """Finalize the agent. A teardown error raises, except at
        interpreter shutdown or while another exception propagates (where
        it would hide the real one), and except under
        ``raise_on_error=False`` (``worker_finish``): there it is printed."""
        self._lib.Finalize()
        err = self._lib.LastError()
        if err:
            msg = f"PS Finalize failed: {err.decode()}"
            if raise_on_error is None:
                raise_on_error = (not sys.is_finalizing()
                                  and sys.exc_info()[0] is None)
            if raise_on_error:
                raise RuntimeError(msg)
            print(msg, file=sys.stderr)

    Finalize = close

    @property
    def rank(self) -> int:
        return self._lib.rank()

    @property
    def nrank(self) -> int:
        """The number of workers in the cluster."""
        return self._lib.nrank()

    def SetCommQuant(self, mode):
        """Quantize this worker's PS value payloads on the wire (the
        ``kQI8`` container: int8 rows with one f32 scale each); the server
        dequantizes and applies in f32. Falsy or ``"off"`` disables."""
        on = mode not in (0, False, None, "", "off")
        self._lib.SetCommQuant(ctypes.c_int(1 if on else 0))
        self._check()

    # -- tensor init --------------------------------------------------------
    def InitTensor(self, node, sparse, length, width, init_type, init_a,
                   init_b=1.0, seed=123, opt_type="sgd", lrs=(0.1,)):
        """Declare tensor ``node`` on its server and initialize it there.
        ``sparse``: 0 dense, 1 a 2-D table, 2 a cache table (versioned
        rows, for the bounded-staleness cache)."""
        if isinstance(init_type, str):
            init_type = _INIT_TYPE[init_type]
        if isinstance(opt_type, str):
            opt_type = _OPT_TYPE[opt_type]
        lrs_arr = np.asarray(lrs, dtype=np.float32)
        self._lib.InitTensor(
            ctypes.c_int(int(node)), ctypes.c_int(int(sparse)),
            ctypes.c_long(int(length)), ctypes.c_long(int(width)),
            ctypes.c_int(int(init_type)), ctypes.c_double(float(init_a)),
            ctypes.c_double(float(init_b)), ctypes.c_ulonglong(int(seed)),
            ctypes.c_int(int(opt_type)), lrs_arr.ctypes.data_as(_f32p),
            ctypes.c_int(len(lrs_arr)))
        self._check()

    def SetPushOpts(self, node, lr=-1.0, l2reg=0.0, weight_decay=0.0):
        """Carry ``[lr, l2reg, weight_decay]`` on this tensor's later pushes
        to its server-side optimizer (a schedule, l2, decoupled decay);
        ``lr < 0`` with no regularization clears them."""
        self._lib.SetPushOpts(ctypes.c_int(int(node)), ctypes.c_float(lr),
                              ctypes.c_float(l2reg),
                              ctypes.c_float(weight_decay))
        self._check()

    # -- dense --------------------------------------------------------------
    def Pull(self, node, out):
        """Fill ``out`` (numpy, in place) by ``Wait(node)``; returns it."""
        out = np.ascontiguousarray(out, dtype=np.float32)
        self._stage(node, out)
        self._lib.Pull(ctypes.c_int(node), out.ctypes.data_as(_f32p),
                       ctypes.c_long(out.size))
        return out

    def DDPushPull(self, node, grad, out):
        g = _as_f32(grad)
        out = np.ascontiguousarray(out, dtype=np.float32)
        self._stage(node, g, out)
        self._lib.DDPushPull(ctypes.c_int(node), g.ctypes.data_as(_f32p),
                             out.ctypes.data_as(_f32p), ctypes.c_long(g.size))
        return out

    def Assign(self, node, value):
        """Overwrite a dense tensor, past the server's optimizer."""
        v = _as_f32(value)
        self._lib.AssignDense(ctypes.c_int(node), v.ctypes.data_as(_f32p),
                              ctypes.c_long(v.size))
        self._check()

    def SparseAssign(self, node, indices, values):
        """Overwrite rows of a table, past the server's optimizer."""
        idx, vals = _as_i64(indices).ravel(), _as_f32(values)
        self._lib.AssignRows(ctypes.c_int(node), idx.ctypes.data_as(_i64p),
                             vals.ctypes.data_as(_f32p),
                             ctypes.c_long(idx.size))
        self._check()

    # -- sparse -------------------------------------------------------------
    def SparsePush(self, node, indices, values):
        idx, vals = _as_i64(indices).ravel(), _as_f32(values)
        self._stage(node, idx, vals)
        self._lib.SparsePush(ctypes.c_int(node), idx.ctypes.data_as(_i64p),
                             vals.ctypes.data_as(_f32p), ctypes.c_long(idx.size))

    def SparsePull(self, node, indices, out):
        idx = _as_i64(indices).ravel()
        out = np.ascontiguousarray(out, dtype=np.float32)
        self._stage(node, idx, out)
        self._lib.SparsePull(ctypes.c_int(node), idx.ctypes.data_as(_i64p),
                             out.ctypes.data_as(_f32p), ctypes.c_long(idx.size))
        return out

    # -- control ------------------------------------------------------------
    def Wait(self, node):
        node = int(getattr(node, "value", node))
        self._lib.Wait(ctypes.c_int(node))
        self._staging.pop(node, None)
        self._check()

    def BarrierWorker(self):
        self._lib.BarrierWorker()
        self._check()

    def SaveParam(self, node, directory):
        os.makedirs(directory, exist_ok=True)
        self._lib.SaveParam(ctypes.c_int(node), str(directory).encode())
        self._check()

    def LoadParam(self, node, directory):
        self._lib.LoadParam(ctypes.c_int(node), str(directory).encode())
        self._check()
