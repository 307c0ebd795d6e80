"""Device contexts and array handles (counterpart of ``hetu_tpu/ndarray.py``).

A ``DLContext`` names a device (``cpu(0)``, ``gpu(i)``); ``torch_device()``
resolves it to a ``torch.device``. ``gpu(i)`` is ``cuda:i``; ``tpu(i)`` is
kept as an alias of ``gpu(i)`` so model code written against ``hetu_tpu``
runs unchanged. An ``NDArray`` is a thin handle over a ``torch.Tensor``;
an ``ND_Sparse_Array`` is a COO matrix that also holds its CSR form and
that of its transpose (``CSRMatrix``), built once on its device.
``IndexedSlices`` arrive with the CTR slice.
"""
from __future__ import annotations

import numpy as np
import torch


class DLContext:
    """A device placement tag: ``cpu(0)`` or ``gpu(3)``."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "tpu":  # compat alias: hetu_tpu model code says tpu
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"device_type must be cpu or gpu, got "
                             f"{device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, DLContext)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(dev_id: int = 0) -> DLContext:
    return DLContext("cpu", dev_id)


def gpu(dev_id: int = 0) -> DLContext:
    return DLContext("gpu", dev_id)


tpu = gpu


def is_gpu_ctx(ctx) -> bool:
    """True when ctx is an accelerator (reference ndarray.py:106)."""
    return isinstance(ctx, DLContext) and ctx.device_type == "gpu"


is_tpu_ctx = is_gpu_ctx


def resolve_device(device=None) -> torch.device:
    """The device of a functional entry point (the models, ``interop``):
    ``None`` is ``cuda:0``; a ``DLContext``, a string or a
    ``torch.device`` names another. A CUDA device without CUDA raises
    rather than run on the CPU."""
    if device is None:
        dev = torch.device("cuda", 0)
    elif isinstance(device, DLContext):
        dev = device.torch_device()
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the call runs on {dev} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


class NDArray:
    """Thin handle over a ``torch.Tensor`` with the reference's surface."""

    __slots__ = ("handle", "ctx")

    def __init__(self, handle: torch.Tensor, ctx: DLContext | None = None):
        self.handle = handle
        self.ctx = ctx

    @property
    def shape(self):
        return tuple(self.handle.shape)

    @property
    def dtype(self):
        return np.dtype(str(self.handle.dtype).replace("torch.", ""))

    def asnumpy(self) -> np.ndarray:
        """The value on the host; bf16 comes back as float32 (numpy has no
        bfloat16)."""
        h = self.handle.detach()
        if h.dtype == torch.bfloat16:
            h = h.float()
        return h.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.asnumpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return f"NDArray(shape={self.shape}, dtype={self.dtype}, ctx={self.ctx})"


def array(arr, ctx: DLContext | None = None, dtype=None) -> NDArray:
    """Create an NDArray on ``ctx`` (reference ndarray.py:419 ``array``);
    floating inputs become float32, as in ``hetu_tpu``."""
    if isinstance(arr, NDArray):
        arr = arr.asnumpy()
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    if dtype is None and np.issubdtype(np.asarray(arr).dtype, np.floating):
        dtype = np.float32
    np_arr = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
    dev = ctx.torch_device() if ctx is not None else torch.device("cpu")
    return NDArray(torch.from_numpy(np_arr).to(dev), ctx)


def empty(shape, ctx: DLContext | None = None, dtype=np.float32) -> NDArray:
    """Allocate an array (zero-filled, as ``hetu_tpu.empty`` is)."""
    return array(np.zeros(tuple(shape), dtype), ctx=ctx, dtype=dtype)


class CSRMatrix:
    """One CSR form of a sparse matrix on one device: ``rowptr`` (nrow + 1)
    int32, ``col`` (nnz) int32 and ``val`` (nnz) float32, the entries of
    each row in the order of the COO input (a stable sort by row).
    ``plans`` caches the sparse products' work splits by kind, filled at
    their first call (``kernels/csr_spmm.py:chunk_plan``)."""

    __slots__ = ("rowptr", "col", "val", "nrow", "ncol", "plans")

    def __init__(self, rowptr, col, val, nrow: int, ncol: int):
        self.rowptr, self.col, self.val = rowptr, col, val
        self.nrow, self.ncol = int(nrow), int(ncol)
        self.plans = {}

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @classmethod
    def from_coo(cls, values, rows, cols, nrow: int, ncol: int):
        """CSR of the COO (values, rows, cols), a stable sort by row, on
        their device: duplicates stay separate entries in input order."""
        order = torch.sort(rows, stable=True).indices
        rowptr = torch.zeros(nrow + 1, dtype=torch.int32, device=rows.device)
        rowptr[1:] = torch.cumsum(
            torch.bincount(rows.long(), minlength=nrow), 0)
        return cls(rowptr, cols[order].contiguous(),
                   values[order].contiguous(), nrow, ncol)


class ND_Sparse_Array:
    """A sparse matrix fed to ``csrmv_op``/``csrmm_op`` (reference
    ``hetu_tpu/ndarray.py:173``): the COO fields ``data`` (f32), ``row``
    and ``col`` (int32), ``nrow`` and ``ncol``, as tensors on one device,
    plus ``csr`` (a stable sort by row) and ``csr_t`` (the transpose's, a
    stable sort by col), built once here. Duplicates, unsorted entries,
    empty rows and nnz = 0 are legal. ``to(device)`` keeps one copy per
    other device, so an adjacency fed every step is uploaded once."""

    __slots__ = ("data", "row", "col", "nrow", "ncol", "ctx", "csr",
                 "csr_t", "_copies")

    def __init__(self, data, row, col, nrow, ncol, ctx=None):
        self.data, self.row, self.col = data, row, col
        self.nrow, self.ncol = int(nrow), int(ncol)
        self.ctx = ctx
        nnz = int(data.shape[0])
        if not (row.shape == col.shape == (nnz,)):
            raise ValueError(f"values, rows and cols must be 1-D of one "
                             f"length, got {tuple(data.shape)}, "
                             f"{tuple(row.shape)}, {tuple(col.shape)}")
        if nnz and (int(row.min()) < 0 or int(row.max()) >= self.nrow
                    or int(col.min()) < 0 or int(col.max()) >= self.ncol):
            raise ValueError(f"an index lies outside the {self.nrow} x "
                             f"{self.ncol} matrix")
        self.csr = CSRMatrix.from_coo(data, row, col, self.nrow, self.ncol)
        self.csr_t = CSRMatrix.from_coo(data, col, row, self.ncol, self.nrow)
        self._copies = {}

    @property
    def shape(self):
        return (self.nrow, self.ncol)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "ND_Sparse_Array":
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        copy = self._copies.get(device)
        if copy is None:
            copy = self._copies[device] = ND_Sparse_Array(
                self.data.to(device), self.row.to(device),
                self.col.to(device), self.nrow, self.ncol)
        return copy

    def __repr__(self):
        return (f"ND_Sparse_Array(shape={self.shape}, "
                f"nnz={int(self.data.shape[0])}, device={self.device})")


def sparse_array(values, indices, shape, ctx=None) -> ND_Sparse_Array:
    """A sparse matrix from COO ``(values, (row, col))`` of ``shape``
    (reference ``hetu_tpu/ndarray.py:190``), on ``ctx``: ``None`` is
    ``cuda:0``, as for every entry point of the port."""
    row, col = indices
    dev = resolve_device(ctx)

    def put(a, dtype):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.detach().to(dev, dtype).contiguous()

    return ND_Sparse_Array(put(values, torch.float32), put(row, torch.int32),
                           put(col, torch.int32), int(shape[0]),
                           int(shape[1]), ctx)
