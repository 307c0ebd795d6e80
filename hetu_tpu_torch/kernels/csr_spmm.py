"""CSR sparse x dense products: hand-written CUDA for Hopper, in
``csrc/csr_spmm.cu`` (counterpart of ``hetu_tpu/kernels/csr_spmm.py``).

``csr_spmm`` replaces ``hetu_tpu/kernels/csr_spmm.py:_spmm_pallas`` (body
``_spmm_kernel``) and ``csr_spmv`` replaces ``_spmv_pallas``. They serve
``csrmm_op``/``csrmv_op`` (``graph/ops/matmul.py``) and through them
``distgcn_15d_op``, forward and backward.

Both take one CSR form (``ndarray.CSRMatrix``) of a sparse matrix A and
compute ``Z[r] = sum_j val_j * B[col_j]`` over row r's entries in CSR
order, with one float32 accumulator per output element, each product
rounded before it is added. The plain versions below sum in that same
order (for k = 0, 1, ...: every row longer than k adds its k-th entry), in
elementwise float32 with no atomics (``index_add_``), no library sparse
product and no matmul, so kernel and plain version agree bit for bit on
the card. ``_spmm_xla``'s ``segment_sum`` sums in another order; the CPU
tests hold the plain versions against it by allclose and relative L2.

Bound on an H100 SXM (3.35 TB/s): bytes. Reading each B row once, the
least for Z = A·B is ``8·nnz + 4·(nrow + 1) + 4·K·F + 4·nrow·F`` bytes;
the 2·nnz·F flops are negligible. Each output row belongs to one warp
(spmm) or one thread (spmv), so there are no atomics and the result does
not depend on scheduling; a row of high degree runs serially on one SM.

``matmat``/``matvec`` are ``torch.autograd.Function`` products: the
gradient with respect to the dense operand is Aᵀ·dZ, the same kernel over
the cached transposed CSR (``ND_Sparse_Array.csr_t``), dispatched under the
mode the forward ran under (``registry.bind``). The sparse values get no
gradient: every caller feeds them as an untrainable adjacency.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ndarray import CSRMatrix, ND_Sparse_Array
from . import _build, registry

_SRC = "csr_spmm"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer and
    the stream as c_void_p, the sizes as c_int64."""
    lib = _build.load(_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.hetu_csr_spmm.argtypes = [P, P, P, P, P, I, I, P]
    lib.hetu_csr_spmm.restype = ctypes.c_int
    lib.hetu_csr_spmv.argtypes = [P, P, P, P, P, I, P]
    lib.hetu_csr_spmv.restype = ctypes.c_int
    return lib


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# plain versions: the kernel's summation order in elementwise PyTorch
# ---------------------------------------------------------------------------

def _plan(a: CSRMatrix):
    """``(perm, start, longer)`` of ``a``, cached on it: the rows by length,
    longest first (ties by row index), the first entry of each of them, and
    ``longer[k]``, the number of rows longer than k, as host ints. The rows
    longer than k are then the first ``longer[k]`` of ``perm``."""
    if a.plan is None:
        lengths = (a.rowptr[1:] - a.rowptr[:-1]).long()
        perm = torch.sort(lengths, descending=True, stable=True).indices
        per_length = torch.bincount(lengths, minlength=1)
        at_least = per_length.flip(0).cumsum(0).flip(0)
        a.plan = (perm, a.rowptr[:-1].long()[perm], at_least[1:].tolist())
    return a.plan


def _sum_rows(a: CSRMatrix, gather, width):
    """``acc[r] = acc[r] + val_j * gather(col_j)`` over each row's entries in
    CSR order, one k-th entry of every row at a time; rows in ``perm``
    order, put back in row order at the end."""
    perm, start, longer = _plan(a)
    acc = torch.zeros((a.nrow,) + width, dtype=torch.float32,
                      device=a.device)
    for k, n in enumerate(longer):
        j = start[:n] + k
        v = a.val[j]
        acc[:n] += v.view((n,) + (1,) * len(width)) * gather(a.col[j])
    return torch.empty_like(acc).index_copy_(0, perm, acc)


def _spmm_plain(a: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Z = A·B, (nrow, F) float32, summed in the kernel's order."""
    return _sum_rows(a, lambda c: b.index_select(0, c).float(),
                     (int(b.shape[1]),))


def _spmv_plain(a: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """z = A·x, (nrow,) float32, summed in the kernel's order."""
    return _sum_rows(a, lambda c: x.index_select(0, c).float(), ())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _spmm_kernel(a: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Launch ``spmm_kernel``: a new (nrow, F) float32 Z."""
    z = torch.empty((a.nrow, b.shape[1]), dtype=torch.float32,
                    device=b.device)
    lib = _lib()
    with torch.cuda.device(b.device):
        rc = lib.hetu_csr_spmm(
            a.rowptr.data_ptr(), a.col.data_ptr(), a.val.data_ptr(),
            b.data_ptr(), z.data_ptr(), a.nrow, b.shape[1],
            torch.cuda.current_stream().cuda_stream)
    _check_rc("csr_spmm", rc)
    _SPMM.launches += 1
    return z


def _spmv_kernel(a: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch ``spmv_kernel``: a new (nrow,) float32 z."""
    z = torch.empty((a.nrow,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.hetu_csr_spmv(
            a.rowptr.data_ptr(), a.col.data_ptr(), a.val.data_ptr(),
            x.data_ptr(), z.data_ptr(), a.nrow,
            torch.cuda.current_stream().cuda_stream)
    _check_rc("csr_spmv", rc)
    _SPMV.launches += 1
    return z


def _eligible(a, dense, ndim, what):
    """f32 values and dense operand, int32 indices, all contiguous on one
    CUDA device; the dense operand (K, F) or (K,) with K = ncol."""
    if not isinstance(a, CSRMatrix):
        return False, f"A must be a CSRMatrix, got {type(a).__name__}"
    named = {"rowptr": (a.rowptr, torch.int32), "col": (a.col, torch.int32),
             "values": (a.val, torch.float32), what: (dense, torch.float32)}
    for nm, (t, dtype) in named.items():
        if not isinstance(t, torch.Tensor):
            return False, f"{nm} must be a tensor, got {type(t).__name__}"
        if t.device.type != "cuda" or t.device != a.device:
            return False, f"{nm} is on {t.device}, A is on {a.device}"
        if t.dtype != dtype:
            return False, f"{nm} must be {dtype}, got {t.dtype}"
        if not t.is_contiguous():
            return False, f"{nm} is not contiguous"
    if dense.ndim != ndim or dense.shape[0] != a.ncol:
        want = f"({a.ncol}, F)" if ndim == 2 else f"({a.ncol},)"
        return False, (f"{what} has shape {tuple(dense.shape)}, expected "
                       f"{want}")
    if a.rowptr.shape != (a.nrow + 1,) or a.col.shape != a.val.shape:
        return False, "rowptr, col and values do not form a CSR matrix"
    if a.nnz >= 2**31:
        return False, f"nnz {a.nnz} does not fit the int32 row pointers"
    return True, None


_SPMM = registry.register_kernel(
    "csr_spmm", kernel_fn=_spmm_kernel, plain_fn=_spmm_plain,
    eligibility=lambda a, b: _eligible(a, b, 2, "B"))
_SPMV = registry.register_kernel(
    "csr_spmv", kernel_fn=_spmv_kernel, plain_fn=_spmv_plain,
    eligibility=lambda a, x: _eligible(a, x, 1, "x"))


# ---------------------------------------------------------------------------
# autograd and the entry points of graph/ops/matmul.py
# ---------------------------------------------------------------------------

class _SparseProduct(torch.autograd.Function):
    """Z = A·B through the registry; dB = Aᵀ·dZ, the same kernel over the
    transposed CSR, under the mode the forward ran under."""

    @staticmethod
    def forward(ctx, dense, a, a_t, kernel):
        ctx.dispatch = registry.bind(registry.dispatch)
        ctx.a_t, ctx.kernel = a_t, kernel
        return registry.dispatch(kernel, a, dense)

    @staticmethod
    def backward(ctx, dz):
        return (ctx.dispatch(ctx.kernel, ctx.a_t, dz.contiguous()), None,
                None, None)


def _product(kernel, a: ND_Sparse_Array, dense, trans):
    fwd, bwd = (a.csr_t, a.csr) if trans else (a.csr, a.csr_t)
    return _SparseProduct.apply(dense.contiguous(), fwd, bwd, kernel)


def matmat(a: ND_Sparse_Array, b: torch.Tensor, trans: bool = False):
    """``A @ B`` (``Aᵀ @ B`` with ``trans``), B (K, F): (nrow, F) float32."""
    return _product("csr_spmm", a, b, trans)


def matvec(a: ND_Sparse_Array, x: torch.Tensor, trans: bool = False):
    """``A @ x`` (``Aᵀ @ x`` with ``trans``), x (K,): (nrow,) float32."""
    return _product("csr_spmv", a, x, trans)


def coo_matmat(values, rows, cols, nrow: int, b):
    """``sparse(values, rows, cols) @ B`` (reference ``coo_matmat``): the
    COO entry, which builds the CSR forms on each call."""
    return matmat(ND_Sparse_Array(values, rows.int(), cols.int(), nrow,
                                  b.shape[0]), b)


def coo_matvec(values, rows, cols, nrow: int, x):
    """``sparse(values, rows, cols) @ x`` (reference ``coo_matvec``)."""
    return matvec(ND_Sparse_Array(values, rows.int(), cols.int(), nrow,
                                  x.shape[0]), x)
