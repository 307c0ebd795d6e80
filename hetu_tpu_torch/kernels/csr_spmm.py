"""CSR sparse x dense products: hand-written CUDA for Hopper, in
``csrc/csr_spmm.cu`` (counterpart of ``hetu_tpu/kernels/csr_spmm.py``).

``csr_spmm`` replaces ``hetu_tpu/kernels/csr_spmm.py:_spmm_pallas`` (body
``_spmm_kernel``) and ``csr_spmv`` replaces ``_spmv_pallas``. They serve
``csrmm_op``/``csrmv_op`` (``graph/ops/matmul.py``) and through them
``distgcn_15d_op``, forward and backward.

Both take one CSR form (``ndarray.CSRMatrix``) of a sparse matrix A and
compute ``Z[r] = sum_j val_j * B[col_j]`` over row r's entries. The work
split is :func:`chunk_plan`'s, computed here once per matrix and cached on
it: each row is cut into chunks of at most ``SPMM_CHUNK`` / ``SPMV_CHUNK``
consecutive entries in CSR order. The summation order, per output
element: each chunk sums its entries in CSR order into one float32
accumulator started at 0, each product rounded before it is added; a row
of one chunk is that sum, and a split row's partials are folded in chunk
order, ``((p0 + p1) + p2) + ...``. The plain versions below sum in that
same order (the chunks as rows: for k = 0, 1, ...: every chunk longer
than k adds its k-th entry; then the fold), in elementwise float32 with no
atomics (``index_add_``), no library sparse product and no matmul, so
kernel and plain version agree bit for bit on the card. ``_spmm_xla``'s
``segment_sum`` sums in another order; the CPU tests hold the plain
versions against it by allclose and relative L2.

Bound on an H100 SXM (3.35 TB/s): bytes. Reading each B row once, the
least for Z = A·B is ``8·nnz + 4·(nrow + 1) + 4·K·F + 4·nrow·F`` bytes;
reading a B row per entry, ``8·nnz + 4·(nrow + 1) + 4·nnz·F + 4·nrow·F``;
L2 puts the real floor between the two. The 2·nnz·F flops are negligible.
A row of one warp (spmm) or one thread (spmv) would run its entries as one
chain of dependent loads; the chunks bound that chain, so a row of high
degree no longer sets the kernel's time.

``matmat``/``matvec`` are ``torch.autograd.Function`` products: the
gradient with respect to the dense operand is Aᵀ·dZ, the same kernel over
the cached transposed CSR (``ND_Sparse_Array.csr_t``), dispatched under the
mode the forward ran under (``registry.bind``). The sparse values get no
gradient: every caller feeds them as an untrainable adjacency.
"""
from __future__ import annotations

import ctypes
import functools
import typing

import torch

from ..ndarray import CSRMatrix, ND_Sparse_Array
from . import _build, registry

_SRC = "csr_spmm"

# The most entries one chunk sums before its partial is merged. csr_spmm:
# one entry a lane of the chunk's warp, so a chunk's col and val arrive in
# one coalesced load each and reach the lanes by shuffles; then a chunk is
# at most 4 rounds of 8 B-row loads in flight, and the arxiv-sized graph's
# 4,315-entry row is 135 partials for its merge. csr_spmv: one thread a
# chunk, at most 4 rounds of 8 gathers of x; at 32, 97.8 % of that graph's
# rows stay one chunk and keep the serial sum's bits (16 split 43,301 rows
# and made the merge slower; 64 was no faster). Each must equal its
# kernel's constant (csrc/csr_spmm.cu kSpmmChunk, kSpmvChunk).
SPMM_CHUNK = 32
SPMV_CHUNK = 32


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer and
    the stream as c_void_p, the sizes as c_int64."""
    lib = _build.load(_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.hetu_csr_spmm.argtypes = [P, I, P, I, I, P, P, P, P, P, I, P]
    lib.hetu_csr_spmm.restype = ctypes.c_int
    lib.hetu_csr_spmv.argtypes = [P, I, P, I, I, P, P, P, P, P, P]
    lib.hetu_csr_spmv.restype = ctypes.c_int
    return lib


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# the work split, read as given by the kernels and the plain versions
# ---------------------------------------------------------------------------

class ChunkPlan(typing.NamedTuple):
    """Each row of a CSR matrix cut into chunks of at most ``chunk``
    consecutive entries, in CSR order (an empty row is one chunk of none).

    ``chunks`` int32 (4, nchunk): each chunk's row, start, end (entry
    indices, end exclusive) and slot: -1 where its row is one chunk (the
    sum goes straight to the output row), else the chunk's row in the
    workspace of partials. ``splits`` int32 (3, nsplit): for each row of
    more than one chunk, its row, the slot of its first partial and its
    number of partials; its partials sit in consecutive slots, in chunk
    order. ``nslot`` is the workspace's rows. The arrays lie on the CSR's
    device."""
    chunk: int
    chunks: torch.Tensor
    splits: torch.Tensor
    nslot: int


def chunk_plan(a: CSRMatrix, chunk: int) -> ChunkPlan:
    """:class:`ChunkPlan` of ``a`` at ``chunk`` entries, built once and
    cached on ``a`` (the GCN feeds one adjacency every epoch)."""
    key = ("chunks", chunk)
    if key not in a.plans:
        rowptr = a.rowptr.long()
        lengths = rowptr[1:] - rowptr[:-1]
        per_row = ((lengths + chunk - 1) // chunk).clamp(min=1)
        ends = per_row.cumsum(0)
        nchunk = int(ends[-1]) if a.nrow else 0
        row = torch.repeat_interleave(
            torch.arange(a.nrow, device=a.device), per_row,
            output_size=nchunk)
        start = rowptr[row] + (torch.arange(nchunk, device=a.device)
                               - (ends - per_row)[row]) * chunk
        end = torch.minimum(start + chunk, rowptr[row + 1])
        split = per_row > 1
        in_split = split[row]
        slot = torch.where(in_split, in_split.cumsum(0) - 1, -1)
        split_row = split.nonzero().flatten()
        parts = per_row[split_row]
        a.plans[key] = ChunkPlan(
            chunk, torch.stack([row, start, end, slot]).int().contiguous(),
            torch.stack([split_row, parts.cumsum(0) - parts, parts])
            .int().contiguous(), int(parts.sum()))
    return a.plans[key]


# ---------------------------------------------------------------------------
# plain versions: the kernel's summation order in elementwise PyTorch
# ---------------------------------------------------------------------------

class _PlainOrder(typing.NamedTuple):
    """A chunk plan as the plain loops walk it, cached beside it."""
    perm: torch.Tensor       # chunks by length, longest first
    start: torch.Tensor      # their first entries
    longer: list             # longer[k]: chunks longer than k (host ints)
    direct: torch.Tensor     # chunks whose row is one chunk
    direct_rows: torch.Tensor
    split_chunks: torch.Tensor   # chunks of split rows, in slot order
    first: torch.Tensor      # split rows by parts, most first: first slot
    split_rows: torch.Tensor
    more: list               # more[k - 1]: split rows of more than k parts


def _at_least(counts: torch.Tensor) -> list:
    """``out[k]`` = how many of ``counts`` exceed k, for k = 0 ... max - 1."""
    per = torch.bincount(counts, minlength=1)
    return per.flip(0).cumsum(0).flip(0)[1:].tolist()


def _plain_order(a: CSRMatrix, chunk: int) -> _PlainOrder:
    key = ("plain", chunk)
    if key not in a.plans:
        plan = chunk_plan(a, chunk)
        row, start, end, slot = plan.chunks.long()
        lengths = end - start
        perm = torch.sort(lengths, descending=True, stable=True).indices
        split_row, first, parts = plan.splits.long()
        sperm = torch.sort(parts, descending=True, stable=True).indices
        direct = (slot < 0).nonzero().flatten()
        a.plans[key] = _PlainOrder(
            perm, start[perm], _at_least(lengths), direct, row[direct],
            (slot >= 0).nonzero().flatten(), first[sperm], split_row[sperm],
            _at_least(parts)[1:])
    return a.plans[key]


def _sum_chunks(a: CSRMatrix, chunk: int, gather, width):
    """Z in the kernel's order: ``acc[c] = acc[c] + val_j * gather(col_j)``
    over each chunk's entries in CSR order, one k-th entry of every chunk
    at a time (chunks in ``perm`` order, put back in chunk order); a row of
    one chunk takes its sum, a split row ``((p0 + p1) + p2) + ...`` over
    its partials."""
    o = _plain_order(a, chunk)
    acc = torch.zeros((len(o.perm),) + width, dtype=torch.float32,
                      device=a.device)
    for k, n in enumerate(o.longer):
        j = o.start[:n] + k
        v = a.val[j]
        acc[:n] += v.view((n,) + (1,) * len(width)) * gather(a.col[j])
    acc = torch.empty_like(acc).index_copy_(0, o.perm, acc)
    z = torch.empty((a.nrow,) + width, dtype=torch.float32, device=a.device)
    z.index_copy_(0, o.direct_rows, acc[o.direct])
    parts = acc[o.split_chunks]
    fold = parts[o.first]
    for k, n in enumerate(o.more, start=1):
        fold[:n] = fold[:n] + parts[o.first[:n] + k]
    return z.index_copy_(0, o.split_rows, fold)


def _spmm_plain(a: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Z = A·B, (nrow, F) float32, summed in the kernel's order."""
    return _sum_chunks(a, SPMM_CHUNK, lambda c: b.index_select(0, c).float(),
                       (int(b.shape[1]),))


def _spmv_plain(a: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """z = A·x, (nrow,) float32, summed in the kernel's order."""
    return _sum_chunks(a, SPMV_CHUNK, lambda c: x.index_select(0, c).float(),
                       ())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
# Each wrapper call counts one launch, though it makes two CUDA launches
# where a row is split: the chunk kernel, then the merge.

def _spmm_kernel(a: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Launch ``spmm_chunk_kernel`` and ``spmm_merge_kernel`` over
    :func:`chunk_plan`'s chunks: a new (nrow, F) float32 Z."""
    plan = chunk_plan(a, SPMM_CHUNK)
    f = int(b.shape[1])
    z = torch.empty((a.nrow, f), dtype=torch.float32, device=b.device)
    ws = torch.empty((plan.nslot, f), dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        rc = _lib().hetu_csr_spmm(
            plan.chunks.data_ptr(), plan.chunks.shape[1],
            plan.splits.data_ptr(), plan.splits.shape[1], plan.chunk,
            a.col.data_ptr(), a.val.data_ptr(), b.data_ptr(), z.data_ptr(),
            ws.data_ptr(), f, torch.cuda.current_stream().cuda_stream)
    _check_rc("csr_spmm", rc)
    _SPMM.launches += 1
    return z


def _spmv_kernel(a: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch ``spmv_chunk_kernel`` and ``spmv_merge_kernel`` over
    :func:`chunk_plan`'s chunks: a new (nrow,) float32 z."""
    plan = chunk_plan(a, SPMV_CHUNK)
    z = torch.empty((a.nrow,), dtype=torch.float32, device=x.device)
    ws = torch.empty((plan.nslot,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().hetu_csr_spmv(
            plan.chunks.data_ptr(), plan.chunks.shape[1],
            plan.splits.data_ptr(), plan.splits.shape[1], plan.chunk,
            a.col.data_ptr(), a.val.data_ptr(), x.data_ptr(), z.data_ptr(),
            ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
