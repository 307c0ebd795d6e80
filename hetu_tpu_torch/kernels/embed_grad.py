"""Embedding gradient by a sorted segment sum: hand-written CUDA for
Hopper, in ``csrc/embed_grad.cu`` (counterpart of
``hetu_tpu/kernels/embed_grad.py``).

``fused_embed_grad`` replaces ``hetu_tpu/kernels/embed_grad.py:
_segsum_pallas`` (body ``_segsum_kernel``). The compact form of a batch's
embedding gradient is

    rows, grads, count = embed_grad_rows(vec, idx, vocab)

``rows`` is ``(n,)`` int32, the sorted unique row ids padded with the
``vocab`` sentinel past ``count``; ``grads`` is ``(n, dim)`` float32 with
each unique row's gradient sum in the first ``count`` slots and zeros
after. ``embed_grad_dense`` turns it into the ``(vocab, dim)`` table
gradient with one scatter over the unique rows.

Split of labour, as in the JAX package: the flatten, the stable sort by
row id and the segment bounds are PyTorch (:func:`_prep`); the kernel sums
each segment. The rows are sorted, so segment k is the contiguous run
``sv[offs[k]:offs[k + 1]]``; the kernel adds its rows in order into one
float32 accumulator per element. :func:`_segsum_plain` adds them in that
same order in elementwise PyTorch (for t = 0, 1, ...: every segment
longer than t adds its t-th row), with no ``index_add_`` (atomics), no
``segment_reduce`` and no matmul, so kernel and plain version agree bit
for bit on the card. ``_segsum_xla``'s ``segment_sum`` sums in another
order; the CPU tests hold the plain version against it by allclose and
relative L2.

Autograd through a lookup reaches the kernel too. :class:`EmbeddingLookup`
gathers rows forward (``index_select``) and takes the table's gradient
through :func:`embed_grad_dense` backward. PyTorch's own backward of a
gather is ``index_add_``, which adds duplicate ids with atomics in the
order the threads arrive, so its sum changes from run to run. Every CTR
training step therefore launches ``fused_embed_grad`` once per table.

Bound on an H100 SXM (3.35 TB/s): bytes. The kernel reads ``sv`` and
``offs`` once and writes ``out`` once, ``8·n·d + 4·(n + 1)`` bytes; at
WDL-Criteo's n = 3,328 ids and d = 128 that is 3.4 MB, about 1 µs.
Element offsets are 64-bit everywhere: the full Criteo table holds
4.32e9 elements, more than 2^32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build, registry

_SRC = "embed_grad"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared: every pointer and
    the stream as c_void_p, the sizes as c_int64."""
    lib = _build.load(_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.hetu_embed_grad_segsum.argtypes = [P, P, P, I, I, P]
    lib.hetu_embed_grad_segsum.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# prep (PyTorch on both paths): sort, segment ids, unique rows, bounds
# ---------------------------------------------------------------------------

def ids_of(idx: torch.Tensor) -> torch.Tensor:
    """Row ids as int32, float ids truncated toward zero as
    ``astype(jnp.int32)`` truncates them."""
    return idx if idx.dtype == torch.int32 else idx.to(torch.int32)


def _prep(vec: torch.Tensor, idx: torch.Tensor, vocab: int):
    """Flatten, then stable-sort the row gradients by row id.

    Returns ``(sv (n, d) f32, seg (n,) i32, rows (n,) i32, count () i32,
    offs (n + 1,) i32)``: ``seg`` maps each sorted row to its unique row's
    rank, ``rows[k]`` is unique row k's id (``vocab`` past ``count``), and
    segment k is ``sv[offs[k]:offs[k + 1]]`` (``offs[k] = n`` for k >=
    count). Static shapes, no host sync."""
    d = int(vec.shape[-1])
    flat_idx = ids_of(idx).reshape(-1)
    flat_vec = vec.reshape(-1, d).float()
    sidx, order = torch.sort(flat_idx, stable=True)
    sv = flat_vec.index_select(0, order)
    n = sidx.shape[0]
    first = torch.ones((n,), dtype=torch.bool, device=sidx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1      # 0..count-1
    count = seg[-1] + 1
    rows = torch.full((n,), vocab, dtype=torch.int32,
                      device=sidx.device).scatter_(0, seg.long(), sidx)
    offs = torch.searchsorted(
        seg, torch.arange(n + 1, dtype=torch.int32, device=sidx.device),
        out_int32=True)
    return sv, seg, rows, count, offs


# ---------------------------------------------------------------------------
# the segment sum: plain version and kernel
# ---------------------------------------------------------------------------

def _segsum_plain(sv: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``out[k] = sum of sv[offs[k]:offs[k + 1]]`` in row order, (n, d)
    float32: the kernel's order. The segments are taken longest first
    (ties by index), so the segments longer than t are a prefix of that
    order; each pass t adds their t-th rows."""
    n, d = sv.shape
    lengths = (offs[1:] - offs[:-1]).long()
    perm = torch.sort(lengths, descending=True, stable=True).indices
    start = offs[:-1].long()[perm]
    at_least = torch.bincount(lengths, minlength=1).flip(0).cumsum(0).flip(0)
    acc = torch.zeros((n, d), dtype=torch.float32, device=sv.device)
    for t, m in enumerate(at_least[1:].tolist()):
        acc[:m] += sv.index_select(0, start[:m] + t)
    return torch.empty_like(acc).index_copy_(0, perm, acc)


def _segsum_kernel(sv: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Launch ``segsum_kernel``: a new (n, d) float32 ``out``."""
    n, d = sv.shape
    out = torch.empty((n, d), dtype=torch.float32, device=sv.device)
    lib = _lib()
    with torch.cuda.device(sv.device):
        rc = lib.hetu_embed_grad_segsum(
            sv.data_ptr(), offs.data_ptr(), out.data_ptr(), n, d,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_embed_grad: kernel launch failed with "
                           f"CUDA error {rc}")
    _SEGSUM.launches += 1
    return out


def _segsum_eligible(sv, offs):
    """``sv`` (n, d) f32 and ``offs`` (n + 1,) int32, both contiguous on
    one CUDA device; n >= 1 and d >= 1."""
    for nm, t, dtype in (("grads", sv, torch.float32),
                         ("offsets", offs, torch.int32)):
        if not isinstance(t, torch.Tensor):
            return False, f"{nm} must be a tensor, got {type(t).__name__}"
        if t.device.type != "cuda" or t.device != sv.device:
            return False, f"{nm} is on {t.device}, grads on {sv.device}"
        if t.dtype != dtype:
            return False, f"{nm} must be {dtype}, got {t.dtype}"
        if not t.is_contiguous():
            return False, f"{nm} is not contiguous"
    if sv.ndim != 2 or sv.shape[0] < 1 or sv.shape[1] < 1:
        return False, f"grads must be (n, dim) with n, dim >= 1, got " \
                      f"{tuple(sv.shape)}"
    if offs.shape != (sv.shape[0] + 1,):
        return False, (f"offsets have shape {tuple(offs.shape)}, expected "
                       f"({sv.shape[0] + 1},)")
    if sv.shape[0] >= 2**31:
        return False, f"{sv.shape[0]} rows do not fit int32 offsets"
    return True, None


_SEGSUM = registry.register_kernel(
    "fused_embed_grad", kernel_fn=_segsum_kernel, plain_fn=_segsum_plain,
    eligibility=_segsum_eligible)


# ---------------------------------------------------------------------------
# public forms (signatures of hetu_tpu.kernels.embed_grad)
# ---------------------------------------------------------------------------

def embed_grad_rows(vec: torch.Tensor, idx: torch.Tensor, vocab: int):
    """Compact embedding gradient ``(rows, grads, count)`` (the layout in
    the module docstring); the segment sum goes through the registry."""
    d = int(vec.shape[-1])
    if idx.numel() == 0:
        # the compact form of nothing is nothing (the prep's first-row
        # flag needs one row)
        dev = vec.device
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, d), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    sv, _seg, rows, count, offs = _prep(vec, idx, vocab)
    grads = registry.dispatch("fused_embed_grad", sv, offs)
    return rows, grads, count


def embed_grad_dense(vec: torch.Tensor, idx: torch.Tensor,
                     shape: Sequence[int]) -> torch.Tensor:
    """The ``(vocab, dim)`` table gradient: one scatter of the compact
    form's rows into a ``(vocab + 1, dim)`` zeros buffer, where the
    sentinel rows land in the extra row, then the first ``vocab`` rows (a
    view). The rows are unique, so no summation order arises; no host
    sync."""
    vocab, d = (int(s) for s in shape)
    rows, grads, _count = embed_grad_rows(vec, idx, vocab)
    buf = torch.zeros((vocab + 1, d), dtype=vec.dtype, device=vec.device)
    buf.index_copy_(0, rows.long(), grads.to(vec.dtype))
    return buf[:vocab]


class EmbeddingLookup(torch.autograd.Function):
    """``table[idx]`` (a gather, as ``jnp.take``); the table's gradient is
    :func:`embed_grad_dense` of the output's gradient, under the mode the
    forward ran under (``registry.bind``: PyTorch runs a CUDA backward on
    its own thread)."""

    @staticmethod
    def forward(ctx, table, idx):
        ids = ids_of(idx)
        ctx.save_for_backward(ids)
        ctx.shape = tuple(table.shape)
        ctx.grad_dense = registry.bind(embed_grad_dense)
        out = table.index_select(0, ids.reshape(-1))
        return out.view(tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        return ctx.grad_dense(g.contiguous(), ids, ctx.shape), None


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the 2-D ``table``, differentiable in the table."""
    if table.ndim != 2:
        raise ValueError(f"an embedding table is (vocab, dim), got shape "
                         f"{tuple(table.shape)}")
    return EmbeddingLookup.apply(table, idx)
