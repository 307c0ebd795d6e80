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
after. ``embed_grad_dense`` gives the ``(vocab, dim)`` table gradient:
the kernel writes each id's sum straight into its row of a zeroed table
(an id outside ``[0, vocab)`` is dropped, as the JAX package's scatter
with ``mode="drop"`` drops it).

Split of labour: the flatten and the stable sort of the ids are PyTorch
(:func:`_prep`, one ``torch.sort``); the compact form also ranks the
sorted ids (:func:`_ranks`). The kernel reads each row gradient through
the sort's permutation (no sorted copy of the rows) and sums each id's
run. Its order is defined once, in ``csrc/embed_grad.cu``: the sorted
rows are cut into chunks of :func:`chunk_rows` rows; each id's rows inside
one chunk (a piece) are added in row order into one float32 accumulator
started at 0, and an id whose run crosses chunks folds its pieces in chunk
order. :func:`_segsum_plain` adds in exactly that order in elementwise
PyTorch (no ``index_add_``, no ``segment_reduce``, no matmul), so kernel
and plain version agree bit for bit on the card. ``_segsum_xla``'s
``segment_sum`` sums in another order; the CPU tests hold the plain
version against it by allclose and relative L2.

Autograd through a lookup reaches the kernel too. :class:`EmbeddingLookup`
gathers rows forward (``index_select``) and takes the table's gradient
through :func:`embed_grad_dense` backward. PyTorch's own backward of a
gather (``indexing_backward``) adds each duplicated id's rows serially;
``index_add_`` adds them with atomics in the order the threads arrive.
Every CTR training step therefore launches ``fused_embed_grad`` once per
table, and every BERT training step twice (the token and the type
embedding).

Bound on an H100 SXM (3.35 TB/s): bytes. The kernel reads the rows,
``order`` (int64) and the keys once and writes each summed row once,
``4·n·d + 12·n + 4·rows·d`` bytes: at BERT-base's phase 2 (n = 16,384,
d = 768) about 50 MB of reads, 15 µs; at WDL-Criteo's step (n = 3,328,
d = 128) 3.4 MB, about 1 µs, where a launch's fixed cost dominates.
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
# csrc/embed_grad.cu's kMaxChunk: the largest chunk the kernel stages
MAX_CHUNK = 256
MIN_CHUNK = 16
# warps (chunk x 128-column slab) chunk_rows aims a call at: about 8 a SM
TARGET_WARPS = 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared: every pointer and
    the stream as c_void_p, the sizes as c_int64."""
    lib = _build.load(_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.hetu_embed_grad_segsum.argtypes = [P, P, P, P, P, I, I, I, I, P]
    lib.hetu_embed_grad_segsum.restype = ctypes.c_int
    return lib


def chunk_rows(n: int, d: int) -> int:
    """C, the rows of a chunk, from the call's shape alone: the smallest
    power of two from MIN_CHUNK that gives at most TARGET_WARPS warps of
    (chunk, 128-column slab), up to MAX_CHUNK. Few rows get short chunks
    (more warps, each a round trip or two: WDL-Criteo's 3,328 rows at
    d = 128, 16); many rows long ones (fewer partials to fold: BERT-base's
    16,384 at d = 768, 128)."""
    want = -(-n * -(-d // 128) // TARGET_WARPS)
    c = MIN_CHUNK
    while c < want and c < MAX_CHUNK:
        c *= 2
    return c


# ---------------------------------------------------------------------------
# prep (PyTorch on both paths): the sort, and the compact form's ranks
# ---------------------------------------------------------------------------

def ids_of(idx: torch.Tensor) -> torch.Tensor:
    """Row ids as int32, float ids truncated toward zero as
    ``astype(jnp.int32)`` truncates them."""
    return idx if idx.dtype == torch.int32 else idx.to(torch.int32)


def _prep(vec: torch.Tensor, idx: torch.Tensor):
    """Flatten, then stable-sort the row ids.

    Returns ``(flat (n, d) f32, order (n,) int64, sidx (n,) int32)``:
    sorted row j is ``flat[order[j]]``, with id ``sidx[j]``; the sort is
    stable, so one id's rows keep the batch's order. No copy of the rows,
    no host sync."""
    d = int(vec.shape[-1])
    flat = vec.reshape(-1, d).float().contiguous()
    sidx, order = torch.sort(ids_of(idx).reshape(-1), stable=True)
    return flat, order, sidx


def _ranks(sidx: torch.Tensor, vocab: int):
    """The compact form's bookkeeping of sorted ids ``sidx``: ``(seg (n,)
    i32, rows (n,) i32, count () i32)``; ``seg`` maps each sorted row to
    its unique row's rank and ``rows[k]`` is unique row k's id (``vocab``
    past ``count``). Static shapes, no host sync."""
    n = sidx.shape[0]
    first = torch.ones((n,), dtype=torch.bool, device=sidx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1      # 0..count-1
    count = seg[-1] + 1
    rows = torch.full((n,), vocab, dtype=torch.int32,
                      device=sidx.device).scatter_(0, seg.long(), sidx)
    return seg, rows, count


# ---------------------------------------------------------------------------
# the segment sum: plain version and kernel
# ---------------------------------------------------------------------------

def _segsum_plain(vec: torch.Tensor, order: torch.Tensor, key: torch.Tensor,
                  out: torch.Tensor):
    """``out[k] = the sum of vec[order[j]] over key[j] = k`` for each key
    in ``[0, len(out))``, in the kernel's order: pieces
    (a key's rows inside one chunk of ``chunk_rows(n, d)`` sorted rows)
    summed in row order from 0, all chunks at once, one row position at a
    time; then each key's pieces folded in chunk order, all keys at once,
    one piece at a time. Returns ``out``, its other rows untouched."""
    n, d = order.shape[0], vec.shape[1]
    c = chunk_rows(n, d)
    chunks = -(-n // c)
    dev = vec.device
    rows = torch.zeros((chunks * c, d), dtype=torch.float32, device=dev)
    rows[:n] = vec.index_select(0, order)
    new_key = torch.ones((n,), dtype=torch.bool, device=dev)
    new_key[1:] = key[1:] != key[:-1]
    new_piece = new_key | (torch.arange(n, device=dev) % c == 0)
    starts = torch.ones((chunks * c,), dtype=torch.bool, device=dev)
    starts[:n] = new_piece
    starts, rows = starts.view(chunks, c, 1), rows.view(chunks, c, d)
    sums = torch.empty_like(rows)
    acc = torch.zeros((chunks, d), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(c):
        acc = torch.where(starts[:, t], zero, acc) + rows[:, t]
        sums[:, t] = acc
    # a piece's sum stands at its last row; pieces in sorted order
    last = torch.ones((n,), dtype=torch.bool, device=dev)
    last[:-1] = new_piece[1:]
    pieces = sums.view(-1, d)[:n][last]
    first = torch.nonzero(new_key[new_piece]).flatten()   # each key's first
    count = torch.diff(first, append=first.new_tensor([pieces.shape[0]]))
    acc = pieces[first]
    for t in range(1, int(count.max())):
        sel = count > t
        acc[sel] = acc[sel] + pieces[first[sel] + t]
    keys = key[new_key]
    kept = (keys >= 0) & (keys < out.shape[0])
    return out.index_copy_(0, keys[kept].long(), acc[kept])


def _segsum_kernel(vec: torch.Tensor, order: torch.Tensor, key: torch.Tensor,
                   out: torch.Tensor):
    """Launch ``segsum_chunk_kernel`` (and ``segsum_fold_kernel`` where
    there are two chunks or more) into ``out``, in chunks of
    ``chunk_rows(n, d)``. Returns ``out``."""
    n, d = order.shape[0], vec.shape[1]
    c = chunk_rows(n, d)
    part = torch.empty((2 * -(-n // c), d), dtype=torch.float32,
                       device=vec.device)
    lib = _lib()
    with torch.cuda.device(vec.device):
        rc = lib.hetu_embed_grad_segsum(
            vec.data_ptr(), order.data_ptr(), key.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, d, out.shape[0], c,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_embed_grad: kernel launch failed with "
                           f"CUDA error {rc}")
    _SEGSUM.launches += 1
    return out


def _segsum_eligible(vec, order, key, out):
    """``vec`` (n, d) and ``out`` (rows, d) f32, ``order`` (n,) int64 and
    ``key`` (n,) int32, all contiguous on one CUDA device; n, d >= 1."""
    for nm, t, dtype in (("grads", vec, torch.float32),
                         ("order", order, torch.int64),
                         ("keys", key, torch.int32),
                         ("out", out, torch.float32)):
        if not isinstance(t, torch.Tensor):
            return False, f"{nm} must be a tensor, got {type(t).__name__}"
        if t.device.type != "cuda" or t.device != vec.device:
            return False, f"{nm} is on {t.device}, grads on {vec.device}"
        if t.dtype != dtype:
            return False, f"{nm} must be {dtype}, got {t.dtype}"
        if not t.is_contiguous():
            return False, f"{nm} is not contiguous"
    if vec.ndim != 2 or vec.shape[0] < 1 or vec.shape[1] < 1:
        return False, f"grads must be (n, dim) with n, dim >= 1, got " \
                      f"{tuple(vec.shape)}"
    n, d = vec.shape
    if order.shape != (n,) or key.shape != (n,):
        return False, (f"order and keys have shapes {tuple(order.shape)}, "
                       f"{tuple(key.shape)}, expected ({n},)")
    if out.ndim != 2 or out.shape[1] != d:
        return False, f"out has shape {tuple(out.shape)}, expected (rows, {d})"
    if n >= 2**31 or out.shape[0] >= 2**31:
        return False, f"{n} rows into {out.shape[0]} do not fit int32 keys"
    if -(-d // 32) > 65535:
        return False, f"dim {d} needs more than 65,535 column slabs"
    return True, None


_SEGSUM = registry.register_kernel(
    "fused_embed_grad", kernel_fn=_segsum_kernel, plain_fn=_segsum_plain,
    eligibility=_segsum_eligible)


# ---------------------------------------------------------------------------
# public forms (signatures of hetu_tpu.kernels.embed_grad)
# ---------------------------------------------------------------------------

def embed_grad_rows(vec: torch.Tensor, idx: torch.Tensor, vocab: int):
    """Compact embedding gradient ``(rows, grads, count)`` (the layout in
    the module docstring); the segment sum goes through the registry, keyed
    by each sorted row's rank."""
    d = int(vec.shape[-1])
    if idx.numel() == 0:
        # the compact form of nothing is nothing (the ranks' first-row flag
        # needs one row)
        dev = vec.device
        return (torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((0, d), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    flat, order, sidx = _prep(vec, idx)
    seg, rows, count = _ranks(sidx, vocab)
    grads = torch.zeros((flat.shape[0], d), dtype=torch.float32,
                        device=vec.device)
    registry.dispatch("fused_embed_grad", flat, order, seg, grads)
    return rows, grads, count


def embed_grad_dense(vec: torch.Tensor, idx: torch.Tensor,
                     shape: Sequence[int]) -> torch.Tensor:
    """The ``(vocab, dim)`` table gradient: the segment sum, keyed by the
    sorted ids, written into a zeroed table (the sums are unique rows, so
    no summation order arises past the kernel's; no host sync)."""
    vocab, d = (int(s) for s in shape)
    out = torch.zeros((vocab, d), dtype=torch.float32, device=vec.device)
    if idx.numel():
        flat, order, sidx = _prep(vec, idx)
        registry.dispatch("fused_embed_grad", flat, order, sidx, out)
    return out if vec.dtype == torch.float32 else out.to(vec.dtype)


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
