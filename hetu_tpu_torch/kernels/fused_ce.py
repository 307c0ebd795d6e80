"""Fused linear + softmax cross-entropy, forward and backward: hand-written
CUDA for Hopper in ``csrc/fused_ce.cu`` (counterpart of
``hetu_tpu/kernels/fused_ce.py``).

``fused_linear_nll_fwd`` replaces ``hetu_tpu/kernels/fused_ce.py:
_fused_fwd`` (body ``_fwd_kernel``): per row of ``h`` (N, D), the
logsumexp over the vocabulary of ``h·Wᵀ + b`` (``w_layout="vd"``, W is
(V, D), the tied-embedding orientation) or ``h·W + b`` (``"dv"``, W is
(D, V), the LM-head orientation), and the target's logit, without the
(N, V) logits in device memory. ``fused_linear_nll_bwd`` replaces
``_fused_bwd`` (bodies ``_bwd_dh_kernel``, ``_bwd_dw_kernel``): with
``g = (softmax − onehot)·ct`` recomputed tile by tile from the forward's
``lse``, ``dh`` in h's dtype, ``dW`` in W's dtype and ``db`` in f32.
``fused_linear_nll`` returns ``lse − target logit`` as (N,) f32. It
serves BERT's MLM loss (one forward and one backward launch per training
step) and the LM ``loss_fn``.

Bounds on an H100 SXM at the BERT-base MLM shape (N = 32·20 = 640,
V = 30522, D = 768, bf16): forward 2·N·V·D = 30 GFLOP (30 us of
tensor-core time, 14 us of memory time); backward 3·2·N·V·D = 90 GFLOP
(91 us) against 94 MB of W and dW (28 us). Both compute-bound. The
forward splits the vocabulary across blocks to fill the SMs, each block
keeping the online (m, l, target logit) of its rows over its run of vocab
tiles, and merges the splits in a second pass, in split order; its split
is :func:`fwd_plan`'s. The backward walks the vocabulary in chunks,
computing the logits once per chunk into an N × chunk slab of g that its
dh and dW products read; its split is :func:`bwd_plan`'s, which the C
launch loop walks as given. In bf16 every product of both runs on the
tensor cores (wgmma, bf16 operands, f32 accumulators; the backward's slab
is bf16), in f32 on the CUDA cores (the source's header has the design).
Each wrapper counts its CUDA kernels as one launch.

The backward dispatches under the mode the forward ran under
(``registry.bind``).

``_linear_nll_fwd_plain`` is ``_fwd_kernel``'s online logsumexp as a
PyTorch loop over the same vocab tiles, and ``_linear_nll_bwd_plain`` the
backward's ``(softmax − onehot)·ct`` over those tiles: what a CPU tensor
runs, what ``kernels="off"`` runs, and the oracles the kernels are held
against.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import torch

from . import _build, registry

_SRC = "fused_ce"
DEFAULT_BLOCK_N = 128
DEFAULT_BLOCK_V = 512
_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the backward: the g slab's cap (16 MB: a chunk's slab, with the chunk of
# W beside it, stays in the 50 MB L2 between the products that read it);
# the output tile of the f32 kernels (kTile in csrc/fused_ce.cu), and the
# bf16 kernels' output tile and the depth of one of their stages (kTcM =
# kTcN, kTcK); the forward's vocab tile and row block are the same: 64 and
# 64 in f32 (kBV, kBN), 128 and 128 in bf16
SLAB_BYTES = 16 << 20
_F32_TILE = 64
_TC_TILE, _TC_DEPTH = 128, 64


class ChunkLaunch(typing.NamedTuple):
    """One vocab chunk's launches: its columns ``[c0, c0 + cw)``, the grids
    of its logits/g, dh and dW kernels, and the dh splits: split ``z`` (the
    dh kernel's ``blockIdx.z``) adds the chunk's columns
    ``[bounds[z], bounds[z + 1])`` to dh partial ``z``."""
    c0: int
    cw: int
    g_grid: tuple
    dh_grid: tuple
    dw_grid: tuple
    bounds: tuple


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's work split, which ``hetu_fused_linear_nll_bwd``
    launches as given: the g slab's row stride ``chunk`` (columns), the
    count ``n_split`` of dh partial buffers (the first chunk stores each of
    them, later chunks add to as many as they split into), and one
    :class:`ChunkLaunch` a chunk, in launch order."""
    chunk: int
    n_split: int
    chunks: tuple


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward's work split, which ``hetu_fused_linear_nll_fwd``
    launches as given: vocab tiles of ``tile`` positions, row blocks of
    ``row_block`` rows, and the grid (row blocks, ``n_split``), split ``z``
    taking tiles ``[z · tiles_per_split, (z + 1) · tiles_per_split)`` of the
    ``ceil(V / tile)``, cut at the last."""
    tile: int
    row_block: int
    tiles_per_split: int
    n_split: int


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def fwd_plan(n_rows, vocab, dtype, sm_count=132):
    """The forward's work split for ``n_rows`` rows against a vocabulary
    of ``vocab`` on a card of ``sm_count`` SMs: the kernel's tile and row
    block by dtype (f32 64 × 64 on the CUDA cores, bf16 128 × 128 on the
    tensor cores), and as many equal splits of the vocabulary as keep the
    grid within two blocks an SM (the bf16 kernel's shared memory allows
    two), so that the grid is one wave; at least one split a row block."""
    t = _TC_TILE if dtype == torch.bfloat16 else _F32_TILE
    n_tiles = _cdiv(vocab, t)
    want = max(1, min(n_tiles, 2 * sm_count // _cdiv(max(n_rows, 1), t)))
    per_split = _cdiv(n_tiles, want)
    return FwdPlan(t, t, per_split, _cdiv(n_tiles, per_split))


@functools.lru_cache(maxsize=64)
def bwd_plan(n_rows, depth, vocab, dtype, w_dv, sm_count=132):
    """The backward's work split for an ``(n_rows, depth)`` h against a
    vocabulary of ``vocab``, W in layout "dv" when ``w_dv``, on a card of
    ``sm_count`` SMs.

    f32 (the CUDA-core kernels' split): chunks of 64-column tiles with an
    f32 slab of at most ``SLAB_BYTES``; dh partials so that the dh
    product's 64 × 64 tiles fill about two blocks per SM, each at least 512
    columns deep, a chunk's columns split into runs of
    ``ceil(cw / n_split)``. bf16: chunks of 128 columns with a bf16 slab of
    at most ``SLAB_BYTES``, the vocabulary cut into equal chunks; dh
    partials so that the dh product's 128 × 128 tiles fill about one block
    per SM, each at least four 64-deep stages of the first chunk, a chunk's
    64-deep stages split evenly over ``min(n_split, stages)`` partials."""
    n = max(n_rows, 1)
    if dtype == torch.float32:
        t = _F32_TILE
        chunk = min(max(SLAB_BYTES // 4 // n // t, 1), _cdiv(vocab, t)) * t
        out_tiles = _cdiv(n_rows, t) * _cdiv(depth, t)
        n_split = min(max(_cdiv(2 * sm_count, out_tiles), 1),
                      max(chunk // 512, 1))

        def bounds(cw):
            return tuple(range(0, cw, _cdiv(cw, n_split))) + (cw,)
    else:
        t = _TC_TILE
        cap = max(SLAB_BYTES // 2 // n // t, 1) * t
        per_chunk = _cdiv(vocab, _cdiv(vocab, cap))   # equal chunks <= cap
        chunk = _cdiv(per_chunk, t) * t
        out_tiles = _cdiv(n_rows, t) * _cdiv(depth, t)
        n_split = min(max(_cdiv(sm_count, out_tiles), 1),
                      max(_cdiv(min(chunk, vocab), _TC_DEPTH) // 4, 1))

        def bounds(cw):
            stages = _cdiv(cw, _TC_DEPTH)
            ns = min(n_split, stages)
            return tuple(min(z * stages // ns * _TC_DEPTH, cw)
                         for z in range(ns + 1))
    chunks = []
    for c0 in range(0, vocab, chunk):
        cw = min(chunk, vocab - c0)
        kb = bounds(cw)
        dw = ((_cdiv(depth, t), _cdiv(cw, t)) if w_dv
              else (_cdiv(cw, t), _cdiv(depth, t)))
        chunks.append(ChunkLaunch(
            c0, cw, (_cdiv(n_rows, t), _cdiv(cw, t)),
            (_cdiv(n_rows, t), _cdiv(depth, t), len(kb) - 1), dw, kb))
    return BwdPlan(chunk, n_split, tuple(chunks))


@functools.lru_cache(maxsize=64)
def _plan_arrays(plan, device):
    """The plan as ``hetu_fused_linear_nll_bwd`` reads it: a host table of
    int64, one row a chunk (c0, cw, the g grid's x and y, the dh grid's x,
    y and z, the dW grid's x and y), and the dh splits' bounds on the
    device, ``n_split + 1`` int32 a chunk (a chunk of fewer splits repeats
    its last bound)."""
    table = torch.tensor([(c.c0, c.cw, *c.g_grid, *c.dh_grid, *c.dw_grid)
                          for c in plan.chunks], dtype=torch.int64)
    width = plan.n_split + 1
    bounds = torch.tensor([c.bounds + c.bounds[-1:] * (width - len(c.bounds))
                           for c in plan.chunks], dtype=torch.int32)
    return table, bounds.to(device)


def should_fuse(flag, mesh=None, device=None) -> bool:
    """The one gating rule for config flags ('auto' | True | False), as in
    the reference with the card in the TPU's place: 'auto' fuses for
    tensors on a CUDA device; a mesh keeps the unfused form."""
    if mesh is not None:
        return False
    return flag is True or (flag == "auto" and device is not None
                            and torch.device(device).type == "cuda")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p, sizes as c_int64)."""
    lib = _build.load(_SRC)
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hetu_fused_linear_nll_fwd.argtypes = [
        P, P, P, P, P, P, P, I64, I64, I64, I64, I64, I64, I64, I, I, P]
    lib.hetu_fused_linear_nll_fwd.restype = I
    lib.hetu_fused_linear_nll_bwd.argtypes = [
        P, P, P, P, P, P, P, P, P, P, P, P, I64, I64, I64, I64, I64, P, I64,
        P, I, I, P]
    lib.hetu_fused_linear_nll_bwd.restype = I
    return lib


def _vocab(w, w_dv):
    return w.shape[1] if w_dv else w.shape[0]


def _linear_nll_fwd_plain(h, w, b, targets, *, block_n, block_v, w_dv):
    """``_fwd_kernel`` in PyTorch: the online (m, l, target logit) over
    vocab tiles of ``block_v``. Rows are independent, so all rows go at
    once (``block_n`` only sizes the kernel's row blocks in the reference).
    The reference pads the last tile with -1e30 scores, which add exactly
    0 to l; the loop stops at V instead. Returns ``(lse, tl)``, (N,) f32."""
    del block_n
    hf = h.float()
    N, V = h.shape[0], _vocab(w, w_dv)
    m = torch.full((N,), _NEG_INF, device=h.device)
    l = torch.zeros((N,), device=h.device)
    tl = torch.zeros((N,), device=h.device)
    for v0 in range(0, V, block_v):
        v1 = min(v0 + block_v, V)
        if w_dv:
            s = torch.matmul(hf, w[:, v0:v1].float())
        else:
            s = torch.matmul(hf, w[v0:v1].float().t())
        s = s + b[v0:v1].float()
        hit = torch.arange(v0, v1, device=h.device)[None, :] == targets[:, None]
        tl = tl + torch.where(hit, s, 0.0).sum(1)
        m_new = torch.maximum(m, s.amax(1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(1)
        m = m_new
    return m + torch.log(torch.clamp_min(l, 1e-30)), tl


def _linear_nll_fwd_kernel(h, w, b, targets, *, block_n, block_v, w_dv):
    """Launch the partial kernel over :func:`fwd_plan`'s (row blocks,
    vocab splits) (bf16: ``linear_nll_fwd_tc_kernel``, f32:
    ``linear_nll_partial_kernel``) and ``linear_nll_combine_kernel`` after
    it, counted as one launch; returns ``(lse, tl)``."""
    del block_n, block_v   # the kernels' tiles are their own
    N, D = h.shape
    V = _vocab(w, w_dv)
    lib = _lib()
    dev = h.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fwd_plan(N, V, h.dtype, sms)
    part = torch.empty((3, plan.n_split, N), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    tl = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hetu_fused_linear_nll_fwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), targets.data_ptr(),
            part.data_ptr(), lse.data_ptr(), tl.data_ptr(), N, D, V,
            plan.tile, plan.row_block, plan.tiles_per_split, plan.n_split,
            int(w_dv), _DTYPE_CODE[h.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_linear_nll_fwd: kernel launch failed with "
                           f"CUDA error {rc}")
    _FUSED.launches += 1
    return lse, tl


def _linear_nll_eligible(h, w, b, targets, *, w_dv, **_kw):
    for nm, x in (("h", h), ("w", w), ("b", b), ("targets", targets)):
        if x.device != h.device:
            return False, f"{nm} is on {x.device}, the call is on {h.device}"
        if not x.is_contiguous():
            return False, f"{nm} is not contiguous"
    if h.dtype not in _DTYPE_CODE or w.dtype != h.dtype:
        return False, (f"h and w must both be float32 or both bfloat16, got "
                       f"{h.dtype} and {w.dtype}")
    if h.dim() != 2 or w.dim() != 2 or h.numel() == 0:
        return False, (f"h must be a non-empty (N, D) and w a 2-d tensor, got "
                       f"{tuple(h.shape)} and {tuple(w.shape)}")
    D, V = h.shape[1], _vocab(w, w_dv)
    if (w.shape[0] if w_dv else w.shape[1]) != D or V == 0:
        return False, (f"w {tuple(w.shape)} does not match h's depth {D} in "
                       f"layout {'dv' if w_dv else 'vd'}")
    if b.dtype != torch.float32 or tuple(b.shape) != (V,):
        return False, f"b must be float32 of shape ({V},), got {b.dtype} {tuple(b.shape)}"
    if targets.dtype != torch.int32 or tuple(targets.shape) != (h.shape[0],):
        return False, (f"targets must be int32 of shape ({h.shape[0]},), got "
                       f"{targets.dtype} {tuple(targets.shape)}")
    return True, None


_FUSED = registry.register_kernel(
    "fused_linear_nll_fwd", kernel_fn=_linear_nll_fwd_kernel,
    plain_fn=_linear_nll_fwd_plain, eligibility=_linear_nll_eligible)


def _linear_nll_bwd_plain(h, w, b, targets, lse, ct, *, block_n, block_v,
                          w_dv):
    """``_fused_bwd`` in PyTorch: over vocab tiles of ``block_v``, the
    logits tile recomputed and ``g = (exp(s − lse) − onehot)·ct``, then
    ``dh += g·W_tileᵀ`` (``g·W_tile`` for ``vd``), the tile's dW and db.
    Returns ``(dh, dW, db)`` in h's, w's dtype and f32."""
    del block_n
    hf = h.float()
    N, V = h.shape[0], _vocab(w, w_dv)
    dh = torch.zeros(hf.shape, device=h.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    db = torch.empty((V,), dtype=torch.float32, device=h.device)
    for v0 in range(0, V, block_v):
        v1 = min(v0 + block_v, V)
        wt = w[:, v0:v1].float().t() if w_dv else w[v0:v1].float()  # (bv, D)
        s = torch.matmul(hf, wt.t()) + b[v0:v1].float()
        hit = torch.arange(v0, v1, device=h.device)[None, :] == targets[:, None]
        g = (torch.exp(s - lse[:, None]) - hit.float()) * ct[:, None]
        dh += torch.matmul(g, wt)
        gt_h = torch.matmul(g.t(), hf)                          # (bv, D)
        if w_dv:
            dw[:, v0:v1] = gt_h.t()
        else:
            dw[v0:v1] = gt_h
        db[v0:v1] = g.sum(0)
    return dh.to(h.dtype), dw.to(w.dtype), db


def _linear_nll_bwd_kernel(h, w, b, targets, lse, ct, *, block_n, block_v,
                           w_dv):
    """Launch the chunks of :func:`bwd_plan`: per chunk the logits/g kernel
    (g into an N × chunk slab), the dh and dW products (and, f32, the db
    column sums), then the sums of the dh partials (and, bf16, of db's
    column partials); CUDA kernels counted as one launch. Returns
    ``(dh, dW, db)``."""
    del block_n, block_v   # the kernels' tiles are their own
    N, D = h.shape
    V = _vocab(w, w_dv)
    lib = _lib()
    dev = h.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = bwd_plan(N, D, V, h.dtype, w_dv, sms)
    table, bounds = _plan_arrays(plan, dev)
    g = torch.empty((N, plan.chunk), dtype=h.dtype, device=dev)
    dh_part = torch.empty((plan.n_split, N, D), dtype=torch.float32,
                          device=dev)
    # bf16: db's column partials, one row per row block of the g grid
    bf16 = h.dtype == torch.bfloat16
    db_part = torch.empty((plan.chunks[0].g_grid[0], V) if bf16 else (0,),
                          dtype=torch.float32, device=dev)
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)
    db = torch.empty((V,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.hetu_fused_linear_nll_bwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), targets.data_ptr(),
            lse.data_ptr(), ct.data_ptr(), g.data_ptr(), dh_part.data_ptr(),
            db_part.data_ptr(), dh.data_ptr(), dw.data_ptr(), db.data_ptr(),
            N, D, V, plan.chunk, plan.n_split, table.data_ptr(),
            len(plan.chunks), bounds.data_ptr(), int(w_dv),
            _DTYPE_CODE[h.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_linear_nll_bwd: kernel launch failed with "
                           f"CUDA error {rc}")
    _FUSED_BWD.launches += 1
    return dh, dw, db


def _linear_nll_bwd_eligible(h, w, b, targets, lse, ct, *, w_dv, **_kw):
    ok, reason = _linear_nll_eligible(h, w, b, targets, w_dv=w_dv)
    if not ok:
        return ok, reason
    for nm, x in (("lse", lse), ("ct", ct)):
        if (x.device != h.device or x.dtype != torch.float32
                or tuple(x.shape) != (h.shape[0],) or not x.is_contiguous()):
            return False, (f"{nm} must be a contiguous float32 "
                           f"({h.shape[0]},) tensor on {h.device}, got "
                           f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return True, None


_FUSED_BWD = registry.register_kernel(
    "fused_linear_nll_bwd", kernel_fn=_linear_nll_bwd_kernel,
    plain_fn=_linear_nll_bwd_plain, eligibility=_linear_nll_bwd_eligible)


class _FusedLinearNll(torch.autograd.Function):
    """Forward and backward through the registry, both under the mode the
    forward ran under; the forward saves ``lse`` for the backward."""

    @staticmethod
    def forward(ctx, h, w, b, targets, block_n, block_v, w_dv):
        ctx.dispatch = registry.bind(registry.dispatch)
        lse, tl = registry.dispatch("fused_linear_nll_fwd", h, w, b, targets,
                                    block_n=block_n, block_v=block_v,
                                    w_dv=w_dv)
        ctx.save_for_backward(h, w, b, targets, lse)
        ctx.blocks = (block_n, block_v, w_dv)
        return lse - tl

    @staticmethod
    def backward(ctx, dnll):
        h, w, b, targets, lse = ctx.saved_tensors
        block_n, block_v, w_dv = ctx.blocks
        dh, dw, db = ctx.dispatch(
            "fused_linear_nll_bwd", h, w, b, targets, lse,
            dnll.float().contiguous(), block_n=block_n, block_v=block_v,
            w_dv=w_dv)
        return dh, dw, db, None, None, None, None


def fused_linear_nll(h, w, b, targets, block_n=DEFAULT_BLOCK_N,
                     block_v=DEFAULT_BLOCK_V, w_layout="vd"):
    """Per-row NLL of ``softmax(linear(h))`` without materializing the
    (N, V) logits. h: (N, D); b: (V,) f32; targets: (N,) integer; w: (V, D)
    with ``w_layout="vd"`` (logits = h @ w^T + b) or (D, V) with
    ``w_layout="dv"`` (logits = h @ w + b). Returns (N,) f32."""
    if w_layout not in ("vd", "dv"):
        raise ValueError(f"w_layout must be 'vd' or 'dv', got {w_layout!r}")
    w_dv = w_layout == "dv"
    N, V = h.shape[0], _vocab(w, w_dv)
    block_n = min(block_n, max(N, 1))
    block_v = min(block_v, max(V, 1))
    return _FusedLinearNll.apply(h, w, b, targets.to(torch.int32), block_n,
                                 block_v, w_dv)
