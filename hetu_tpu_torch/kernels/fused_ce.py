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
(91 us) against 94 MB of W and dW (28 us). Both compute-bound. The first
kernels do their products in f32 on the CUDA cores, so they are bound by
their own arithmetic. The forward splits the vocabulary across blocks to
fill the 132 SMs and merges the splits in a second pass; the backward
walks the vocabulary in chunks, computing the logits once per chunk into
an N × chunk slab of g (at most 16 MB) that its dh and dW products read
(the source's header has the design). Each wrapper counts its CUDA
kernels as one launch.

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
import functools

import torch

from . import _build, registry

_SRC = "fused_ce"
DEFAULT_BLOCK_N = 128
DEFAULT_BLOCK_V = 512
_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's grid aims at two blocks for each of the H100's 132 SMs
_TARGET_BLOCKS = 2 * 132
_ROWS_PER_BLOCK = 64


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
        P, P, P, P, P, P, P, I64, I64, I64, I64, I64, I, I, P]
    lib.hetu_fused_linear_nll_fwd.restype = I
    lib.hetu_linear_nll_tile_width.argtypes = []
    lib.hetu_linear_nll_tile_width.restype = I
    lib.hetu_fused_linear_nll_bwd.argtypes = [
        P, P, P, P, P, P, P, P, P, P, P, I64, I64, I64, I64, I64, I, I, P]
    lib.hetu_fused_linear_nll_bwd.restype = I
    lib.hetu_linear_nll_bwd_plan.argtypes = [I64, I64, I64, I64, P]
    lib.hetu_linear_nll_bwd_plan.restype = None
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
    """Launch ``linear_nll_partial_kernel`` over (row blocks, vocab splits)
    and ``linear_nll_combine_kernel`` after it; returns ``(lse, tl)``."""
    del block_n, block_v   # the kernel's tiles are its own (64 x 64)
    N, D = h.shape
    V = _vocab(w, w_dv)
    lib = _lib()
    n_tiles = -(-V // lib.hetu_linear_nll_tile_width())
    row_blocks = -(-N // _ROWS_PER_BLOCK)
    want = max(1, min(n_tiles, -(-_TARGET_BLOCKS // row_blocks)))
    per_split = -(-n_tiles // want)
    n_split = -(-n_tiles // per_split)        # no split is empty
    part = torch.empty((3, n_split, N), dtype=torch.float32, device=h.device)
    lse = torch.empty((N,), dtype=torch.float32, device=h.device)
    tl = torch.empty((N,), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.hetu_fused_linear_nll_fwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), targets.data_ptr(),
            part.data_ptr(), lse.data_ptr(), tl.data_ptr(), N, D, V,
            per_split, n_split, int(w_dv), _DTYPE_CODE[h.dtype],
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
    """Launch, per vocab chunk, ``linear_nll_bwd_g_kernel`` (g into an
    N × chunk f32 slab), the db column sums and the dh and dW products,
    then the sum of the dh partials (CUDA kernels counted as one launch);
    returns ``(dh, dW, db)``."""
    del block_n, block_v   # the kernels' tiles are their own
    N, D = h.shape
    V = _vocab(w, w_dv)
    lib = _lib()
    plan = (ctypes.c_int64 * 2)()
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    lib.hetu_linear_nll_bwd_plan(N, D, V, sms, plan)
    chunk, n_split = plan
    g = torch.empty((N, chunk), dtype=torch.float32, device=h.device)
    dh_part = torch.empty((n_split, N, D), dtype=torch.float32,
                          device=h.device)
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)
    db = torch.empty((V,), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.hetu_fused_linear_nll_bwd(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), targets.data_ptr(),
            lse.data_ptr(), ct.data_ptr(), g.data_ptr(), dh_part.data_ptr(),
            dh.data_ptr(), dw.data_ptr(), db.data_ptr(), N, D, V, chunk,
            n_split, int(w_dv), _DTYPE_CODE[h.dtype],
            torch.cuda.current_stream().cuda_stream)
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
