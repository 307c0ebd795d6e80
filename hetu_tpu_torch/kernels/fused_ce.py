"""Fused linear + softmax cross-entropy, forward: hand-written CUDA for
Hopper in ``csrc/fused_ce.cu`` (counterpart of
``hetu_tpu/kernels/fused_ce.py``).

``fused_linear_nll_fwd`` replaces ``hetu_tpu/kernels/fused_ce.py:
_fused_fwd`` (body ``_fwd_kernel``): per row of ``h`` (N, D), the
logsumexp over the vocabulary of ``h·Wᵀ + b`` (``w_layout="vd"``, W is
(V, D), the tied-embedding orientation) or ``h·W + b`` (``"dv"``, W is
(D, V), the LM-head orientation), and the target's logit, without the
(N, V) logits in device memory. ``fused_linear_nll`` returns
``lse − target logit`` as (N,) f32. It serves BERT's MLM loss (one launch
per ``pretrain_loss``) and the LM ``loss_fn``.

Bound on an H100 SXM at the BERT-base MLM shape (N = 32·20 = 640,
V = 30522, D = 768, bf16): 2·N·V·D = 30 GFLOP against 47 MB of W, i.e.
30 us of tensor-core time and 14 us of memory time — compute-bound. The
first kernel does its products in f32 on the CUDA cores, so it is bound by
its own arithmetic; it splits the vocabulary across blocks to fill the 132
SMs and merges the splits in a second small kernel (two launches, counted
as one; the source's header has the design).

Only the forward is ported; the backward (``_fused_bwd``) comes with the
training slice, and ``fused_linear_nll``'s backward raises.

``_linear_nll_fwd_plain`` is ``_fwd_kernel``'s online logsumexp as a
PyTorch loop over the same vocab tiles: what a CPU tensor runs, what
``kernels="off"`` runs, and the oracle the kernel is held against.
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


class _FusedLinearNll(torch.autograd.Function):
    """The forward through the registry; the backward is not ported."""

    @staticmethod
    def forward(ctx, h, w, b, targets, block_n, block_v, w_dv):
        lse, tl = registry.dispatch("fused_linear_nll_fwd", h, w, b, targets,
                                    block_n=block_n, block_v=block_v,
                                    w_dv=w_dv)
        return lse - tl

    @staticmethod
    def backward(ctx, dnll):
        raise NotImplementedError(
            "fused_linear_nll has no backward in hetu_tpu_torch yet: its "
            "backward kernels (hetu_tpu/kernels/fused_ce.py:_fused_bwd) come "
            "with the BERT pretraining slice (ROADMAP Queue 1, slice 5b)")


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
