"""Flash attention, forward and backward: hand-written CUDA for Hopper in
``csrc/flash_attention.cu`` (counterpart of
``hetu_tpu/kernels/flash_attention.py``).

``flash_attention_fwd`` replaces ``hetu_tpu/kernels/flash_attention.py:
_fwd_pallas`` (body ``_fwd_kernel``): blockwise attention over
``(batch, heads, seq, head_dim)`` with an online softmax, causal or not,
with an optional per-key additive bias ``k_bias`` ``(batch, seq)``, that
returns ``o`` and the row logsumexp ``lse`` ``(batch, heads, seq)`` f32.
``flash_attention_bwd`` replaces ``_bwd_pallas`` (bodies
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``): ``(dq, dk, dv)`` in q's dtype,
each tile's probabilities recomputed from ``(q, k, lse)``; ``k_bias`` gets
no gradient, as in the reference's ``_flash_bwd``. They serve every
encoder layer of BERT (``models/transformer.py``'s ``_attention_core``
with ``impl="flash"``): per BERT-base training step with remat, 24 forward
launches (12 in the forward, 12 in the recompute) and 12 backward ones.

Bounds on an H100 SXM at the BERT-base shape (B=32, H=12, S=128, D=64,
bf16): forward 4·B·H·S²·D = 1.6 GFLOP against 25 MB of q, k, v and o
(7.5 us of memory time); backward 10·B·H·S²·D = 4.0 GFLOP against 50 MB
of q, k, v, o, dO, dq, dk and dv (15 us). Both memory-bound. In bf16 both
run their products on the tensor cores (mma.sync, bf16 tiles in shared
memory, f32 accumulators): the forward with FlashAttention-2's online
softmax in registers, p rounded once to bf16 as it enters p·V; the
backward's dq kernel computing ``delta = rowsum(dO·O)`` for its dkv kernel.
In f32 both do their products with f32 FMAs on the CUDA cores, bound by
their own arithmetic. None writes an (S, S) tensor (the source's header
has the design); the grids and the tiles each block visits are
:func:`tile_plan`'s.

``flash_attention`` is a ``torch.autograd.Function`` whose backward
dispatches under the mode its forward ran under (``registry.bind``).

``_flash_fwd_plain`` is ``_fwd_kernel``'s online softmax as a blockwise
PyTorch loop over the same (block_q, block_k) tiles, and
``_flash_bwd_plain`` the blockwise backward of ``_bwd_blockwise`` with the
Pallas kernels' block skipping: what a CPU tensor runs, what
``kernels="off"`` runs, and the oracles the kernels are held against.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build, registry

_SRC = "flash_attention"
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # the head_dims csrc/flash_attention.cu is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tile: 64 query rows (f32 forward, dq) or keys (dkv) a block,
# 64 keys (query rows) a step (kBQ = kBK in csrc/flash_attention.cu); the
# bf16 forward's blocks hold FWD_ROWS query rows (kFwdRows), 64 keys a step
TILE = 64
FWD_ROWS = 128


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The work split that ``hetu_flash_attention_fwd`` and
    ``hetu_flash_attention_bwd`` launch as given: the grid
    ``(B·H, ceil(S / TILE))`` of the f32 forward and of the backward's dq
    and dkv kernels; for each query tile, how many key tiles its f32
    forward and its dq block visit (from the first on); for each key tile,
    the first query tile its dkv block visits (to the last); the grid
    ``(B·H, ceil(S / FWD_ROWS))`` of the bf16 forward, and for each of its
    blocks how many key tiles it visits: its query tiles' most."""
    grid: tuple
    dq_key_tiles: tuple
    dkv_first_query_tile: tuple
    fwd_grid: tuple
    fwd_key_tiles: tuple


@functools.lru_cache(maxsize=64)
def _visit_tiles(seq, causal, block_q, block_k):
    """``(dq_key_tiles, dkv_first_query_tile)`` of :class:`TilePlan`: the
    tiles holding every (query row, key) pair the reference visits, by
    :func:`_visit_limit`'s rule. The limit rises with the row, so a query
    tile's last row visits the most keys, and the rows that visit a key
    tile are those from the first whose limit lies past its first key."""
    n_t = -(-seq // TILE)
    limit = _visit_limit(seq, causal, block_q, block_k, "cpu")
    if limit is None:
        return (n_t,) * n_t, (0,) * n_t
    limit = limit.clamp(max=seq).tolist()
    dq = tuple(-(-limit[min((i + 1) * TILE, seq) - 1] // TILE)
               for i in range(n_t))
    first, row = [], 0
    for j in range(n_t):
        while limit[row] <= j * TILE:
            row += 1
        first.append(row // TILE)
    return dq, tuple(first)


def tile_plan(batch, heads, seq, causal, block_q, block_k):
    """The kernels' work split for ``(batch, heads, seq, ·)`` inputs and
    the caller's ``(block_q, block_k)`` blocks."""
    dq, dkv = _visit_tiles(seq, bool(causal), block_q, block_k)
    per = FWD_ROWS // TILE
    fwd = tuple(max(dq[i:i + per]) for i in range(0, len(dq), per))
    return TilePlan((batch * heads, len(dq)), dq, dkv,
                    (batch * heads, len(fwd)), fwd)


@functools.lru_cache(maxsize=64)
def _plan_array(plan, device):
    """The plan's tiles as the kernels read them: ``dq_key_tiles``, then
    ``dkv_first_query_tile``, then ``fwd_key_tiles``, int32 on the
    device."""
    return torch.tensor(plan.dq_key_tiles + plan.dkv_first_query_tile
                        + plan.fwd_key_tiles, dtype=torch.int32,
                        device=device)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (pointers and the
    stream as c_void_p, sizes as c_int64)."""
    lib = _build.load(_SRC)
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.hetu_flash_attention_fwd.argtypes = [
        P, P, P, P, P, P, I64, I64, I64, ctypes.c_float, ctypes.c_int, I64,
        I64, I64, I64, P, ctypes.c_int, P]
    lib.hetu_flash_attention_fwd.restype = ctypes.c_int
    lib.hetu_flash_attention_bwd.argtypes = [
        P, P, P, P, P, P, P, P, P, P, P, I64, I64, I64, ctypes.c_float,
        ctypes.c_int, I64, I64, I64, I64, P, ctypes.c_int, P]
    lib.hetu_flash_attention_bwd.restype = ctypes.c_int
    return lib


def _causal_upper_kb(q_start, block_q, block_k):
    """First key block strictly above the diagonal, by ceil division (the
    reference's ``_causal_upper_kb``)."""
    return (q_start + block_q + block_k - 1) // block_k


def _resolve(q, scale, block_q, block_k):
    """The reference's ``_resolve``: default scale, blocks cut to the
    sequence, and a sequence the blocks must divide."""
    s = q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"seq_len {s} must divide blocks ({block_q},{block_k})")
    return scale, block_q, block_k


def _flash_fwd_plain(q, k, v, k_bias, *, scale, causal, block_q, block_k):
    """``_fwd_kernel`` in PyTorch: for each q block, the online softmax over
    its key blocks (up to the diagonal when causal). Returns ``(o, lse)``."""
    B, H, S, D = q.shape
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    kb = None if k_bias is None else k_bias.float()[:, None, None, :]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    n_kb = S // block_k
    for q0 in range(0, S, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        acc = torch.zeros((B, H, block_q, D), device=q.device)
        m = torch.full((B, H, block_q), _NEG_INF, device=q.device)
        l = torch.zeros((B, H, block_q), device=q.device)
        upper = _causal_upper_kb(q0, block_q, block_k) if causal else n_kb
        for k0 in range(0, upper * block_k, block_k):
            s = torch.matmul(qb, kf[:, :, k0:k0 + block_k].transpose(-1, -2))
            if kb is not None:
                s = s + kb[..., k0:k0 + block_k]
            if causal:
                q_pos = torch.arange(q0, q0 + block_q, device=q.device)
                k_pos = torch.arange(k0, k0 + block_k, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p, vf[:, :, k0:k0 + block_k])
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        o[:, :, q0:q0 + block_q] = (acc / l[..., None]).to(q.dtype)
        lse[:, :, q0:q0 + block_q] = m + torch.log(l)
    return o, lse


def _flash_fwd_kernel(q, k, v, k_bias, *, scale, causal, block_q, block_k):
    """Launch the forward over :func:`tile_plan`'s grid, each block
    visiting its query rows' key tiles (bf16: ``flash_fwd_tc_kernel`` over
    ``fwd_grid``, f32: ``flash_fwd_kernel`` over ``grid``): returns
    ``(o, lse)``."""
    B, H, S, D = q.shape
    plan = tile_plan(B, H, S, causal, block_q, block_k)
    tiles = _plan_array(plan, q.device)
    if q.dtype == torch.bfloat16:
        grid, tiles = plan.fwd_grid, tiles[2 * plan.grid[1]:]
    else:
        grid = plan.grid
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.hetu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if k_bias is None else k_bias.data_ptr(), o.data_ptr(),
            lse.data_ptr(), H, S, D, float(scale), int(causal), block_q,
            block_k, *grid, tiles.data_ptr(), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with "
                           f"CUDA error {rc}")
    _FLASH.launches += 1
    return o, lse


def _flash_eligible(q, k, v, k_bias, **_kw):
    for nm, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.device.type != "cuda":
            return False, f"{nm} is on {x.device}, the call is on {q.device}"
        if x.dtype not in _DTYPE_CODE or x.dtype != q.dtype:
            return False, (f"{nm} must be float32 or bfloat16 like q, got "
                           f"{x.dtype}")
        if x.shape != q.shape:
            return False, (f"{nm} has shape {tuple(x.shape)}, q has "
                           f"{tuple(q.shape)}")
        if not x.is_contiguous():
            return False, f"{nm} is not contiguous"
    if q.dim() != 4 or q.numel() == 0:
        return False, f"q must be a non-empty (B, H, S, D) tensor, got {tuple(q.shape)}"
    if q.shape[-1] not in HEAD_DIMS:
        return False, f"head_dim {q.shape[-1]} is not one of {HEAD_DIMS}"
    if k_bias is not None:
        if k_bias.device != q.device:
            return False, f"k_bias is on {k_bias.device}, the call is on {q.device}"
        if k_bias.dtype != torch.float32:
            return False, f"k_bias must be float32, got {k_bias.dtype}"
        if tuple(k_bias.shape) != (q.shape[0], q.shape[2]):
            return False, (f"k_bias has shape {tuple(k_bias.shape)}, expected "
                           f"{(q.shape[0], q.shape[2])}")
        if not k_bias.is_contiguous():
            return False, "k_bias is not contiguous"
    return True, None


_FLASH = registry.register_kernel(
    "flash_attention_fwd", kernel_fn=_flash_fwd_kernel,
    plain_fn=_flash_fwd_plain, eligibility=_flash_eligible)


def _visit_limit(S, causal, block_q, block_k, device):
    """Per query row, one past the last key the reference's kernels visit
    (the ceil bound of ``_causal_upper_kb`` on the row's q block), or
    None when every key is visited."""
    if not causal:
        return None
    rows = torch.arange(S, device=device)
    q_start = rows // block_q * block_q
    return _causal_upper_kb(q_start, block_q, block_k) * block_k


def _flash_bwd_plain(q, k, v, o, lse, do, k_bias, *, scale, causal,
                     block_q, block_k):
    """``_bwd_blockwise`` in PyTorch: for each key block, every query row's
    probabilities recomputed as ``p = exp(s - lse)``, then dv, dk for the
    block and its share of dq; no (S, S) tensor. Keys the Pallas kernels
    never visit for a row (causal blocks above the diagonal) get p = 0, as
    there; only a fully masked row can tell. Returns ``(dq, dk, dv)`` in
    the inputs' dtype."""
    B, H, S, D = q.shape
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)                     # (B, H, S)
    limit = _visit_limit(S, causal, block_q, block_k, q.device)
    rows = torch.arange(S, device=q.device)
    dq = torch.zeros((B, H, S, D), device=q.device)
    dk = torch.empty((B, H, S, D), device=q.device)
    dv = torch.empty((B, H, S, D), device=q.device)
    for k0 in range(0, S, block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if k_bias is not None:
            s = s + k_bias.float()[:, None, None, k0:k0 + block_k]
        p_mask = None
        if causal:
            keys = torch.arange(k0, k0 + block_k, device=q.device)
            s = torch.where(rows[:, None] >= keys[None, :], s, _NEG_INF)
            p_mask = keys[None, :] < limit[:, None]
        p = torch.exp(s - lse[..., None])
        if p_mask is not None:
            p = torch.where(p_mask, p, 0.0)
        dv[:, :, k0:k0 + block_k] = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.matmul(ds, kb)
        dk[:, :, k0:k0 + block_k] = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_kernel(q, k, v, o, lse, do, k_bias, *, scale, causal,
                      block_q, block_k):
    """Launch the dq and the dkv kernel of :func:`tile_plan` (CUDA kernels
    counted as one launch); ``delta = rowsum(dO·O)`` in f32 is computed in
    that sequence (bf16: by the dq kernel; f32: by a kernel before it), as
    the reference computes it in XLA. Returns ``(dq, dk, dv)``."""
    B, H, S, D = q.shape
    plan = tile_plan(B, H, S, causal, block_q, block_k)
    tiles = _plan_array(plan, q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.hetu_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if k_bias is None else k_bias.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), H, S, D, float(scale), int(causal),
            block_q, block_k, *plan.grid, tiles.data_ptr(),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with "
                           f"CUDA error {rc}")
    _FLASH_BWD.launches += 1
    return dq, dk, dv


def _flash_bwd_eligible(q, k, v, o, lse, do, k_bias, **_kw):
    ok, reason = _flash_eligible(q, k, v, k_bias)
    if not ok:
        return ok, reason
    for nm, x in (("o", o), ("do", do)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            return False, (f"{nm} must match q's device, dtype and shape, got "
                           f"{x.device} {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            return False, f"{nm} is not contiguous"
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != tuple(q.shape[:3])
            or not lse.is_contiguous()):
        return False, (f"lse must be a contiguous float32 {tuple(q.shape[:3])} "
                       f"tensor on {q.device}, got {lse.dtype} "
                       f"{tuple(lse.shape)} on {lse.device}")
    return True, None


_FLASH_BWD = registry.register_kernel(
    "flash_attention_bwd", kernel_fn=_flash_bwd_kernel,
    plain_fn=_flash_bwd_plain, eligibility=_flash_bwd_eligible)


class _FlashFwd(torch.autograd.Function):
    """Forward and backward through the registry, both under the mode the
    forward ran under."""

    @staticmethod
    def forward(ctx, q, k, v, k_bias, causal, scale, block_q, block_k):
        ctx.dispatch = registry.bind(registry.dispatch)
        o, lse = registry.dispatch("flash_attention_fwd", q, k, v, k_bias,
                                   scale=scale, causal=causal,
                                   block_q=block_q, block_k=block_k)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse, k_bias)
        ctx.blocks = (causal, scale, block_q, block_k)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, k_bias = ctx.saved_tensors
        causal, scale, block_q, block_k = ctx.blocks
        dq, dk, dv = ctx.dispatch(
            "flash_attention_bwd", q, k, v, o, lse, do.contiguous(), k_bias,
            scale=scale, causal=causal, block_q=block_q, block_k=block_k)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_fwd(q, k, v, causal=True, scale=None,
                        block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                        k_bias=None):
    """Fused attention forward. q/k/v: (batch, heads, seq, head_dim).
    Returns ``(o, lse)``: ``o`` like q, ``lse`` (batch, heads, seq) f32.

    ``k_bias``: optional (batch, seq) float added to every score column —
    the key-padding mask form (0 valid / -1e30 padded)."""
    scale, block_q, block_k = _resolve(q, scale, block_q, block_k)
    return _FlashFwd.apply(q, k, v, k_bias, causal, scale, block_q, block_k)


def flash_attention(q, k, v, causal=True, scale=None,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    k_bias=None):
    """Fused attention (the reference's signature). Returns ``o``."""
    return flash_attention_fwd(q, k, v, causal, scale, block_q, block_k,
                               k_bias)[0]
