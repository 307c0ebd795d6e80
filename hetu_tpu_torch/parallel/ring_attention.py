"""Ring attention: exact attention over a sequence split on a group of
ranks (counterpart of ``hetu_tpu/parallel/ring_attention.py``).

Rank ``s`` of the ``sp`` group holds rows ``[s·T/sp, (s+1)·T/sp)`` of q, k
and v. Each step it attends its q chunk to the k/v chunk it holds, then
passes that chunk to the next rank and receives the previous one's, so at
step ``j`` it holds chunk ``(s - j) mod sp``, as the reference's
``ppermute`` ring does. The partial results merge by log-sum-exp in f32
(the reference's ``_merge``). A key-padding bias ``(B, T/sp)`` rotates with
its chunk. k and v travel with their ``kv_heads`` unrepeated heads; each
rank expands them to its query heads (``expand``), which gives the
reference's values with less traffic.

The ring is one ``torch.autograd.Function`` whose block is the port's own
flash kernel. The forward runs #4 (``flash_attention_fwd``, which returns
``(o, lse)``) at each step, ``causal`` on the diagonal chunk and not on
earlier ones; under causal a later chunk adds nothing to the merge and is
skipped (the reference computes it fully masked). The backward runs #5 at
each step from the global ``o`` and ``lse``: dq accumulates on the rank,
and dk and dv travel round the ring with their chunk, reaching their owner
after sp steps. Both go through the kernel registry, so a CUDA tensor
launches the kernels or raises, and a CPU tensor (or ``kernels="off"``)
takes their plain versions. A chunk whose length the kernels' blocks do
not divide raises (``flash_attention._resolve``); it never falls back.
Without a group (sp of 1) the ring is its one diagonal step.

A row that sees no key in a chunk (every key padded) keeps the reference's
guard: that chunk gives it ``lse = -1e30`` and nothing, and a row that sees
no key at all comes out 0 (``_NEG_INF / 2``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import registry
from ..kernels.flash_attention import (DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q,
                                       _resolve)
from . import multihost

_NEG_INF = -1e30


def _merge(acc_num, acc_lse, num, lse):
    """Log-sum-exp merge of two partial attention results."""
    new_lse = torch.logaddexp(acc_lse, lse)
    a = torch.exp(acc_lse - new_lse)
    b = torch.exp(lse - new_lse)
    return acc_num * a[..., None] + num * b[..., None], new_lse


def _expand(x, expand):
    """k or v with its kv heads repeated to the query heads they serve."""
    return x if expand is None else x.index_select(1, expand)


def _ring(group) -> tuple:
    """``(n, s)``: the ring's size and this rank's place in it (one rank
    without a group)."""
    if group is None:
        return 1, 0
    return (torch.distributed.get_world_size(group),
            torch.distributed.get_rank(group))


def _heads_sum(dx, expand, n_kv):
    """The gradient of the unrepeated kv heads: each query head's summed
    into the kv head it read (f32)."""
    if expand is None:
        return dx.float()
    out = torch.zeros(dx.shape[:1] + (n_kv,) + dx.shape[2:],
                      dtype=torch.float32, device=dx.device)
    return out.index_add_(1, expand, dx.float())


class _RingFlash(torch.autograd.Function):
    """Ring attention with #4 and #5 as its blocks (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, k_bias, group, causal, scale, expand, blocks):
        ctx.dispatch = registry.bind(registry.dispatch)
        n, s = _ring(group)
        block_q, block_k = blocks
        acc_num = acc_lse = None
        chunk = [k, v] + ([] if k_bias is None else [k_bias])
        for j in range(n):
            src = (s - j) % n
            pending = None
            if j < n - 1:
                pending = multihost.RingTransfer(chunk, group)
            if not (causal and src > s):
                o, lse = registry.dispatch(
                    "flash_attention_fwd", q,
                    _expand(chunk[0], expand).contiguous(),
                    _expand(chunk[1], expand).contiguous(),
                    chunk[2] if k_bias is not None else None, scale=scale,
                    causal=causal and src == s, block_q=block_q,
                    block_k=block_k)
                # a chunk with no visible key for a row adds nothing (the
                # reference's block gives lse -1e30 and a zero output)
                seen = lse > _NEG_INF / 2
                num = torch.where(seen[..., None], o.float(), 0.0)
                lse = torch.where(seen, lse, _NEG_INF)
                if acc_num is None:
                    acc_num, acc_lse = num, lse
                else:
                    acc_num, acc_lse = _merge(acc_num, acc_lse, num, lse)
            if pending is not None:
                chunk = pending.wait()
        seen = acc_lse > _NEG_INF / 2
        out = torch.where(seen[..., None], acc_num, 0.0).to(q.dtype)
        ctx.save_for_backward(q, k, v, k_bias, out, acc_lse, expand)
        ctx.group, ctx.causal, ctx.scale, ctx.blocks = (group, causal, scale,
                                                        blocks)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, k_bias, o, lse, expand = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        block_q, block_k = ctx.blocks
        n, s = _ring(group)
        seen = lse > _NEG_INF / 2
        # a row that saw no key came out 0: no gradient reaches it
        do = torch.where(seen[..., None], do, 0).to(q.dtype).contiguous()
        lse = torch.where(seen, lse, 0.0).contiguous()
        n_kv = k.shape[1]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        chunk = [k, v] + ([] if k_bias is None else [k_bias])
        for j in range(n):
            src = (s - j) % n
            if not (causal and src > s):
                dqj, dkj, dvj = ctx.dispatch(
                    "flash_attention_bwd", q,
                    _expand(chunk[0], expand).contiguous(),
                    _expand(chunk[1], expand).contiguous(), o, lse, do,
                    chunk[2] if k_bias is not None else None, scale=scale,
                    causal=causal and src == s, block_q=block_q,
                    block_k=block_k)
                dq += dqj.float()
                dk += _heads_sum(dkj, expand, n_kv)
                dv += _heads_sum(dvj, expand, n_kv)
            if n == 1:
                break
            # the gradients travel with their chunk: after n shifts they
            # are back at its owner
            travel = ([] if j == n - 1 else chunk) + [dk, dv]
            got = multihost.ring_exchange(travel, group)
            if j < n - 1:
                chunk = got[:len(chunk)]
            dk, dv = got[-2:]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)


def ring_attention(q, k, v, k_bias=None, *, group, causal: bool = True,
                   scale: Optional[float] = None, expand=None,
                   block_q: int = DEFAULT_BLOCK_Q,
                   block_k: int = DEFAULT_BLOCK_K):
    """q ``(B, H, T/sp, hd)``; k, v ``(B, H_kv, T/sp, hd)``, this rank's
    chunk of the sequence split over ``group`` (None: one rank);
    ``k_bias``: an optional ``(B, T/sp)`` f32 per-key additive bias, split
    like k's sequence. ``expand``: a LongTensor mapping each query head to
    the kv head it reads (None: one to one). Returns this rank's output
    chunk ``(B, H, T/sp, hd)`` in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, block_q, block_k = _resolve(q, scale, block_q, block_k)
    if k_bias is not None:
        k_bias = k_bias.float().contiguous()
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            k_bias, group, causal, scale, expand,
                            (block_q, block_k))
