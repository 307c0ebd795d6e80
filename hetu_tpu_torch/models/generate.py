"""Autoregressive generation with a KV cache (counterpart of
``hetu_tpu/models/generate.py``): greedy and top-k/temperature sampling,
beam search, EOS-aware early exit, ragged prompt batches and greedy
speculative decoding, for the causal LM of ``models/transformer.py``.

The key/value cache is preallocated once per call as ``(L, B, n_kv_heads,
max_len, head_dim)`` in ``cfg.dtype``: it keeps the unbroadcast GQA heads,
and rotated keys under RoPE. Each step writes its chunk's entries in place
and attends over the whole cache with a ``kpos <= qpos`` mask, so every
decode step has the same shapes whatever its position. The reference's
``lax.scan`` and ``while_loop`` are Python loops over positions; the EOS
loop reads one flag from the device a step to exit early, speculative
decoding one count a round.

Decoding reaches no Pallas kernel in the reference (its attention is an
einsum outside any kernel, ``hetu_tpu/models/generate.py:84-93``), so here
its products and softmax are PyTorch operations: the projections through
the trunk's ``_mm``/``_mm32`` helpers (the weights cast to ``cfg.dtype``
once per call, ``_Weights``, where the trunk casts them at each use), the
scores an f32 ``torch.matmul`` scaled by 1/sqrt(head_dim) and masked at
-1e30, an f32 softmax, and the probabilities cast to ``cfg.dtype``.

Randomness: a sampling key is an integer seed, and step ``t`` draws from a
generator seeded with ``fold_in(key, t)``, as the reference draws from
``jax.random.fold_in(key, t)``: skipping prefill steps never shifts the
draws. The bits differ from ``jax.random.categorical``'s.

Dense blocks only (no MoE, as the reference refuses it), causal configs
only. ``make_generate_fn(..., mesh=)`` decodes on a dp x tp mesh, as the
reference's: the params stay in their Megatron layout
(``transformer.shard_params``; each rank runs its heads and its ``d_ff``
columns, with the trunk's all-reduces), the KV cache is split batch over
dp and heads over tp (each rank's cache holds the kv heads its query heads
read: where tp does not divide ``kv_heads`` the head axis is replicated
over the ranks that share a head), the prompt's rows are split over dp
and every rank returns the whole batch's tokens and logits. Decoding never
gathers the weights.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import transformer as tfm
from ..parallel import mesh as meshlib
from ..parallel import multihost


_NORM_PARAMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


class _Weights:
    """``params`` made ready once per decode call, for every step to read:
    each layer's projection weights and biases in ``cfg.dtype`` (what
    ``_mm`` and the bias adds cast them to at each use; the norms' stay
    f32), and the LM head's ``tfm.head_matrix``. The arithmetic is
    ``transformer``'s, rounded at the same places."""

    def __init__(self, params, cfg, mesh=None):
        names = list(params["blocks"])
        self.params, self.cfg, self.mesh = params, cfg, mesh
        tp, t = meshlib.axis_size(mesh, "tp"), meshlib.axis_rank(mesh, "tp")
        _, self.nq, lo, hi = tfm.head_layout(cfg, tp, t)
        self.nkv = hi - lo
        # the query heads' kv heads where they do not group contiguously
        # (a rank whose query heads straddle two kv groups)
        e = tfm.kv_expand(cfg, tp, t, "cpu")
        g = self.nq // self.nkv
        self.kv_index = None
        if e is not None and (self.nq % self.nkv or not torch.equal(
                e, torch.arange(self.nq) // g)):
            self.kv_index = e.to(params["embed"].device)
        self.layers = [
            {n: x if n in _NORM_PARAMS else x.to(cfg.dtype)
             for n, x in zip(names, layer)}
            for layer in zip(*(params["blocks"][n].unbind(0)
                               for n in names))]
        self.head = tfm.head_matrix(params, cfg)

    def logits(self, h):
        return tfm.lm_head(self.params, h, self.cfg, self.head, self.mesh)


def _decode_layer(h, p, kc, vc, *, cfg, pos, visible, w=None):
    """One transformer block for a chunk of C new tokens against the cache
    (C = 1 is the decode step; C > 1 a prefill or a speculative verify
    chunk: causal within the chunk, full over the cached prefix).

    h: (B, C, D) at positions [pos, pos + C); kc, vc: (B, nkv, M, hd), one
    layer's cache, written in place at those positions; visible: (C, M),
    ``kpos <= qpos``. Returns the new h. Every dialect knob of
    ``transformer._block`` is mirrored here. ``w``: the call's
    ``_Weights``, whose mesh splits the heads over tp."""
    B, C, D = h.shape
    hd = cfg.head_dim
    nh, nkv = (cfg.n_heads, cfg.kv_heads) if w is None else (w.nq, w.nkv)
    mesh = None if w is None else w.mesh
    group = meshlib.axis_group(mesh, "tp")

    post = cfg.post_ln
    attn_in = h if post else tfm._norm(h, p["ln1_scale"], p["ln1_bias"], cfg)
    qkv = tfm._mm(attn_in, p["wqkv"])
    if cfg.attn_proj_bias:
        qkv = qkv + p["bqkv"].to(h.dtype)
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    q = q.reshape(B, C, nh, hd).transpose(1, 2)        # (B, nh, C, hd)
    k = k.reshape(B, C, nkv, hd).transpose(1, 2)
    v = v.reshape(B, C, nkv, hd).transpose(1, 2)
    if cfg.rope:
        # the cache stores rotated keys, at their absolute positions
        q = tfm._rope(q, pos, cfg.rope_theta)
        k = tfm._rope(k, pos, cfg.rope_theta)
    kc[:, :, pos:pos + C] = k
    vc[:, :, pos:pos + C] = v

    # gqa: g query heads share each cached kv head
    kr, vr = kc, vc
    if w is not None and w.kv_index is not None:
        kr, vr = kc.index_select(1, w.kv_index), vc.index_select(1, w.kv_index)
    g = nh // kr.shape[1]
    qg = q.reshape(B, kr.shape[1], g, C, hd)
    scores = torch.matmul(qg.float(), kr.float()[:, :, None].transpose(-1, -2)
                          ) / math.sqrt(hd)            # (B, nkv, g, C, M)
    scores = torch.where(visible, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(h.dtype)
    ctx = torch.matmul(probs, vr[:, :, None])           # (B, nkv, g, C, hd)
    ctx = ctx.reshape(B, nh, C, hd).transpose(1, 2).reshape(B, C, nh * hd)
    attn_out = tfm._row_sum(tfm._mm(ctx, p["wo"]), group, h.dtype)
    if cfg.attn_proj_bias:
        attn_out = attn_out + p["bo"].to(h.dtype)
    h = h + attn_out
    if post:
        h = tfm._norm(h, p["ln1_scale"], p["ln1_bias"], cfg)
    mlp_in = h if post else tfm._norm(h, p["ln2_scale"], p["ln2_bias"], cfg)
    h = h + tfm._dense_mlp(mlp_in, p, cfg, mesh)
    if post:
        h = tfm._norm(h, p["ln2_scale"], p["ln2_bias"], cfg)
    return h


def _chunk_hidden(w: _Weights, toks, kcache, vcache, pos):
    """toks (B, C) at positions [pos, pos + C) -> hidden (B, C, D) before
    the head, the caches written in place. Callers apply the head to as
    little of h as they read (at V ~ 50k the head dominates)."""
    cfg, C = w.cfg, toks.shape[1]
    h = w.params["embed"][toks.long()].to(cfg.dtype)
    if cfg.use_pos_emb:
        h = h + w.params["pos"][pos:pos + C].to(cfg.dtype)
    # the tables' D split over tp: the looked-up columns all-gathered
    h = multihost.gather_dim(h, -1, meshlib.axis_group(w.mesh, "tp"),
                             grad="slice")
    # query i (position pos + i) sees cache entries at positions <= pos + i
    kpos = torch.arange(kcache.shape[3], device=h.device)
    visible = kpos[None, :] <= pos + torch.arange(C, device=h.device)[:, None]
    for li, p in enumerate(w.layers):
        h = _decode_layer(h, p, kcache[li], vcache[li], cfg=cfg, pos=pos,
                          visible=visible, w=w)
    return h


def _chunk_logits(w: _Weights, toks, kcache, vcache, pos):
    """toks (B, C) at positions [pos, pos + C) -> logits (B, C, V) f32."""
    return w.logits(_chunk_hidden(w, toks, kcache, vcache, pos))


def _one_token_logits(w: _Weights, tok, kcache, vcache, pos):
    """tok (B,) at position pos -> logits (B, V)."""
    return _chunk_logits(w, tok[:, None], kcache, vcache, pos)[:, 0]


def _prefill_prefix(w: _Weights, prompt, kcache, vcache, enabled,
                    prompt_lens, want_logits):
    """Rectangular prompts (``prompt_lens is None``) with ``enabled``:
    positions [0, P - 1) as one chunk. Returns ``(start, prefix_logits)``:
    the loop's first step (P - 1, or 0 when the prefill did not apply) and
    the (B, P - 1, V) head output when ``want_logits``, else None."""
    P = prompt.shape[1]
    if not (enabled and prompt_lens is None and P > 1):
        return 0, None
    h = _chunk_hidden(w, prompt[:, :P - 1], kcache, vcache, 0)
    return P - 1, (w.logits(h) if want_logits else None)


def _check_decode_args(cfg: tfm.TransformerConfig, max_len: int,
                       top_k: int) -> None:
    if cfg.n_experts != 0:
        raise ValueError("decode supports dense blocks (no MoE)")
    if not cfg.causal:
        raise ValueError("decode is autoregressive: causal configs only")
    if max_len > cfg.max_seq_len:
        raise ValueError(f"max_len {max_len} > max_seq_len "
                         f"{cfg.max_seq_len}")
    if not 0 <= top_k <= cfg.vocab_size:
        raise ValueError(f"top_k {top_k} out of range [0, vocab_size="
                         f"{cfg.vocab_size}]")


def _check_decode_mesh(mesh):
    """Mesh decoding splits the batch over dp and the heads over tp; the
    other axes must be 1."""
    meshlib.check_mesh(mesh)
    over = {a: meshlib.axis_size(mesh, a) for a in ("pp", "sp", "ep")
            if meshlib.axis_size(mesh, a) > 1}
    if over:
        raise ValueError(f"mesh decoding splits the batch over dp and the "
                         f"heads over tp; the mesh has {over}")


def _new_cache(cfg, B, M, device, n_kv=None):
    shape = (cfg.n_layers, B, n_kv or cfg.kv_heads, M, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _next_token(logits, seed, sample: bool, top_k: int, temperature):
    """Greedy argmax, or (top-k) temperature sampling from a generator
    seeded with ``seed`` (Gumbel-max over the scaled logits) -> (B,)
    int64."""
    if not sample:
        return torch.argmax(logits, -1)
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, -math.inf)
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    u = torch.rand(scaled.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(scaled + gumbel, -1)


def _lens(prompt_lens, B, P, device):
    if prompt_lens is None:
        return torch.full((B,), P, dtype=torch.int64, device=device)
    return torch.as_tensor(prompt_lens, device=device).long().clamp(1, P)


def _as_prompt(prompt, device):
    return torch.as_tensor(prompt, device=device).long()


@functools.lru_cache(maxsize=32)
def make_generate_fn(cfg: tfm.TransformerConfig, max_len: int,
                     sample: bool = False, top_k: int = 0, mesh=None,
                     chunked_prefill: bool = True):
    """Returns ``gen(params, prompt (B, P), key, temperature=1.0,
    prompt_lens=None) -> (tokens (B, max_len) int64, logits (B, max_len, V)
    f32)``: tokens[:, :P] echo the prompt and the rest is generated; the
    logits of position t predict token t + 1.

    ``key``: an integer seed; step t samples from ``fold_in(key, t)``
    (unused when greedy). ``sample=False``: greedy argmax; ``sample=True``:
    temperature sampling, restricted to the ``top_k`` most likely tokens
    when ``top_k > 0``. ``prompt_lens`` (B,) (clamped to [1, P]) decodes a
    ragged batch: row b teacher-forces its first prompt_lens[b] tokens and
    generates from its own boundary; under greedy decoding each row equals
    its solo decode by the same prefill mechanism.

    ``chunked_prefill`` (rectangular prompts only): positions [0, P - 1) as
    one chunk instead of P - 1 single-token steps. It may accumulate in
    another order than the tokenwise path, so an exact logit tie can
    argmax differently; ``False`` gives the tokenwise path.

    ``mesh`` (dp x tp): ``params`` are this rank's (``shard_params``);
    every rank passes the whole prompt and gets the whole result (see the
    module docstring)."""
    _check_decode_args(cfg, max_len, top_k)
    _check_decode_mesh(mesh)
    dp = tfm.DataParallel(mesh)

    @torch.no_grad()
    def gen(params, prompt, key=0, temperature=1.0, prompt_lens=None):
        device = params["embed"].device
        prompt = _as_prompt(prompt, device)
        if prompt_lens is not None:
            prompt_lens = dp.share(torch.as_tensor(prompt_lens))
        toks, logits = _decode(params, dp.share(prompt), key, temperature,
                               prompt_lens)
        if dp.size > 1:
            toks = torch.cat(multihost.all_gather(toks, dp.group))
            logits = torch.cat(multihost.all_gather(logits, dp.group))
        return toks, logits

    def _decode(params, prompt, key, temperature, prompt_lens):
        device = params["embed"].device
        B, P = prompt.shape
        if P > max_len:
            raise ValueError(f"prompt length {P} > max_len {max_len}")
        plens = _lens(prompt_lens, B, P, device)
        w = _Weights(params, cfg, mesh)
        kcache, vcache = _new_cache(cfg, B, max_len, device, w.nkv)
        tok_seq = torch.zeros((B, max_len), dtype=torch.int64, device=device)
        tok_seq[:, :P] = prompt
        logits = torch.empty((B, max_len, cfg.vocab_size),
                             dtype=torch.float32, device=device)
        start, prefix = _prefill_prefix(w, prompt, kcache, vcache,
                                        chunked_prefill, prompt_lens,
                                        want_logits=True)
        if prefix is not None:
            logits[:, :start] = prefix
        for t in range(start, max_len):
            step_logits = _one_token_logits(w, tok_seq[:, t], kcache, vcache,
                                            t)
            logits[:, t] = step_logits
            if t + 1 == max_len:
                break   # the last step's sample has no slot
            nxt = _next_token(step_logits, tfm.fold_in(key, t), sample,
                              top_k, temperature)
            # teacher-force while the next position is in the row's prompt
            tok_seq[:, t + 1] = torch.where(t + 1 < plens, tok_seq[:, t + 1],
                                            nxt)
        return tok_seq, logits

    return gen


def generate(params, cfg: tfm.TransformerConfig, prompt, max_len: int,
             temperature: float = 0.0, rng: Optional[int] = None):
    """One-shot wrapper: ``temperature == 0`` is greedy. Returns the
    (B, max_len) tokens as a numpy array."""
    fn = make_generate_fn(cfg, max_len, sample=temperature > 0.0)
    toks, _ = fn(params, prompt, 0 if rng is None else rng,
                 max(temperature, 1e-6))
    return toks.cpu().numpy()


@functools.lru_cache(maxsize=32)
def make_eos_generate_fn(cfg: tfm.TransformerConfig, max_len: int,
                         eos_id: int, sample: bool = False, top_k: int = 0,
                         chunked_prefill: bool = True):
    """EOS-aware decode that exits once every row has emitted ``eos_id``
    (one flag read from the device a step); finished rows keep emitting
    eos. Returns ``gen(params, prompt, key, temperature=1.0,
    prompt_lens=None) -> (tokens (B, max_len), t)``: the tail is filled
    with eos, and t is the position the loop stopped at, counting
    chunk-prefilled prompt positions. ``chunked_prefill`` as in
    ``make_generate_fn``."""
    _check_decode_args(cfg, max_len, top_k)
    if not 0 <= eos_id < cfg.vocab_size:
        raise ValueError(f"eos_id {eos_id} outside vocab [0, "
                         f"{cfg.vocab_size}): the loop could never exit "
                         "early")

    @torch.no_grad()
    def gen(params, prompt, key=0, temperature=1.0, prompt_lens=None):
        device = params["embed"].device
        prompt = _as_prompt(prompt, device)
        B, P = prompt.shape
        if P > max_len:
            raise ValueError(f"prompt length {P} > max_len {max_len}")
        plens = _lens(prompt_lens, B, P, device)
        w = _Weights(params, cfg)
        kcache, vcache = _new_cache(cfg, B, max_len, device)
        tok_seq = torch.full((B, max_len), eos_id, dtype=torch.int64,
                             device=device)
        tok_seq[:, :P] = prompt
        # a ragged row's pad beyond its own length must not survive an
        # early exit: the contract is an eos-filled tail
        pos = torch.arange(max_len, device=device)
        tok_seq = torch.where(pos[None, :] < plens[:, None], tok_seq, eos_id)
        finished = torch.zeros((B,), dtype=torch.bool, device=device)
        t, _ = _prefill_prefix(w, prompt, kcache, vcache, chunked_prefill,
                               prompt_lens, want_logits=False)
        # finished is only set past the prompt, so the flag alone also
        # keeps the teacher-forced prefix running
        while t < max_len - 1 and not bool(finished.all()):
            step_logits = _one_token_logits(w, tok_seq[:, t], kcache, vcache,
                                            t)
            nxt = _next_token(step_logits, tfm.fold_in(key, t), sample,
                              top_k, temperature)
            in_prompt = t + 1 < plens
            nxt = torch.where(in_prompt, tok_seq[:, t + 1], nxt)
            nxt = torch.where(finished, eos_id, nxt)
            finished = finished | (~in_prompt & (nxt == eos_id))
            tok_seq[:, t + 1] = nxt
            t += 1
        return tok_seq, t

    return gen


@functools.lru_cache(maxsize=32)
def make_beam_search_fn(cfg: tfm.TransformerConfig, max_len: int,
                        beam_size: int):
    """Returns ``beam(params, prompt (B, P)) -> (tokens (B, K, max_len),
    scores (B, K))``, beams sorted best-first by the total log-probability
    of the generated suffix. The prompt is prefilled once at batch B as
    one chunk, its cache repeated to B*K; each step reorders the beams and
    their caches by ancestry, an ``index_select`` along the flattened B*K
    axis. Prompts are rectangular (one shared boundary)."""
    _check_decode_args(cfg, max_len, 0)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    K = beam_size

    @torch.no_grad()
    def beam(params, prompt):
        device = params["embed"].device
        prompt = _as_prompt(prompt, device)
        B, P = prompt.shape
        if not 1 <= P < max_len:
            raise ValueError("beam search must generate >= 1 token: need "
                             f"1 <= P < max_len, got P={P}")
        BK, V = B * K, cfg.vocab_size
        w = _Weights(params, cfg)
        kc, vc = _new_cache(cfg, B, max_len, device)
        h = _chunk_hidden(w, prompt, kc, vc, 0)
        last_logits = w.logits(h[:, P - 1:P])[:, 0]

        # the first expansion seeds the beams with the top min(K, V)
        # continuations; with K > V the surplus starts dead (-1e30)
        logp0 = torch.log_softmax(last_logits.float(), -1)
        k0 = min(K, V)
        scores, first_tok = torch.topk(logp0, k0, dim=-1)
        if k0 < K:
            scores = torch.cat([scores, torch.full(
                (B, K - k0), -1e30, device=device)], 1)
            first_tok = torch.cat([first_tok, torch.zeros(
                (B, K - k0), dtype=first_tok.dtype, device=device)], 1)
        toks = torch.zeros((B, K, max_len), dtype=torch.int64, device=device)
        toks[:, :, :P] = prompt[:, None, :]
        toks[:, :, P] = first_tok
        kcache = kc.repeat_interleave(K, dim=1)
        vcache = vc.repeat_interleave(K, dim=1)
        del kc, vc
        base = torch.arange(B, device=device)[:, None] * K

        # feed position t, expand into position t + 1
        for t in range(P, max_len - 1):
            logits = _one_token_logits(w, toks.reshape(BK, max_len)[:, t],
                                       kcache, vcache, t)
            logp = torch.log_softmax(logits.float(), -1)
            cand = scores[:, :, None] + logp.reshape(B, K, V)
            scores, top_idx = torch.topk(cand.reshape(B, K * V), K, dim=-1)
            src_beam = top_idx // V
            toks = torch.gather(toks, 1, src_beam[..., None].expand(
                B, K, max_len))
            toks[:, :, t + 1] = top_idx % V
            gather = (base + src_beam).reshape(BK)
            kcache = kcache.index_select(1, gather)
            vcache = vcache.index_select(1, gather)
        # best-first: every topk returns descending scores
        return toks, scores

    return beam


@functools.lru_cache(maxsize=16)
def make_speculative_generate_fn(cfg: tfm.TransformerConfig,
                                 draft_cfg: tfm.TransformerConfig,
                                 max_len: int, k: int = 4):
    """Greedy speculative decoding: the draft model proposes ``k`` tokens a
    round, the target verifies them as one chunk of k + 1, and the longest
    agreeing prefix is accepted plus the target's own next token. The
    output equals plain greedy decoding with the target token for token
    (but for exact logit ties, which the verify chunk may break otherwise
    than a single-token step).

    Returns ``gen(params, draft_params, prompt (1, P)) -> (tokens
    (1, max_len), rounds)``, rounds being the verify forwards after the
    prefill. Batch 1. Both configs causal and dense with one vocabulary;
    their position tables must cover ``max_len + k``."""
    _check_decode_args(cfg, max_len, 0)
    _check_decode_args(draft_cfg, max_len, 0)
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("the draft's vocabulary differs from the target's")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    for c in (cfg, draft_cfg):
        if max_len + k > c.max_seq_len:
            raise ValueError(f"need max_len + k <= max_seq_len ({max_len}"
                             f"+{k} > {c.max_seq_len})")
    M = max_len + k          # room for the last round's partial chunk

    @torch.no_grad()
    def gen(params, draft_params, prompt):
        device = params["embed"].device
        prompt = _as_prompt(prompt, device)
        B, P = prompt.shape
        if B != 1:
            raise ValueError(f"speculative decode is batch 1, got {B}")
        if not 1 <= P < max_len:
            raise ValueError(f"need 1 <= P < max_len, got P={P}")
        wt, wd = _Weights(params, cfg), _Weights(draft_params, draft_cfg)
        kc_t, vc_t = _new_cache(cfg, B, M, device)
        kc_d, vc_d = _new_cache(draft_cfg, B, M, device)
        toks = torch.zeros((B, M + 1), dtype=torch.int64, device=device)
        toks[:, :P] = prompt

        # prefill both; the head runs on the target's last position only
        h = _chunk_hidden(wt, prompt, kc_t, vc_t, 0)
        toks[:, P] = torch.argmax(wt.logits(h[:, P - 1:P])[:, 0], -1)
        _chunk_hidden(wd, prompt, kc_d, vc_d, 0)
        # at each round start toks[:, :n] is the sequence, both caches hold
        # positions [0, n - 1), and toks[:, n - 1] was fed to neither
        n, rounds = P + 1, 0
        while n < max_len:
            # k + 1 draft steps, not k: the extra one writes the last
            # proposal's cache entry, which the next round reads when all
            # k are accepted; its own proposal is dropped
            last = toks[:, n - 1]
            cur, drafts = last, []
            for i in range(k + 1):
                cur = torch.argmax(_one_token_logits(
                    wd, cur, kc_d, vc_d, n - 1 + i), -1)
                drafts.append(cur)
            drafts = torch.stack(drafts[:k], 1)               # (1, k)
            chunk = torch.cat([last[:, None], drafts], 1)     # (1, k + 1)
            targets = torch.argmax(_chunk_logits(
                wt, chunk, kc_t, vc_t, n - 1)[0], -1)
            agree = torch.cumprod((drafts[0] == targets[:k]).long(), 0)
            toks[0, n:n + k + 1] = targets
            n += int(agree.sum()) + 1
            rounds += 1
        return toks[:, :max_len], rounds

    return gen
