"""hetu_tpu_torch's flash attention, forward and backward, against the
JAX package.

The port's plain versions (what a CPU tensor runs) are held against
``hetu_tpu.kernels.flash_attention``'s Pallas kernels in interpret mode,
as tests/test_attention.py runs them: the forward ``_fwd_pallas`` for
``o`` and ``lse``, the backward ``_bwd_pallas`` for ``dq``, ``dk`` and
``dv``, including a fully padded row; and against the unfused
``mha_reference`` and ``jax.grad`` of it. The CUDA kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32 rtol/atol 2e-5 (the same sums in another order); bf16
rtol/atol 2e-2 (one bf16 rounding of each output on each side).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.kernels import flash_attention as jfa
from hetu_tpu_torch.kernels import flash_attention as tfa, registry
from test_torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _qkv(seed, b=2, h=2, s=128, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype(np.float32) * 0.3,
            rng.randn(b, h, s, d).astype(np.float32) * 0.3,
            rng.randn(b, h, s, d).astype(np.float32))


def _bias(kind, b=2, s=128):
    """None, a key-padding bias with ragged lengths, or one whose first
    row is fully padded."""
    if kind == "none":
        return None
    kb = np.zeros((b, s), np.float32)
    kb[1, 77:] = -1e30
    if kind == "full_pad":
        kb[0, :] = -1e30
    else:
        kb[0, 100:] = -1e30
    return kb


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", ["none", "padding", "full_pad"])
@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32)])
def test_plain_matches_jax_pallas_forward(causal, bias, block_q, block_k):
    q, k, v = _qkv(0)
    kb = _bias(bias)
    scale = 0.25
    jo, jl = jfa._fwd_pallas(_j(q), _j(k), _j(v), _j(kb), scale, causal,
                             block_q, block_k, interpret=True)
    to, tl = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k, k_bias=_t(kb))
    assert to.dtype == torch.float32 and tl.shape == (2, 2, 128)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    assert np.isfinite(to.numpy()).all()


@pytest.mark.parametrize("causal", [False, True])
def test_public_entry_matches_jax_and_unfused_reference(causal):
    q, k, v = _qkv(1, s=64, d=32)
    kb = _bias("padding", s=64)
    want = np.asarray(jfa.flash_attention(_j(q), _j(k), _j(v), causal,
                                          k_bias=_j(kb)))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal, k_bias=_t(kb))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    ref = np.asarray(jfa.mha_reference(_j(q), _j(k), _j(v), causal,
                                       k_bias=_j(kb)))
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(causal):
    q, k, v = _qkv(2, s=64)
    kb = _bias("padding", s=64)
    jo, jl = jfa._fwd_pallas(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                             _j(v, jnp.bfloat16), _j(kb), 0.25, causal, 32,
                             32, interpret=True)
    to, tl = tfa.flash_attention_fwd(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        causal=causal, scale=0.25, block_q=32, block_k=32, k_bias=_t(kb))
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), **BF16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)


def test_blocks_resolve_as_the_reference():
    q, k, v = (_t(x) for x in _qkv(3, s=96))
    # blocks larger than the sequence are cut to it: min(128, 96) = 96
    assert tfa.flash_attention(q, k, v).shape == (2, 2, 96, 16)
    # a sequence the blocks do not divide raises, in both packages
    with pytest.raises(ValueError, match="must divide blocks"):
        tfa.flash_attention(q, k, v, block_q=64)   # 96 % 64 != 0
    with pytest.raises(ValueError, match="must divide blocks"):
        jfa.flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                            block_q=64)


def _jax_res(q, k, v, kb, scale, causal, block_q, block_k, dtype=jnp.float32):
    """The reference's residuals ``(q, k, v, o, lse, k_bias)`` from its
    Pallas forward in interpret mode."""
    jq, jk, jv = (_j(x, dtype) for x in (q, k, v))
    o, lse = jfa._fwd_pallas(jq, jk, jv, _j(kb), scale, causal, block_q,
                             block_k, interpret=True)
    return (jq, jk, jv, o, lse, _j(kb))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", ["none", "padding", "full_pad"])
@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32)])
def test_plain_backward_matches_jax_pallas_backward(causal, bias, block_q,
                                                    block_k):
    """The fully padded row (``full_pad``) has s = lse = -1e30, so both
    backwards take p = exp(0) = 1 for every key they visit."""
    q, k, v = _qkv(6)
    do = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    kb = _bias(bias)
    kw = dict(scale=0.25, causal=causal, block_q=block_q, block_k=block_k)
    res = _jax_res(q, k, v, kb, **kw)
    want = jfa._bwd_pallas(res, _j(do), interpret=True, **kw)
    o, lse = (torch.from_numpy(np.array(x)) for x in res[3:5])
    got = tfa._flash_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), _t(kb),
                               **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 2, 128, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", ["none", "padding"])
def test_autograd_matches_jax_grad_of_the_reference(causal, bias):
    """``torch.autograd`` through the port's ``flash_attention`` against
    ``jax.grad`` of the unfused ``mha_reference`` and of the JAX package's
    ``flash_attention``, for a random cotangent."""
    q, k, v = _qkv(8, s=64, d=32)
    kb = _bias(bias, s=64)
    ct = np.random.RandomState(9).randn(*q.shape).astype(np.float32)

    def jloss(fn):
        return lambda q, k, v: jnp.vdot(fn(q, k, v, causal, k_bias=_j(kb)),
                                        _j(ct))

    want_ref = jax.grad(jloss(jfa.mha_reference), argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    want_flash = jax.grad(jloss(jfa.flash_attention), argnums=(0, 1, 2))(
        _j(q), _j(k), _j(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal, k_bias=_t(kb))
    (o * _t(ct)).sum().backward()
    for g, wr, wf in zip((tq.grad, tk.grad, tv.grad), want_ref, want_flash):
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), **F32)
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_matches_jax(causal):
    q, k, v = _qkv(10, s=64)
    do = np.random.RandomState(11).randn(*q.shape).astype(np.float32)
    kb = _bias("padding", s=64)
    kw = dict(scale=0.25, causal=causal, block_q=32, block_k=32)
    res = _jax_res(q, k, v, kb, dtype=jnp.bfloat16, **kw)
    want = jfa._bwd_pallas(res, _j(do, jnp.bfloat16), interpret=True, **kw)
    o = torch.from_numpy(np.array(res[3].astype(jnp.float32))).to(
        torch.bfloat16)
    lse = torch.from_numpy(np.array(res[4]))
    got = tfa._flash_bwd_plain(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        o, lse, _t(do, torch.bfloat16), _t(kb), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **BF16)


def test_backward_is_not_ported():
    """The part of the reference's backward that stays unported: k_bias
    gets no gradient (the reference returns zeros for it), and lse is not
    differentiable. q, k and v get theirs through flash_attention_bwd."""
    registry.reset_stats()
    q, k, v = (_t(x).requires_grad_() for x in _qkv(4, s=32))
    kb = _t(_bias("padding", s=32)).requires_grad_()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, k_bias=kb)
    assert not lse.requires_grad
    o.sum().backward()
    assert kb.grad is None
    for x in (q, k, v):
        assert x.grad.shape == x.shape and x.grad.dtype == x.dtype
    assert registry.dispatch_stats() == {("flash_attention_fwd", "plain"): 1,
                                         ("flash_attention_bwd", "plain"): 1}


def test_backward_runs_under_the_forwards_mode():
    """The mode is thread-local, and PyTorch runs a CUDA backward on its
    own thread: the forward records its mode and the backward re-enters
    it, here with backward() called outside the forward's scope."""
    registry.reset_stats()
    q, k, v = (_t(x).requires_grad_() for x in _qkv(12, s=32))
    with registry.active("off"):
        o = tfa.flash_attention(q, k, v)
    with registry.active("auto"):
        o.sum().backward()
    assert registry.dispatch_stats() == {("flash_attention_fwd", "off"): 1,
                                         ("flash_attention_bwd", "off"): 1}


def test_cpu_takes_the_plain_version_and_force_raises():
    registry.reset_stats()
    q, k, v = (_t(x) for x in _qkv(5, s=32))
    with registry.active("auto"):
        tfa.flash_attention(q, k, v)
    assert registry.dispatch_stats() == {("flash_attention_fwd", "plain"): 1}
    with registry.active("force"):
        with pytest.raises(registry.KernelEligibilityError, match="CPU"):
            tfa.flash_attention(q, k, v)
    assert registry.launch_counts()["flash_attention_fwd"] == 0


# -- the kernels' work split (tile_plan), which they read -------------------
# The BERT-base layer at phase 1 (S = 128) and phase 2 (S = 512, and a
# causal 512), and the ragged cases of the card tests: S = 96 against the
# 64-row tiles, causal blocks smaller than the tile.
PLAN_CASES = [(128, False, 128, 128), (512, False, 128, 128),
              (512, True, 128, 128), (96, True, 96, 96),
              (256, True, 128, 128), (192, True, 64, 32), (64, False, 64, 64)]


def _needed_tile_pairs(s, causal, block_q, block_k):
    """The (query tile, key tile) pairs holding a (row, key) pair the
    reference visits."""
    limit = tfa._visit_limit(s, causal, block_q, block_k, "cpu")
    lim = [s if limit is None else min(int(limit[r]), s) for r in range(s)]
    return {(r // tfa.TILE, c // tfa.TILE) for r in range(s)
            for c in range(0, lim[r], tfa.TILE)}


@pytest.mark.parametrize("b,h", [(2, 3), (32, 12)])
@pytest.mark.parametrize("s,causal,block_q,block_k", PLAN_CASES)
def test_bwd_plan_visits_every_tile_pair_the_reference_visits(
        s, causal, block_q, block_k, b, h):
    plan = tfa.tile_plan(b, h, s, causal, block_q, block_k)
    n_t = -(-s // tfa.TILE)
    # one dq block per query tile and one dkv block per key tile
    assert plan.grid == (b * h, n_t)
    need = _needed_tile_pairs(s, causal, block_q, block_k)
    # the dq block of query tile i visits key tiles 0 .. n - 1 once each,
    # the dkv block of key tile j query tiles first .. n_t - 1: every pair
    # the reference visits, and no tile past the last (before the first)
    # such pair
    assert len(plan.dq_key_tiles) == len(plan.dkv_first_query_tile) == n_t
    for i, n in enumerate(plan.dq_key_tiles):
        assert n == 1 + max(j for qi, j in need if qi == i)
    for j, first in enumerate(plan.dkv_first_query_tile):
        assert first == min(qi for qi, kj in need if kj == j)
    dq = {(i, j) for i in range(n_t) for j in range(plan.dq_key_tiles[i])}
    dkv = {(i, j) for j in range(n_t)
           for i in range(plan.dkv_first_query_tile[j], n_t)}
    assert need <= dq and need <= dkv
    if not causal:
        assert dq == dkv == need


@pytest.mark.parametrize("s,causal,block_q,block_k", PLAN_CASES)
def test_bwd_plan_array_is_what_the_kernels_read(s, causal, block_q,
                                                 block_k):
    plan = tfa.tile_plan(2, 3, s, causal, block_q, block_k)
    tiles = tfa._plan_array(plan, torch.device("cpu"))
    n_t = plan.grid[1]
    # the f32 forward and dq read tiles[blockIdx.y] over the grid
    # (B·H, n_t), dkv tiles[gridDim.y + blockIdx.y]; the bf16 forward
    # tiles[2 n_t + blockIdx.y] over (B·H, n_f), its blocks of FWD_ROWS
    n_f = -(-s // tfa.FWD_ROWS)
    assert plan.grid == (6, n_t) and n_t == -(-s // tfa.TILE)
    assert plan.fwd_grid == (6, n_f)
    assert tiles.dtype == torch.int32 and tiles.shape == (2 * n_t + n_f,)
    assert tiles[:n_t].tolist() == list(plan.dq_key_tiles)
    assert tiles[n_t:2 * n_t].tolist() == list(plan.dkv_first_query_tile)
    assert tiles[2 * n_t:].tolist() == list(plan.fwd_key_tiles)
    # a bf16 forward block visits the key tiles its query tiles' dq blocks
    # visit, the most of them (the limit rises with the row)
    per = tfa.FWD_ROWS // tfa.TILE
    assert [max(plan.dq_key_tiles[i * per:(i + 1) * per])
            for i in range(n_f)] == list(plan.fwd_key_tiles)
    # no block is empty: a tile's rows see at least its own diagonal tile
    assert all(i < n <= n_t for i, n in enumerate(plan.dq_key_tiles)
               if causal)
    assert all(0 < n <= n_t for n in plan.dq_key_tiles)
    assert all(0 <= f <= j for j, f in
               enumerate(plan.dkv_first_query_tile))


@pytest.mark.parametrize("s,causal,block_q,block_k", PLAN_CASES)
def test_fwd_visits_each_rows_reference_keys(s, causal, block_q, block_k):
    """The forward's block of a row (f32: its 64-row tile, bf16: its
    128-row block) visits key tiles 0 .. n - 1 of the plan and excludes,
    row by row, the keys at or past the row's visit limit: what is left is
    exactly the keys the reference's ``_fwd_kernel`` visits for that row,
    the key blocks below its q block's ``_causal_upper_kb`` (all of them
    when not causal)."""
    plan = tfa.tile_plan(2, 3, s, causal, block_q, block_k)
    limit = tfa._visit_limit(s, causal, block_q, block_k, "cpu")
    for r in range(s):
        lim = s if limit is None else min(int(limit[r]), s)
        upper = (jfa._causal_upper_kb(r // block_q * block_q, block_q,
                                      block_k) if causal else s // block_k)
        for n in (plan.dq_key_tiles[r // tfa.TILE],
                  plan.fwd_key_tiles[r // tfa.FWD_ROWS]):
            assert min(n * tfa.TILE, lim) == min(upper * block_k, s), r


def _tc_fwd_emulation(q, k, v, kb, scale, causal, block_q, block_k):
    """``flash_fwd_tc_kernel``'s arithmetic in PyTorch: blocks of FWD_ROWS
    query rows over the plan's 64-key tiles; s = (q·kᵀ)·scale in f32, then
    the bias, the causal -1e30 and the exclusion of keys past a row's visit
    limit; the online (m, l) with l summing the f32 p; p rounded once to
    bf16 as it enters p·V; o = acc / l rounded once to q's dtype."""
    B, H, S, D = q.shape
    plan = tfa.tile_plan(B, H, S, causal, block_q, block_k)
    limit = tfa._visit_limit(S, causal, block_q, block_k, "cpu")
    lim = (torch.full((S,), S) if limit is None else limit.clamp(max=S))
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty((B, H, S, D))
    lse = torch.empty((B, H, S))
    T, R = tfa.TILE, tfa.FWD_ROWS
    for i, n in enumerate(plan.fwd_key_tiles):
        r0, r1 = i * R, min((i + 1) * R, S)
        rows = torch.arange(r0, r1)
        m = torch.full((B, H, r1 - r0), -1e30)
        l = torch.zeros((B, H, r1 - r0))
        acc = torch.zeros((B, H, r1 - r0, D))
        for j in range(n):
            c0, c1 = j * T, min((j + 1) * T, S)
            keys = torch.arange(c0, c1)
            sc = torch.matmul(qf[:, :, r0:r1],
                              kf[:, :, c0:c1].transpose(-1, -2)) * scale
            if kb is not None:
                sc = sc + kb[:, None, None, c0:c1]
            if causal:
                sc = torch.where(keys[None, :] > rows[:, None], -1e30, sc)
            sc = torch.where(keys[None, :] < lim[r0:r1, None], sc,
                             -float("inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(torch.bfloat16).float(), vf[:, :, c0:c1])
            m = m_new
        l = l.clamp_min(1e-30)
        o[:, :, r0:r1] = acc / l[..., None]
        lse[:, :, r0:r1] = m + torch.log(l)
    return o.to(q.dtype), lse


@pytest.mark.parametrize("s,d,causal,block_q,block_k,bias", [
    (192, 32, True, 64, 32, "padding"),      # causal, uneven blocks
    (128, 64, False, 128, 128, "full_pad"),  # a fully padded row
    (96, 128, True, 96, 96, "none"),         # head_dim 128, S not 64k
])
def test_bf16_p_rounding_fits_the_card_gates(s, d, causal, block_q, block_k,
                                             bias):
    """p enters the bf16 kernel's p·V rounded once to bf16 (the reference
    keeps it f32): the kernel's arithmetic, emulated, against
    ``_fwd_pallas`` in interpret mode and against the plain version, under
    the card's gates: o relative L2 1e-2, lse atol 1e-3."""
    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(2, 2, s, d).astype(np.float32) for _ in range(3))
    kb = _bias(bias, s=s)
    scale = d ** -0.5
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    got_o, got_lse = _tc_fwd_emulation(tq, tk, tv, _t(kb), scale, causal,
                                       block_q, block_k)
    jo, jl = jfa._fwd_pallas(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                             _j(v, jnp.bfloat16), _j(kb), scale, causal,
                             block_q, block_k, interpret=True)
    po, pl = tfa._flash_fwd_plain(tq, tk, tv, _t(kb), scale=scale,
                                  causal=causal, block_q=block_q,
                                  block_k=block_k)
    ref = (torch.from_numpy(np.array(jo.astype(jnp.float32))),
           torch.from_numpy(np.array(jl)))
    for want_o, want_lse in (ref, (po.float(), pl)):
        rel = float(torch.linalg.vector_norm(got_o.float() - want_o)
                    / torch.linalg.vector_norm(want_o))
        assert rel <= 1e-2, rel
        np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(),
                                   rtol=0, atol=1e-3)
    assert np.isfinite(got_o.float().numpy()).all()
