"""hetu_tpu_torch's fused linear + softmax-CE, forward and backward,
against the JAX package.

The port's plain versions (what a CPU tensor runs) are held against
``hetu_tpu.kernels.fused_ce.fused_linear_nll`` (its Pallas forward and
backward in interpret mode, as tests/test_fused_ce.py runs them; the
gradient through ``jax.grad``) and the materializing
``linear_nll_reference``, in both weight layouts, with ragged N and V and
the full BERT vocabulary. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32 rtol/atol 2e-5 (the same online logsumexp and products,
summed in another order); bf16 rtol/atol 2e-2.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.kernels import fused_ce as jce
from hetu_tpu_torch.kernels import fused_ce as tce, registry
from test_torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-5, atol=2e-5)


def _data(seed, n, v, d, layout):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32) * 0.5
    w = rng.randn(v, d).astype(np.float32) * 0.3
    b = rng.randn(v).astype(np.float32) * 0.1
    t = rng.randint(0, v, n).astype(np.int32)
    if layout == "dv":
        w = np.ascontiguousarray(w.T)
    return h, w, b, t


def _both(h, w, b, t, layout, bf16=False, **blocks):
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    want = jce.fused_linear_nll(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                                jnp.asarray(b), jnp.asarray(t),
                                w_layout=layout, **blocks)
    got = tce.fused_linear_nll(torch.from_numpy(h).to(tdt),
                               torch.from_numpy(w).to(tdt),
                               torch.from_numpy(b), torch.from_numpy(t),
                               w_layout=layout, **blocks)
    assert got.dtype == torch.float32 and got.shape == (h.shape[0],)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("layout", ["vd", "dv"])
@pytest.mark.parametrize("n,v,d,bn,bv", [
    (64, 256, 32, 32, 64),     # clean tiles
    (50, 300, 16, 32, 128),    # both axes ragged
    (16, 40, 8, 128, 512),     # blocks larger than the problem
])
def test_plain_matches_jax(layout, n, v, d, bn, bv):
    h, w, b, t = _data(0, n, v, d, layout)
    got, want = _both(h, w, b, t, layout, block_n=bn, block_v=bv)
    np.testing.assert_allclose(got, want, **F32)
    ref = np.asarray(jce.linear_nll_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), jnp.asarray(t),
        w_layout=layout))
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_bert_vocab_30522(layout):
    """The BERT-base vocabulary, ragged against the 512 vocab block
    (30522 = 59*512 + 314); small N and D keep interpret mode fast."""
    h, w, b, t = _data(1, 8, 30522, 16, layout)
    got, want = _both(h, w, b, t, layout, block_n=8, block_v=512)
    np.testing.assert_allclose(got, want, **F32)


def test_bf16_inputs():
    h, w, b, t = _data(3, 32, 128, 16, "vd")
    got, want = _both(h, w, b, t, "vd", bf16=True, block_n=16,
                      block_v=64)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_should_fuse_follows_the_device():
    assert tce.should_fuse(True)
    assert not tce.should_fuse(False, device="cuda:0")
    assert tce.should_fuse("auto", device=torch.device("cuda", 0))
    assert not tce.should_fuse("auto", device="cpu")
    assert not tce.should_fuse("auto")
    assert not tce.should_fuse(True, mesh=object())
    # the reference's rule off the TPU
    assert not jce.should_fuse("auto") and jce.should_fuse(True)


def _grads_both(h, w, b, t, ct, layout, bf16=False, **blocks):
    """Gradients of ``sum(nll · ct)`` wrt (h, w, b): the port's autograd
    and ``jax.grad`` through the JAX package's fused op and through its
    materializing reference."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jargs = (jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b))

    def jloss(fn, **kw):
        return lambda h, w, b: jnp.vdot(
            fn(h, w, b, jnp.asarray(t), w_layout=layout, **kw),
            jnp.asarray(ct))

    want = jax.grad(jloss(jce.fused_linear_nll, **blocks),
                    argnums=(0, 1, 2))(*jargs)
    ref = jax.grad(jloss(jce.linear_nll_reference), argnums=(0, 1, 2))(*jargs)
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    nll = tce.fused_linear_nll(th, tw, tb, torch.from_numpy(t),
                               w_layout=layout, **blocks)
    (nll * torch.from_numpy(ct)).sum().backward()
    return (th.grad, tw.grad, tb.grad), want, ref


@pytest.mark.parametrize("layout", ["vd", "dv"])
@pytest.mark.parametrize("n,v,d,bn,bv", [
    (64, 256, 32, 32, 64),     # clean tiles
    (50, 300, 16, 32, 128),    # both axes ragged
    (16, 40, 8, 128, 512),     # blocks larger than the problem
])
def test_backward_matches_jax(layout, n, v, d, bn, bv):
    h, w, b, t = _data(6, n, v, d, layout)
    ct = np.random.RandomState(7).randn(n).astype(np.float32)
    got, want, ref = _grads_both(h, w, b, t, ct, layout, block_n=bn,
                                 block_v=bv)
    for g, wj, wr in zip(got, want, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), **F32)
        np.testing.assert_allclose(g.numpy(), np.asarray(wr), **F32)


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_backward_bert_vocab_30522(layout):
    """The BERT-base vocabulary, ragged against the 512 vocab block, at
    small N and D; the padded vocab tail gets no gradient."""
    h, w, b, t = _data(8, 8, 30522, 16, layout)
    ct = np.full(8, 1 / 8, np.float32)
    got, want, _ = _grads_both(h, w, b, t, ct, layout, block_n=8,
                               block_v=512)
    for g, wj in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), **F32)


def test_backward_bf16_dtypes():
    """dh and dW come back in h's and W's dtype (bf16), db in f32, as the
    reference's ``_fused_bwd`` returns them."""
    h, w, b, t = _data(9, 32, 128, 16, "vd")
    ct = np.random.RandomState(10).randn(32).astype(np.float32)
    got, want, _ = _grads_both(h, w, b, t, ct, "vd", bf16=True, block_n=16,
                               block_v=64)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    assert [x.dtype for x in want] == [jnp.bfloat16, jnp.bfloat16,
                                       jnp.float32]
    for g, wj in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wj.astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2)


def test_backward_is_not_ported_and_layout_is_checked():
    """What the backward leaves out, as the reference does: the integer
    targets get no gradient. h, w and b get theirs through
    fused_linear_nll_bwd; an unknown layout raises."""
    registry.reset_stats()
    h, w, b, t = (torch.from_numpy(x) for x in _data(4, 8, 40, 8, "vd"))
    nll = tce.fused_linear_nll(h.requires_grad_(), w.requires_grad_(),
                               b.requires_grad_(), t)
    nll.sum().backward()
    assert [x.grad.shape for x in (h, w, b)] == [(8, 8), (40, 8), (40,)]
    assert t.grad is None and not t.requires_grad
    assert registry.dispatch_stats() == {("fused_linear_nll_fwd", "plain"): 1,
                                         ("fused_linear_nll_bwd", "plain"): 1}
    with pytest.raises(ValueError, match="w_layout"):
        tce.fused_linear_nll(h, w, b, t, w_layout="dt")


def test_backward_runs_under_the_forwards_mode():
    registry.reset_stats()
    h, w, b, t = (torch.from_numpy(x) for x in _data(11, 8, 40, 8, "dv"))
    with registry.active("off"):
        nll = tce.fused_linear_nll(h.requires_grad_(), w, b, t,
                                   w_layout="dv")
    nll.sum().backward()
    assert registry.dispatch_stats() == {("fused_linear_nll_fwd", "off"): 1,
                                         ("fused_linear_nll_bwd", "off"): 1}


def test_cpu_takes_the_plain_version_and_force_raises():
    registry.reset_stats()
    h, w, b, t = (torch.from_numpy(x) for x in _data(5, 8, 40, 8, "vd"))
    with registry.active("auto"):
        tce.fused_linear_nll(h, w, b, t.long())   # targets cast to int32
    assert registry.dispatch_stats() == {("fused_linear_nll_fwd", "plain"): 1}
    with registry.active("force"):
        with pytest.raises(registry.KernelEligibilityError, match="CPU"):
            tce.fused_linear_nll(h, w, b, t)
    assert registry.launch_counts()["fused_linear_nll_fwd"] == 0


# -- the backward's work split (bwd_plan), which the C launch loop walks ----
# BERT-base MLM at phase 1 (32 x 20 rows) and phase 2 (32 x 76), the GPT-2
# LM head, and the ragged shapes of the card tests (V and D not multiples
# of a tile, rows of W and h not 16-byte aligned in bf16).
PLAN_SHAPES = [(640, 30522, 768), (2432, 30522, 768), (1000, 50257, 768),
               (33, 517, 48), (20, 300, 1100), (40, 3000, 16)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,v,d", PLAN_SHAPES)
def test_bwd_plan_covers_each_vocab_column_once(n, v, d, dtype):
    tile = 128 if dtype == torch.bfloat16 else 64
    for w_dv in (False, True):
        plan = tce.bwd_plan(n, d, v, dtype, w_dv)
        table, bounds = tce._plan_arrays(plan, torch.device("cpu"))
        # the arrays the C entry reads are the plan's chunks
        assert table.shape == (len(plan.chunks), 9)
        assert bounds.shape == (len(plan.chunks), plan.n_split + 1)
        cover = np.zeros(v, np.int64)
        for i, c in enumerate(plan.chunks):
            assert table[i].tolist() == [c.c0, c.cw, *c.g_grid, *c.dh_grid,
                                         *c.dw_grid]
            ns = c.dh_grid[2]
            assert bounds[i, :ns + 1].tolist() == list(c.bounds)
            assert 0 < c.cw <= plan.chunk and c.c0 % tile == 0
            cover[c.c0:c.c0 + c.cw] += 1
            # each column of the chunk goes to exactly one dh partial, and
            # no split is empty
            kb = c.bounds
            assert kb[0] == 0 and kb[-1] == c.cw
            assert all(k1 > k0 for k0, k1 in zip(kb, kb[1:]))
            assert ns == len(kb) - 1 <= plan.n_split
            # the first chunk stores every partial buffer, later ones add
            assert i > 0 or ns == plan.n_split
            if dtype == torch.bfloat16:
                assert all(k % 64 == 0 for k in kb[:-1])
            # the grids cover the chunk's output tiles, and no more
            assert c.g_grid == (-(-n // tile), -(-c.cw // tile))
            assert c.dh_grid[:2] == (-(-n // tile), -(-d // tile))
            rows, cols = (d, c.cw) if w_dv else (c.cw, d)
            assert c.dw_grid == (-(-rows // tile), -(-cols // tile))
        assert (cover == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,v,d", PLAN_SHAPES)
def test_bwd_plan_scratch_within_its_cap(n, v, d, dtype):
    plan = tce.bwd_plan(n, d, v, dtype, False)
    assert n * plan.chunk * dtype.itemsize <= tce.SLAB_BYTES
    if dtype == torch.bfloat16:
        # chunks of whole 128-column tiles
        assert plan.chunk % 128 == 0
    else:
        # a 16 MB f32 slab of 64-column tiles, the dh partials at most a
        # 512-column run of the chunk each
        assert plan.chunk % 64 == 0
        assert plan.n_split <= max(plan.chunk // 512, 1)


# -- the forward's work split (fwd_plan), which the C entry launches --------

@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,v,d", PLAN_SHAPES)
def test_fwd_plan_puts_each_vocab_tile_in_one_split(n, v, d, dtype, sms):
    """Split z of the grid's y takes vocab tiles [z · tiles_per_split,
    (z + 1) · tiles_per_split) of ceil(V / tile), cut at the last, as the
    kernels compute it: every tile in exactly one split, no split empty,
    and the grid within two blocks an SM where the row blocks allow."""
    del d   # the split does not depend on the depth
    plan = tce.fwd_plan(n, v, dtype, sms)
    tile = 128 if dtype == torch.bfloat16 else 64
    assert plan.tile == plan.row_block == tile
    n_tiles = -(-v // tile)
    cover = np.zeros(n_tiles, np.int64)
    for z in range(plan.n_split):
        t0 = z * plan.tiles_per_split
        t1 = min(t0 + plan.tiles_per_split, n_tiles)
        assert t1 > t0, z
        cover[t0:t1] += 1
    assert (cover == 1).all()
    row_blocks = -(-n // tile)
    assert row_blocks * plan.n_split <= max(2 * sms, row_blocks)
    # and at least half as fine as that target: equal runs of whole tiles
    # halve the split count at most
    assert 2 * plan.n_split >= min(n_tiles, 2 * sms // row_blocks)


def test_fwd_plan_tiles_are_the_kernels():
    """The plan's tile and row block are the source's constants, which the
    C entry checks the plan against (it refuses any other): f32 kBV and
    kBN, bf16 kTcN and kTcM."""
    src = open(os.path.join(os.path.dirname(tce.__file__), os.pardir,
                            "csrc", "fused_ce.cu")).read()
    const = {k: int(x) for k, x in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    f32 = tce.fwd_plan(640, 30522, torch.float32)
    bf16 = tce.fwd_plan(640, 30522, torch.bfloat16)
    assert (f32.tile, f32.row_block) == (const["kBV"], const["kBN"])
    assert (bf16.tile, bf16.row_block) == (const["kTcN"], const["kTcM"])
    # BERT-base's MLM rows at phases 1 and 2 on the H100's 132 SMs: one
    # wave of at most 264 blocks
    assert (bf16.tiles_per_split, bf16.n_split) == (5, 48)
    p2 = tce.fwd_plan(2432, 30522, torch.bfloat16)
    assert (p2.tiles_per_split, p2.n_split) == (19, 13)
