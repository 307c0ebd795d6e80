"""hetu_tpu_torch's CUDA kernels on the card. These tests need a CUDA card
(the kernels have no CPU or interpret mode) and skip without one; run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances as in chip_smoke.py: SGD rtol 1e-6 / atol 1e-7, Adam rtol 1e-5
/ atol 1e-6 (powf in the kernel against torch.pow in beta**t); the
attention and CE kernels' below.
"""
import numpy as np
import pytest
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.kernels import fused_opt, registry
from test_torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda

SHAPES = [(3072, 256), (10,), (37, 19), (2**20 + 3,)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    registry.reset_launch_counts()
    return torch.device("cuda", 0)


def _rand(shape, seed, dev, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("l2reg", [0.0, 1e-3])
def test_sgd_kernel_matches_plain(dev, shape, l2reg):
    p, g = _rand(shape, 0, dev), _rand(shape, 1, dev)
    lr = torch.tensor(0.05, device=dev)
    want = fused_opt._sgd_plain(p, g, lr, l2reg=l2reg)
    with registry.active("auto"):
        got = registry.dispatch("fused_sgd", p.clone(), g, lr, l2reg=l2reg)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert registry.launch_counts()["fused_sgd"] == 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_kernel_matches_plain_over_steps(dev, shape, weight_decay):
    opt = ht.optim.AdamOptimizer(1e-3, weight_decay=weight_decay)
    p_k = _rand(shape, 2, dev)
    p_p = p_k.clone()
    s_k, s_p = opt.slot_init(p_k), opt.slot_init(p_p)
    lr = opt.lr_tensor(dev)
    for step in range(3):
        g = _rand(shape, 10 + step, dev)
        with registry.active("force"):
            _, s_k = fused_opt.adam_step(opt, p_k, g, s_k, lr)
        with registry.active("off"):
            _, s_p = fused_opt.adam_step(opt, p_p, g, s_p, lr)
    torch.testing.assert_close(p_k, p_p, rtol=1e-5, atol=1e-6)
    for k in ("m", "v", "t"):
        torch.testing.assert_close(s_k[k], s_p[k], rtol=1e-5, atol=1e-6)
    assert float(s_k["t"]) == 3.0
    assert registry.launch_counts()["fused_adam"] == 3


def test_ineligible_cuda_calls_raise(dev):
    p = torch.zeros(4, 4, device=dev)
    lr = torch.tensor(0.1, device=dev)
    bad = [((p.t(), p, lr), "contiguous"),
           ((p.double(), p, lr), "float32"),
           ((p, torch.zeros(4, 4), lr), "cpu"),
           ((p, torch.zeros(16, device=dev), lr), "shape"),
           ((p, p, torch.ones(2, device=dev)), "one element")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("fused_sgd", *args, l2reg=0.0)
    assert registry.launch_counts()["fused_sgd"] == 0


def test_mlp_on_the_card_matches_the_cpu(dev):
    x_np, y = ht.data._synthetic_classification(1024, (32,), 10, seed=5)
    y_np = ht.data.convert_to_one_hot(y, 10)

    def losses(ctx):
        x = ht.dataloader_op([ht.Dataloader(x_np, 128, "train")])
        y_ = ht.dataloader_op([ht.Dataloader(y_np, 128, "train")])
        w = ht.init.random_normal((32, 10), stddev=0.1, name="w")
        loss = ht.reduce_mean_op(
            ht.softmaxcrossentropy_op(ht.matmul_op(x, w), y_), [0])
        op = ht.optim.AdamOptimizer(1e-2).minimize(loss)
        ex = ht.Executor({"train": [loss, op]}, ctx=ctx, seed=3)
        return np.array([float(ex.run("train")[0].asnumpy()) for _ in range(8)])

    on_card = losses(None)
    assert registry.launch_counts()["fused_adam"] == 8
    np.testing.assert_allclose(on_card, losses(ht.cpu(0)), rtol=1e-4)


# -- flash_attention_fwd and fused_linear_nll_fwd ---------------------------
# Tolerances as in chip_smoke.py: bf16 o rtol/atol 2e-2 (one bf16 rounding
# of o on each side), lse and NLL atol 1e-3 (f32 sums in another order).

def _bert_attention(dev, b=4, h=12, s=128, d=64, dtype=torch.bfloat16,
                    seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    lengths = rng.randint(s // 2, s + 1, b)
    kb = torch.from_numpy(np.where(np.arange(s)[None, :] < lengths[:, None],
                                   0.0, -1e30).astype(np.float32)).to(dev)
    return q, k, v, kb


@pytest.mark.parametrize("s,d,causal,dtype", [
    (128, 64, False, torch.bfloat16),     # BERT-base layer
    (512, 64, True, torch.bfloat16),
    (256, 128, True, torch.float32),
    (64, 32, False, torch.float32),
])
def test_flash_kernel_matches_plain(dev, s, d, causal, dtype):
    from hetu_tpu_torch.kernels import flash_attention as fa
    q, k, v, kb = _bert_attention(dev, s=s, d=d, dtype=dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
              block_k=min(128, s))
    want_o, want_lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
    with registry.active("auto"):
        o, lse = fa.flash_attention_fwd(q, k, v, causal, k_bias=kb)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    assert registry.launch_counts()["flash_attention_fwd"] == 1


@pytest.mark.parametrize("n,v,d,layout", [
    (640, 30522, 768, "vd"),              # BERT-base MLM
    (1000, 50257, 768, "dv"),
    (33, 517, 48, "vd"),
])
def test_fused_ce_kernel_matches_plain(dev, n, v, d, layout):
    from hetu_tpu_torch.kernels import fused_ce as ce
    rng = np.random.RandomState(1)
    h = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy(rng.randn(v, d).astype(np.float32) * 0.05).to(
        dev, torch.bfloat16)
    if layout == "dv":
        w = w.t().contiguous()
    b = torch.from_numpy(rng.randn(v).astype(np.float32) * 0.1).to(dev)
    t = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(dev)
    lse, tl = ce._linear_nll_fwd_plain(h, w, b, t, block_n=128, block_v=512,
                                       w_dv=layout == "dv")
    with registry.active("auto"):
        nll = ce.fused_linear_nll(h, w, b, t, w_layout=layout)
    torch.testing.assert_close(nll, lse - tl, rtol=0, atol=1e-3)
    assert registry.launch_counts()["fused_linear_nll_fwd"] == 1


def test_ineligible_attention_and_ce_calls_raise(dev):
    from hetu_tpu_torch.kernels import flash_attention as fa, fused_ce as ce
    q, k, v, kb = _bert_attention(dev, b=2, s=128)
    bad = [((q.half(), k.half(), v.half()), {}, "float32 or bfloat16"),
           ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v), {},
            "contiguous"),
           ((q, k, v), dict(k_bias=kb.double()), "k_bias must be float32"),
           ((q[..., :48].contiguous(), k[..., :48].contiguous(),
             v[..., :48].contiguous()), {}, "head_dim")]
    for args, kw, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            fa.flash_attention(*args, causal=False, **kw)
    with pytest.raises(ValueError, match="must divide blocks"):
        fa.flash_attention(q, k, v, block_q=96)     # 128 % 96 != 0
    h = torch.zeros((8, 16), device=dev)
    w = torch.zeros((40, 16), device=dev)
    b = torch.zeros((40,), device=dev)
    t = torch.zeros((8,), dtype=torch.int32, device=dev)
    bad = [((h.double(), w.double(), b, t), "float32 or both bfloat16"),
           ((h, w.t(), b, t), "contiguous"),
           ((h, w, b[:20], t), "shape"),
           ((h, w, b, t.cpu()), "cpu")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            ce.fused_linear_nll(*args)
    assert registry.launch_counts()["flash_attention_fwd"] == 0
    assert registry.launch_counts()["fused_linear_nll_fwd"] == 0


def test_bert_forward_on_the_card_matches_the_cpu(dev):
    """A narrow BERT in f32: the card (both kernels) against the port on
    the CPU (plain versions), atol 1e-4 on the losses."""
    from hetu_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=1000, d_model=128, n_heads=2,
                          n_layers=2, d_ff=256, max_seq_len=128,
                          dtype=torch.float32, fused_mlm_ce="auto")
    params = bert.init_params(0, cfg, "cpu")
    rng = np.random.RandomState(2)
    rows = [(rng.randint(0, 1000, 128), np.ones(128, np.int32),
             np.zeros(128, np.int32), rng.randint(1, 128, 5),
             rng.randint(0, 1000, 5), i % 2) for i in range(4)]
    cpu = bert.batch_from_instances(rows, "cpu")
    with torch.inference_mode():
        want, _ = bert.pretrain_loss(params, cpu, cfg)
        got, _ = bert.pretrain_loss(_to(params, dev), _to(cpu, dev), cfg)
    assert registry.launch_counts()["flash_attention_fwd"] == 2
    assert registry.launch_counts()["fused_linear_nll_fwd"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# -- flash_attention_bwd and fused_linear_nll_bwd ---------------------------
# Tolerances as in chip_smoke.py: bf16 gradients rtol/atol 2e-2 (one bf16
# rounding of each output), f32 rtol/atol 2e-5 (f32 sums in another order),
# db atol 1e-3 (an f32 sum over up to 1000 rows). Gradients may be far
# smaller than those absolute tolerances, so each output is also held by
# its relative L2 error: bf16 1e-2 (one bf16 rounding of every element is
# at most 2^-9), f32 2e-5.

def _rel_l2(got, want):
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()))


def _rel_l2_limit(dtype):
    return 1e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("s,d,causal,dtype,full_pad", [
    (128, 64, False, torch.bfloat16, False),    # BERT-base layer
    (512, 64, True, torch.bfloat16, False),
    (256, 128, True, torch.float32, True),
    (96, 16, True, torch.float32, True),
])
def test_flash_bwd_kernel_matches_plain(dev, s, d, causal, dtype, full_pad):
    from hetu_tpu_torch.kernels import flash_attention as fa
    q, k, v, kb = _bert_attention(dev, s=s, d=d, dtype=dtype, seed=3)
    if full_pad:
        kb[0] = -1e30
    do = _rand(q.shape, 4, dev).to(dtype)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
              block_k=min(128, s))
    o, lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
    want = fa._flash_bwd_plain(q, k, v, o, lse, do, kb, **kw)
    with registry.active("auto"):
        got = registry.dispatch("flash_attention_bwd", q, k, v, o, lse, do,
                                kb, **kw)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), **tol)
        assert _rel_l2(g, w) <= _rel_l2_limit(dtype), name
    assert registry.launch_counts()["flash_attention_bwd"] == 1


@pytest.mark.parametrize("n,v,d,layout,dtype", [
    (640, 30522, 768, "vd", torch.bfloat16),    # BERT-base MLM
    (1000, 50257, 768, "dv", torch.bfloat16),
    (33, 517, 48, "vd", torch.float32),
    (20, 300, 1100, "dv", torch.float32),       # D not a multiple of 64
    (40, 3000, 16, "vd", torch.float32),        # dh split along the chunk
])
def test_fused_ce_bwd_kernel_matches_plain(dev, n, v, d, layout, dtype):
    from hetu_tpu_torch.kernels import fused_ce as ce
    rng = np.random.RandomState(5)
    h = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.randn(v, d).astype(np.float32) * 0.05).to(
        dev, dtype)
    if layout == "dv":
        w = w.t().contiguous()
    b = torch.from_numpy(rng.randn(v).astype(np.float32) * 0.1).to(dev)
    t = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(dev)
    ct = torch.from_numpy(rng.rand(n).astype(np.float32) / n).to(dev)
    kw = dict(block_n=128, block_v=512, w_dv=layout == "dv")
    lse, _ = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
    want = ce._linear_nll_bwd_plain(h, w, b, t, lse, ct, **kw)
    with registry.active("auto"):
        got = registry.dispatch("fused_linear_nll_bwd", h, w, b, t, lse, ct,
                                **kw)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    limit = _rel_l2_limit(dtype)
    for name, g, ww in zip(("dh", "dW", "db"), got, want):
        assert g.dtype == ww.dtype, name
        torch.testing.assert_close(
            g.float(), ww.float(),
            **(dict(rtol=0, atol=1e-3) if name == "db" else tol))
        assert _rel_l2(g, ww) <= limit, name
    # the onehot term dominates dW and db: their entries of the vocabulary
    # ids no row targets hold the softmax term alone
    free = torch.ones(v, dtype=torch.bool, device=dev)
    free[t.long()] = False
    vocab_major = (lambda x: x.t()) if layout == "dv" else (lambda x: x)
    assert _rel_l2(vocab_major(got[1])[free],
                   vocab_major(want[1])[free]) <= limit
    assert _rel_l2(got[2][free], want[2][free]) <= limit
    assert registry.launch_counts()["fused_linear_nll_bwd"] == 1


def test_ineligible_backward_calls_raise(dev):
    from hetu_tpu_torch.kernels import flash_attention as fa, fused_ce as ce
    q, k, v, kb = _bert_attention(dev, b=2, s=128)
    o, lse = fa._flash_fwd_plain(q, k, v, kb, scale=0.125, causal=False,
                                 block_q=128, block_k=128)
    kw = dict(scale=0.125, causal=False, block_q=128, block_k=128)
    bad = [((q, k, v, o, lse, q.float(), kb), "do must match"),
           ((q, k, v, o, lse.double(), q, kb), "lse must be"),
           ((q, k, v, o.transpose(2, 3).contiguous().transpose(2, 3), lse, q,
             kb), "o is not contiguous")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("flash_attention_bwd", *args, **kw)
    h = torch.zeros((8, 16), device=dev)
    w = torch.zeros((40, 16), device=dev)
    b = torch.zeros((40,), device=dev)
    t = torch.zeros((8,), dtype=torch.int32, device=dev)
    lse, ct = torch.zeros(8, device=dev), torch.ones(8, device=dev)
    kw = dict(block_n=128, block_v=512, w_dv=False)
    bad = [((h, w, b, t, lse[:4], ct), "lse must be"),
           ((h, w, b, t, lse, ct.cpu()), "ct must be"),
           ((h, w, b, t, lse, ct.double()), "ct must be")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("fused_linear_nll_bwd", *args, **kw)
    assert registry.launch_counts()["flash_attention_bwd"] == 0
    assert registry.launch_counts()["fused_linear_nll_bwd"] == 0


def _narrow_bert(dev):
    from hetu_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=1000, d_model=128, n_heads=2,
                          n_layers=2, d_ff=256, max_seq_len=128,
                          dtype=torch.float32)
    rng = np.random.RandomState(6)
    rows = [(rng.randint(0, 1000, 128), (np.arange(128) < 100 + i)
             .astype(np.int32), np.zeros(128, np.int32),
             rng.randint(1, 100, 5), rng.randint(0, 1000, 5), i % 2)
            for i in range(4)]
    return bert, cfg, bert.batch_from_instances(rows, dev)


def test_bert_train_step_on_the_card_matches_the_cpu(dev):
    """Two pretraining steps of a narrow BERT in f32, remat on: the card
    (all four kernels) against the port on the CPU ("auto" takes the
    unfused dot attention and CE there), losses rel 1e-4: the second loss
    follows an AdamW step, which turns f32 sums in another order into
    parameter differences of up to a few hundredths of a step."""
    bert, cfg, batch = _narrow_bert(dev)
    cpu_batch = {k: x.cpu() for k, x in batch.items()}
    losses = {}
    for where, b in (("cpu", cpu_batch), ("cuda", batch)):
        params = bert.init_params(0, cfg, where)
        opt = bert.init_opt_state(params)
        step = bert.make_pretrain_step(cfg, lr=1e-3)
        registry.reset_launch_counts()
        losses[where] = [float(step(params, opt, b)[0]) for _ in range(2)]
        counts = registry.launch_counts()
    assert counts["flash_attention_fwd"] == 8      # 2 steps x (2 + 2 remat)
    assert counts["flash_attention_bwd"] == 4
    assert counts["fused_linear_nll_fwd"] == 2
    assert counts["fused_linear_nll_bwd"] == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_bert_train_step_with_kernels_off_launches_nothing(dev):
    """Under kernels='off' the step's forward, remat recompute and
    backward (the last two on PyTorch's backward thread) take the plain
    versions: no launch."""
    bert, cfg, batch = _narrow_bert(dev)
    params = bert.init_params(0, cfg, dev)
    opt = bert.init_opt_state(params)
    step = bert.make_pretrain_step(cfg, lr=1e-3)
    registry.reset_launch_counts()
    with registry.active("off"):
        loss, _, _, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert sum(registry.launch_counts().values()) == 0


# -- csr_spmm and csr_spmv ---------------------------------------------------
# Kernel and plain version sum each row in CSR order with one f32
# accumulator, each product rounded before the add (-fmad=false), so they
# agree bit for bit; the relative L2 error (at most 1e-6) is reported too.

def _csr_case(case, dev):
    """(ND_Sparse_Array on dev, F) of a named case."""
    from hetu_tpu_torch.examples import gnn_model
    rng = np.random.RandomState(0)
    if case == "arxiv":
        rows, cols, _, _ = gnn_model.arxiv_graph()
        n = gnn_model.ARXIV["n_nodes"]
        vals = gnn_model.normalize_adj(rows, cols, n)
        return ht.sparse_array(vals, (rows, cols), (n, n), ctx=ht.gpu(0)), 256
    nrow, k, nnz, f = {"random": (5000, 5000, 60000, 256),
                       "nnz0": (300, 200, 0, 128),
                       "one_row": (1, 700, 900, 200),
                       "degree_5000": (100, 6000, 1000, 96)}[case]
    rows, cols = rng.randint(0, nrow, nnz), rng.randint(0, k, nnz)
    if case == "degree_5000":       # row 7 holds 5,000 entries
        rows = np.concatenate([rows, np.full(5000, 7)])
        cols = np.concatenate([cols, rng.randint(0, k, 5000)])
    vals = rng.randn(rows.size).astype(np.float32)
    return ht.sparse_array(vals, (rows, cols), (nrow, k), ctx=ht.gpu(0)), f


def _bit_equal(got, want, what):
    err = float((got - want).abs().max()) if got.numel() else 0.0
    den = float(torch.linalg.vector_norm(want))
    rel = float(torch.linalg.vector_norm(got - want)) / (den or 1.0)
    print(f"{what}: max abs {err}, rel L2 {rel}")
    assert rel <= 1e-6, (what, err, rel)
    assert torch.equal(got, want), (what, err, rel)


@pytest.mark.parametrize("case", ["random", "arxiv", "nnz0", "one_row",
                                  "degree_5000"])
def test_csr_kernels_match_plain(dev, case):
    from hetu_tpu_torch.kernels import csr_spmm as cs
    a, f = _csr_case(case, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for csr, what in ((a.csr, "A"), (a.csr_t, "A^T")):
        b = torch.randn((csr.ncol, f), generator=g, device=dev)
        x = torch.randn((csr.ncol,), generator=g, device=dev)
        registry.reset_launch_counts()
        z = registry.dispatch("csr_spmm", csr, b)
        zv = registry.dispatch("csr_spmv", csr, x)
        torch.cuda.synchronize()
        assert registry.launch_counts()["csr_spmm"] == 1
        assert registry.launch_counts()["csr_spmv"] == 1
        assert z.shape == (csr.nrow, f) and zv.shape == (csr.nrow,)
        _bit_equal(z, cs._spmm_plain(csr, b), f"{case} spmm {what}")
        _bit_equal(zv, cs._spmv_plain(csr, x), f"{case} spmv {what}")


def test_csr_gradient_on_the_card_matches_plain(dev):
    """dB = Aᵀ·dZ through the autograd Function: the kernel over the
    transposed CSR, bit-equal to kernels='off'."""
    from hetu_tpu_torch.kernels import csr_spmm as cs
    a, f = _csr_case("random", dev)
    b = torch.randn((a.ncol, f), device=dev, requires_grad=True)
    w = torch.randn((a.nrow, f), device=dev)
    grads = {}
    for mode in ("auto", "off"):
        registry.reset_launch_counts()
        with registry.active(mode):
            (grads[mode],) = torch.autograd.grad((cs.matmat(a, b) * w).sum(),
                                                 b)
        torch.cuda.synchronize()
        assert registry.launch_counts()["csr_spmm"] == (2 if mode == "auto"
                                                        else 0)
    _bit_equal(grads["auto"], grads["off"], "dB")


def test_ineligible_csr_calls_raise(dev):
    from hetu_tpu_torch.ndarray import CSRMatrix
    a, f = _csr_case("random", dev)
    b = torch.randn((a.ncol, f), device=dev)
    c = a.csr
    bad = [((c, b.double()), "float32"),
           ((c, b.to(torch.bfloat16)), "float32"),
           ((c, b.t().contiguous()), "shape"),
           ((c, b[:, ::2]), "contiguous"),
           ((c, b.cpu()), "cpu"),
           ((c, b[1:]), "shape"),
           ((CSRMatrix(c.rowptr.long(), c.col, c.val, c.nrow, c.ncol), b),
            "int32"),
           ((CSRMatrix(c.rowptr, c.col, c.val.double(), c.nrow, c.ncol), b),
            "float32")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("csr_spmm", *args)
    with pytest.raises(registry.KernelEligibilityError, match="float32"):
        registry.dispatch("csr_spmv", c, b[:, 0].contiguous().half())
    assert registry.launch_counts()["csr_spmm"] == 0
    assert registry.launch_counts()["csr_spmv"] == 0


def test_gcn_on_the_card_matches_the_cpu(dev):
    """run_single's GCN (256 nodes, hidden 32, 30 epochs) on the card: 3
    csr_spmm and 4 fused_sgd launches an epoch, none under kernels='off';
    losses within rel 1e-4 of the port on the CPU (f32 sums of the dense
    products in another order, compounded over 30 updates). A sparse array
    made on the CPU is moved to the card once."""
    from hetu_tpu_torch.examples import gnn_main
    losses = {}
    for where in ("cpu", "cuda"):
        rows = list(gnn_main.run(where, "gcn", "small", epochs=30))
        losses[where] = np.array([r["train_loss"] for r in rows[:-1]])
        if where == "cuda":
            assert all(r["launches"] == {"csr_spmm": 3, "fused_sgd": 4}
                       for r in rows[:-1])
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    rows = list(gnn_main.run(dev, "sage", "small", epochs=2, kernels="off"))
    assert all(r["launches"] == {} for r in rows[:-1])
    tr = gnn_main.Trainer(dev, "gcn", "small")
    sp = ht.sparse_array(tr.adj.data.cpu(), (tr.adj.row.cpu(),
                                             tr.adj.col.cpu()),
                         tr.adj.shape, ctx=ht.cpu(0))
    moved = tr.ex._prepare_input(sp)
    assert moved.device == dev and tr.ex._prepare_input(sp) is moved


# ---------------------------------------------------------------------------
# fused_embed_grad: the embedding gradient's sorted segment sum
# ---------------------------------------------------------------------------

def _embed_case(case, dev):
    """(vec, idx) on the card: WDL-Criteo's step (128 x 26 ids over the
    full vocabulary, d = 128), one id 3,328 times, d = 1 (DeepFM's
    first-order table), d = 8 (Deep Crossing, WDL-Adult), one row."""
    rng = np.random.RandomState(11)
    n, d, vocab = {"d1": (3328, 1, 1000), "d8": (3328, 8, 1000),
                   "n1": (1, 128, 1000)}.get(case, (3328, 128, 33762577))
    idx = rng.randint(0, vocab, n)
    if case == "single_id":
        idx = np.full(n, 4321)
    vec = rng.randn(n, d).astype(np.float32)
    return (torch.from_numpy(vec).to(dev),
            torch.from_numpy(idx.astype(np.float32)).to(dev), vocab)


@pytest.mark.parametrize("case", ["wdl", "single_id", "d1", "d8", "n1"])
def test_embed_grad_kernel_matches_plain(dev, case):
    """The kernel adds each id's rows in the plain version's order:
    bit-equal."""
    from hetu_tpu_torch.kernels import embed_grad as eg
    vec, idx, vocab = _embed_case(case, dev)
    sv, _, rows, count, offs = eg._prep(vec, idx, vocab)
    got = registry.dispatch("fused_embed_grad", sv, offs)
    torch.cuda.synchronize()
    assert registry.launch_counts()["fused_embed_grad"] == 1
    assert got.shape == sv.shape
    _bit_equal(got, eg._segsum_plain(sv, offs), f"{case} segment sum")
    k = int(count)
    assert (got[k:] == 0).all() and (rows[k:] == vocab).all()
    with registry.active("off"):
        want_rows, want, want_count = eg.embed_grad_rows(vec, idx, vocab)
    assert torch.equal(rows, want_rows) and int(want_count) == k


def test_lookup_gradient_on_the_card_matches_plain(dev):
    """Autograd through the lookup: one kernel launch, the table gradient
    bit-equal to kernels='off'."""
    from hetu_tpu_torch.kernels import embed_grad as eg
    vec, idx, _ = _embed_case("d8", dev)
    table = torch.randn((1000, 8), device=dev, requires_grad=True)
    idx = idx.view(128, 26)
    w = torch.randn((128, 26, 8), device=dev)
    grads = {}
    for mode in ("auto", "off"):
        registry.reset_launch_counts()
        with registry.active(mode):
            (grads[mode],) = torch.autograd.grad(
                (eg.lookup(table, idx) * w).sum(), table)
        torch.cuda.synchronize()
        assert registry.launch_counts()["fused_embed_grad"] == (
            1 if mode == "auto" else 0)
    _bit_equal(grads["auto"], grads["off"], "table gradient")


def test_ineligible_embed_grad_calls_raise(dev):
    from hetu_tpu_torch.kernels import embed_grad as eg
    vec, idx, vocab = _embed_case("d8", dev)
    sv, _, _, _, offs = eg._prep(vec, idx, vocab)
    bad = [((sv.double(), offs), "float32"),
           ((sv, offs.long()), "int32"),
           ((sv.t(), offs), "contiguous"),
           ((sv, offs[::2]), "contiguous"),
           ((sv, offs.cpu()), "cpu"),
           ((sv, offs[:-1]), "shape"),
           ((sv[:0], offs[:1]), "n, dim >= 1"),
           ((sv.reshape(-1), offs), "n, dim")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("fused_embed_grad", *args)
    assert registry.launch_counts()["fused_embed_grad"] == 0


def test_wdl_step_on_the_card_matches_the_cpu(dev):
    """WDL-Criteo at a small vocabulary (500 rows, embedding 16, batch 32)
    on the card: 1 fused_embed_grad and 5 fused_sgd launches a step, none
    under kernels='off'; losses within rel 1e-4 of the port on the CPU
    from the same initial values (f32 sums of the dense products in
    another order, compounded over 10 updates)."""
    from hetu_tpu_torch.examples import ctr_main, ctr_models
    data = ctr_models.load_criteo_data(feature_dimension=500, n_train=320,
                                       n_test=64)
    losses = {}
    for where in ("cpu", dev):
        rows = list(ctr_main.run(where, "wdl_criteo", batch_size=32,
                                 trainer=ctr_main.Trainer(
                                     where, "wdl_criteo", 32, 500, data=data,
                                     embedding_size=16)))
        losses[str(where)] = np.array(rows[0]["losses"])
        if where == dev:
            assert rows[0]["launches_per_step"] == {"fused_embed_grad": 1,
                                                    "fused_sgd": 5}
            assert rows[0]["launches_same_every_step"]
    np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
    rows = list(ctr_main.run(dev, "dfm_criteo", batch_size=32, dim=500,
                             steps=2, kernels="off"))
    assert rows[0]["launches"] == {}
