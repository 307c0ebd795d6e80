"""hetu_tpu_torch's CUDA kernels on the card. These tests need a CUDA card
(the kernels have no CPU or interpret mode) and skip without one; run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances as in chip_smoke.py: SGD rtol 1e-6 / atol 1e-7, Adam rtol 1e-5
/ atol 1e-6 (powf in the kernel against torch.pow in beta**t); the
attention and CE kernels' below.
"""
import ctypes

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


@pytest.mark.parametrize("first", ["cpu", "cuda"])
def test_a_group_across_devices_raises(dev, first):
    """A group with a CUDA tensor and a CPU one raises under auto, whichever
    comes first: the CUDA tensor never takes the plain version."""
    cpu, gpu = torch.zeros(8), torch.zeros(8, device=dev)
    ps = [cpu, gpu] if first == "cpu" else [gpu, cpu]
    gs = [torch.ones_like(p) for p in ps]
    lr = torch.tensor(0.1, device=ps[0].device)
    with registry.active("auto"), pytest.raises(
            registry.KernelEligibilityError, match="tensor 1 .*(cpu|cuda)"):
        registry.dispatch("fused_sgd", ps, gs, lr, l2reg=0.0)
    assert registry.launch_counts()["fused_sgd"] == 0
    assert torch.equal(gpu, torch.zeros(8, device=dev))


def _offset_copy(x, offset):
    """A copy of ``x`` starting ``offset`` floats into a fresh allocation
    (offset 1: not 16-byte aligned)."""
    y = torch.empty(x.numel() + offset, device=x.device)[offset:]
    return y.view(x.shape).copy_(x)


K = fused_opt.MAX_TENSORS
GROUP_CASES = {
    "mlp": ([(3072, 256), (256,), (256, 256), (256,), (256, 10), (10,)], ""),
    "odd": ([(37, 19), (5,), (2**20 + 3,), (1,)], ""),
    "view_p": ([(2**16 + 1,), (1000,)], "p"),
    "view_g": ([(2**16 + 1,), (1000,)], "g"),
    "view_m": ([(2**16 + 1,), (1000,)], "m"),
    "view_v": ([(2**16 + 1,), (1000,)], "v"),
    "k_plus_3": ([((37 * i) % 1001 + 1,) for i in range(K + 3)], ""),
}


@pytest.mark.parametrize("opt,case", [
    (opt, case) for opt in ("sgd", "adam") for case in sorted(GROUP_CASES)
    if opt == "adam" or GROUP_CASES[case][1] not in ("m", "v")])
def test_group_kernels_match_plain(dev, opt, case):
    """One group apply against the plain version: SGD bit-equal, Adam
    within TOL (each tensor with its own t); a view at storage offset 1 of
    p, g, m or v takes the kernel's scalar loop; one launch per K tensors;
    bit-equal to a rerun."""
    shapes, view = GROUP_CASES[case]
    names = "pgmv" if opt == "adam" else "pg"
    x = {a: [_offset_copy(_rand(s, 10 * i + j, dev, 0.1 if a in "mv" else 1),
                          int(a == view))
             for i, s in enumerate(shapes)] for j, a in enumerate(names)}
    lr = torch.tensor(0.05, device=dev)
    kw = dict(l2reg=1e-3)
    if opt == "adam":
        x["v"] = [v.abs_() for v in x["v"]]
        x["t"] = [torch.tensor(float(i % 4), device=dev)
                  for i in range(len(shapes))]
        kw = dict(beta1=0.9, beta2=0.999, eps=1e-7, weight_decay=1e-2)
        want = fused_opt._adam_plain(x["p"], x["g"], x["m"], x["v"], x["t"],
                                     lr, **kw)
    else:
        want = [fused_opt._sgd_plain(x["p"], x["g"], lr, **kw)]
    runs = []
    for _ in range(2):
        cp = {a: [_offset_copy(t, int(a == view)) for t in x[a]]
              for a in "pmv" if a in x}
        with registry.active("force"):
            if opt == "adam":
                got = registry.dispatch("fused_adam", cp["p"], x["g"],
                                        cp["m"], cp["v"], x["t"], lr, **kw)
            else:
                got = [registry.dispatch("fused_sgd", cp["p"], x["g"], lr,
                                         **kw)]
        runs.append(got)
    torch.cuda.synchronize()
    assert registry.launch_counts()[f"fused_{opt}"] == 2 * -(-len(shapes)
                                                             // K)
    for ga, gb in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    for got_list, want_list in zip(runs[0], want):
        for a, b in zip(got_list, want_list):
            if opt == "sgd":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_c_entry_refuses_a_plan_for_another_k(dev):
    p, g = torch.zeros(8, device=dev), torch.ones(8, device=dev)
    lr = torch.tensor(0.5, device=dev)
    plan = fused_opt.opt_plan((8,), (True,))
    P = ctypes.c_void_p * 1
    for k, count in ((K + 1, 1), (K, K + 1), (K, 0)):
        rc = fused_opt._lib().hetu_fused_sgd_multi(
            P(p.data_ptr()), P(g.data_ptr()), lr.data_ptr(), 0.0,
            plan.n_vec, plan.tail_off, plan.tail_len, 0, count, k,
            torch.cuda.current_stream().cuda_stream)
        assert rc != 0
    torch.cuda.synchronize()
    assert torch.equal(p, torch.zeros(8, device=dev))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_one_launch_per_mlp_step(dev, opt):
    """A three-parameter MLP through the executor: one fused_sgd or
    fused_adam launch a step, its parameters as one group."""
    x_np, y = ht.data._synthetic_classification(512, (32,), 10, seed=5)
    y_np = ht.data.convert_to_one_hot(y, 10)
    x = ht.dataloader_op([ht.Dataloader(x_np, 128, "train")])
    y_ = ht.dataloader_op([ht.Dataloader(y_np, 128, "train")])
    w1 = ht.init.random_normal((32, 16), stddev=0.1, name="w1")
    b1 = ht.init.zeros((16,), name="b1")
    w2 = ht.init.random_normal((16, 10), stddev=0.1, name="w2")
    h = ht.relu_op(ht.matmul_op(x, w1) + ht.broadcastto_op(b1, ht.matmul_op(
        x, w1)))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(h, w2), y_), [0])
    cls = (ht.optim.SGDOptimizer if opt == "sgd"
           else ht.optim.AdamOptimizer)
    ex = ht.Executor({"train": [loss, cls(1e-2).minimize(loss)]}, seed=3)
    losses = [float(ex.run("train")[0].asnumpy()) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert {k: v for k, v in registry.launch_counts().items() if v} == {
        f"fused_{opt}": 5}


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
# Tolerances as in chip_smoke.py: bf16 o rtol/atol 2e-2 and relative L2
# 1e-2 (one bf16 rounding of o on each side, and of p in the kernel), lse,
# target logit and NLL atol 1e-3 (f32 sums in another order).

def _bert_attention(dev, b=4, h=12, s=128, d=64, dtype=torch.bfloat16,
                    seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    lengths = rng.randint(s // 2, s + 1, b)
    kb = torch.from_numpy(np.where(np.arange(s)[None, :] < lengths[:, None],
                                   0.0, -1e30).astype(np.float32)).to(dev)
    return q, k, v, kb


@pytest.mark.parametrize("s,d,causal,dtype,full_pad", [
    (128, 64, False, torch.bfloat16, False),    # BERT-base layer
    (512, 64, False, torch.bfloat16, False),    # phase 2, padded
    (512, 64, True, torch.bfloat16, False),
    (96, 16, True, torch.bfloat16, True),       # S not a multiple of 64
    (96, 32, True, torch.bfloat16, False),
    (96, 128, True, torch.bfloat16, True),
    (128, 64, False, torch.bfloat16, True),     # a fully padded row
    (256, 128, True, torch.float32, False),
    (64, 32, False, torch.float32, False),
])
def test_flash_kernel_matches_plain(dev, s, d, causal, dtype, full_pad):
    from hetu_tpu_torch.kernels import flash_attention as fa
    q, k, v, kb = _bert_attention(dev, s=s, d=d, dtype=dtype)
    if full_pad:
        kb[0] = -1e30
    kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
              block_k=min(128, s))
    want_o, want_lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
    with registry.active("auto"):
        o, lse = fa.flash_attention_fwd(q, k, v, causal, k_bias=kb)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o.float(), **tol)
    assert _rel_l2(o, want_o) <= _rel_l2_limit(dtype)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
    assert registry.launch_counts()["flash_attention_fwd"] == 1


@pytest.mark.parametrize("n,v,d,layout", [
    (640, 30522, 768, "vd"),              # BERT-base MLM
    (2432, 30522, 768, "vd"),             # phase 2 (32 x 76 rows)
    (1000, 50257, 768, "dv"),
    (33, 517, 48, "vd"),
    (20, 300, 1100, "dv"),                # rows of W and h not 16-byte aligned
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
    kw = dict(block_n=128, block_v=512, w_dv=layout == "dv")
    lse, tl = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
    with registry.active("auto"):
        nll = ce.fused_linear_nll(h, w, b, t, w_layout=layout)
        got_lse, got_tl = registry.dispatch("fused_linear_nll_fwd", h, w, b,
                                            t, **kw)
    torch.testing.assert_close(nll, lse - tl, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_lse, lse, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_tl, tl, rtol=0, atol=1e-3)
    assert registry.launch_counts()["fused_linear_nll_fwd"] == 2


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


# The tensor-core (bf16) backward kernels at the phase-2 shapes and at
# ragged ones (misaligned rows of W and h, D and S not multiples of a tile,
# a fully padded row), under the same gates; and each run twice on the same
# inputs, bit for bit.

def _ce_bwd_inputs(dev, n, v, d, layout, dtype, seed=5):
    rng = np.random.RandomState(seed)
    h = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.randn(v, d).astype(np.float32) * 0.05).to(
        dev, dtype)
    if layout == "dv":
        w = w.t().contiguous()
    b = torch.from_numpy(rng.randn(v).astype(np.float32) * 0.1).to(dev)
    t = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(dev)
    ct = torch.from_numpy(rng.rand(n).astype(np.float32) / n).to(dev)
    from hetu_tpu_torch.kernels import fused_ce as ce
    kw = dict(block_n=128, block_v=512, w_dv=layout == "dv")
    lse, _ = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
    return (h, w, b, t, lse, ct), kw


@pytest.mark.parametrize("n,v,d,layout", [
    (2432, 30522, 768, "vd"),    # BERT-base MLM, phase 2 (32 x 76 rows)
    (33, 517, 48, "vd"),
    (20, 300, 1100, "dv"),       # rows of W and h not 16-byte aligned
])
def test_fused_ce_bwd_bf16_phase2_and_ragged(dev, n, v, d, layout):
    from hetu_tpu_torch.kernels import fused_ce as ce
    args, kw = _ce_bwd_inputs(dev, n, v, d, layout, torch.bfloat16)
    want = ce._linear_nll_bwd_plain(*args, **kw)
    with registry.active("auto"):
        got = registry.dispatch("fused_linear_nll_bwd", *args, **kw)
    for name, g, ww in zip(("dh", "dW", "db"), got, want):
        assert g.dtype == ww.dtype, name
        torch.testing.assert_close(
            g.float(), ww.float(),
            **(dict(rtol=0, atol=1e-3) if name == "db"
               else dict(rtol=2e-2, atol=2e-2)))
        assert _rel_l2(g, ww) <= 1e-2, name
    t = args[3]
    free = torch.ones(v, dtype=torch.bool, device=dev)
    free[t.long()] = False
    vocab_major = (lambda x: x.t()) if layout == "dv" else (lambda x: x)
    assert _rel_l2(vocab_major(got[1])[free],
                   vocab_major(want[1])[free]) <= 1e-2
    assert _rel_l2(got[2][free], want[2][free]) <= 1e-2
    assert registry.launch_counts()["fused_linear_nll_bwd"] == 1


@pytest.mark.parametrize("b,s,d,causal,full_pad", [
    (32, 512, 64, False, False),   # BERT-base layer, phase 2
    (4, 96, 16, True, True),
    (4, 256, 128, True, True),
])
def test_flash_bwd_bf16_phase2_and_ragged(dev, b, s, d, causal, full_pad):
    from hetu_tpu_torch.kernels import flash_attention as fa
    q, k, v, kb = _bert_attention(dev, b=b, s=s, d=d, dtype=torch.bfloat16,
                                  seed=3)
    if full_pad:
        kb[0] = -1e30
    do = _rand(q.shape, 4, dev).to(torch.bfloat16)
    kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
              block_k=min(128, s))
    o, lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
    want = fa._flash_bwd_plain(q, k, v, o, lse, do, kb, **kw)
    with registry.active("auto"):
        got = registry.dispatch("flash_attention_bwd", q, k, v, o, lse, do,
                                kb, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2)
        assert _rel_l2(g, w) <= 1e-2, name
    assert registry.launch_counts()["flash_attention_bwd"] == 1


@pytest.mark.parametrize("kernel", ["fused_linear_nll_fwd",
                                    "fused_linear_nll_bwd",
                                    "flash_attention_fwd",
                                    "flash_attention_bwd"])
def test_bf16_kernels_repeat_bit_for_bit(dev, kernel):
    if kernel.startswith("fused_linear_nll"):
        args, kw = _ce_bwd_inputs(dev, 640, 30522, 768, "vd",
                                  torch.bfloat16)
        if kernel == "fused_linear_nll_fwd":
            args = args[:4]
    else:
        from hetu_tpu_torch.kernels import flash_attention as fa
        q, k, v, kb = _bert_attention(dev, b=8, s=128, d=64,
                                      dtype=torch.bfloat16, seed=3)
        do = _rand(q.shape, 4, dev).to(torch.bfloat16)
        kw = dict(scale=0.125, causal=False, block_q=128, block_k=128)
        o, lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
        args = ((q, k, v, kb) if kernel == "flash_attention_fwd"
                else (q, k, v, o, lse, do, kb))
    with registry.active("auto"):
        first = registry.dispatch(kernel, *args, **kw)
        second = registry.dispatch(kernel, *args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert registry.launch_counts()[kernel] == 2


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
    assert counts["fused_embed_grad"] == 4         # 2 steps x (token, type)
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
# Kernel and plain version sum each chunk of a row in CSR order with one f32
# accumulator, each product rounded before the add (-fmad=false), and fold
# a split row's partials in chunk order, so they agree bit for bit, and a
# rerun with them; the relative L2 error (at most 1e-6) is reported too.

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
                       "degree_5000": (100, 6000, 1000, 96),
                       "chunk_edges": (1000, 5000, 20000, 260)}[case]
    rows, cols = rng.randint(0, nrow, nnz), rng.randint(0, k, nnz)
    if case == "degree_5000":       # row 7 holds 5,000 entries
        rows = np.concatenate([rows, np.full(5000, 7)])
        cols = np.concatenate([cols, rng.randint(0, k, 5000)])
    if case == "chunk_edges":       # rows 3-7: exactly a chunk, one more,
        from hetu_tpu_torch.kernels import csr_spmm as cs   # 100,000
        lengths = {3: cs.SPMM_CHUNK, 4: cs.SPMM_CHUNK + 1, 5: cs.SPMV_CHUNK,
                   6: cs.SPMV_CHUNK + 1, 7: 100000}
        keep = ~np.isin(rows, list(lengths))
        extra = np.repeat(list(lengths), list(lengths.values()))
        rows = np.concatenate([rows[keep], extra])
        cols = np.concatenate([cols[keep], rng.randint(0, k, extra.size)])
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
                                  "degree_5000", "chunk_edges"])
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
        _bit_equal(cs._spmm_kernel(csr, b), z, f"{case} spmm {what} rerun")
        _bit_equal(cs._spmv_kernel(csr, x), zv, f"{case} spmv {what} rerun")


@pytest.mark.parametrize("f,offset", [(67, 0), (1, 0), (128, 1), (301, 0)])
def test_csr_spmm_scalar_layout(dev, f, offset):
    """Widths the float4 layout does not take (F % 4 != 0, or B not 16-byte
    aligned) run the scalar layout of the same kernel, bit-equal to the
    plain version and to a rerun."""
    from hetu_tpu_torch.kernels import csr_spmm as cs
    a, _ = _csr_case("chunk_edges", dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for csr, what in ((a.csr, "A"), (a.csr_t, "A^T")):
        flat = torch.randn((csr.ncol * f + offset,), generator=g, device=dev)
        b = flat[offset:].view(csr.ncol, f)
        assert b.is_contiguous() and (b.data_ptr() % 16 != 0) == bool(offset)
        z = registry.dispatch("csr_spmm", csr, b)
        torch.cuda.synchronize()
        _bit_equal(z, cs._spmm_plain(csr, b), f"F={f} spmm {what}")
        _bit_equal(cs._spmm_kernel(csr, b), z, f"F={f} spmm {what} rerun")


def test_csr_kernel_refuses_another_chunk_size(dev, monkeypatch):
    """The C entries read the plan as given and refuse one cut to another
    chunk size."""
    from hetu_tpu_torch.kernels import csr_spmm as cs
    a, f = _csr_case("random", dev)
    b = torch.randn((a.ncol, f), device=dev)
    monkeypatch.setattr(cs, "SPMM_CHUNK", cs.SPMM_CHUNK // 2)
    monkeypatch.setattr(cs, "SPMV_CHUNK", cs.SPMV_CHUNK // 2)
    with pytest.raises(RuntimeError, match="csr_spmm: .*CUDA error"):
        cs._spmm_kernel(a.csr, b)
    with pytest.raises(RuntimeError, match="csr_spmv: .*CUDA error"):
        cs._spmv_kernel(a.csr, b[:, 0].contiguous())


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
    csr_spmm launches and 1 fused_sgd launch (the four parameters as one
    group) an epoch, none under kernels='off';
    losses within rel 1e-4 of the port on the CPU (f32 sums of the dense
    products in another order, compounded over 30 updates). A sparse array
    made on the CPU is moved to the card once."""
    from hetu_tpu_torch.examples import gnn_main
    losses = {}
    for where in ("cpu", "cuda"):
        rows = list(gnn_main.run(where, "gcn", "small", epochs=30))
        losses[where] = np.array([r["train_loss"] for r in rows[:-1]])
        if where == "cuda":
            assert all(r["launches"] == {"csr_spmm": 3, "fused_sgd": 1}
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
    """(vec, idx, vocab) on the card: WDL-Criteo's step (128 x 26 ids over
    the full vocabulary, d = 128), one id 3,328 times, d = 1 (DeepFM's
    first-order table), d = 8 (Deep Crossing, WDL-Adult), one row, and
    BERT-base's two lookups at phase 2 (32 x 512 token ids, about 4,100 of
    them the padding id 0, over 30,522 rows; their type ids over 2 rows;
    d = 768)."""
    rng = np.random.RandomState(11)
    if case.startswith("bert"):
        from hetu_tpu_torch.examples import bert_forward
        from hetu_tpu_torch.models import bert
        b = bert_forward.phase1_batch(bert.BERT_BASE, 32, 512, 76, seed=0,
                                      device=dev)
        idx, vocab = ((b["input_ids"], 30522) if case == "bert_token"
                      else (b["segment_ids"], 2))
        vec = rng.randn(idx.numel(), 768).astype(np.float32)
        return torch.from_numpy(vec).to(dev), idx, vocab
    n, d, vocab = {"d1": (3328, 1, 1000), "d8": (3328, 8, 1000),
                   "n1": (1, 128, 1000)}.get(case, (3328, 128, 33762577))
    idx = rng.randint(0, vocab, n)
    if case == "single_id":
        idx = np.full(n, 4321)
    vec = rng.randn(n, d).astype(np.float32)
    return (torch.from_numpy(vec).to(dev),
            torch.from_numpy(idx.astype(np.float32)).to(dev), vocab)


EMBED_CASES = ["wdl", "single_id", "d1", "d8", "n1", "bert_token",
               "bert_type"]


@pytest.mark.parametrize("case", EMBED_CASES)
def test_embed_grad_kernel_matches_plain(dev, case):
    """The kernel adds each id's pieces and folds them in the plain
    version's order: bit-equal, and bit-equal to a rerun, in the compact
    form (keys = ranks) and the dense one (keys = ids, into the table)."""
    from hetu_tpu_torch.kernels import embed_grad as eg
    vec, idx, vocab = _embed_case(case, dev)
    flat, order, sidx = eg._prep(vec, idx)
    seg, rows, count = eg._ranks(sidx, vocab)
    n, d = flat.shape
    forms = [("compact", seg, n)] + (
        [("dense", sidx, vocab)] if vocab * d < 2**31 else [])
    got = {}
    for form, key, out_rows in forms:
        registry.reset_launch_counts()
        got[form] = registry.dispatch("fused_embed_grad", flat, order, key,
                                      torch.zeros((out_rows, d), device=dev))
        again = eg._segsum_kernel(flat, order, key,
                                  torch.zeros_like(got[form]))
        torch.cuda.synchronize()
        assert registry.launch_counts()["fused_embed_grad"] == 2
        want = eg._segsum_plain(flat, order, key, torch.zeros_like(got[form]))
        _bit_equal(got[form], want, f"{case} {form} segment sum")
        _bit_equal(again, got[form], f"{case} {form} rerun")
    k = int(count)
    assert (got["compact"][k:] == 0).all()
    with registry.active("off"):
        want_rows, want, want_count = eg.embed_grad_rows(vec, idx, vocab)
    assert torch.equal(rows, want_rows) and int(want_count) == k
    assert (rows[k:] == vocab).all()


def test_embed_grad_scalar_path_and_refusals(dev):
    """A row view 4 bytes off 16-byte alignment: the entry takes the
    scalar path (``segsum_chunk_kernel<1>`` in the profile), bit-equal to
    the plain version; the C entry refuses a chunk above kMaxChunk."""
    from hetu_tpu_torch.kernels import embed_grad as eg
    vec, idx, _ = _embed_case("wdl", dev)
    storage = torch.cat([vec.flatten(), vec.new_zeros(1)])
    view = storage[1:].view(vec.shape)
    # 128 ids below 50,000, each 26 times: runs across chunks
    flat, order, keys = eg._prep(view, (idx[:128] % 50000)
                                 .repeat_interleave(26))
    out = torch.zeros((50000, 128), device=dev)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = eg._segsum_kernel(flat, order, keys, out.clone())
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("segsum_chunk_kernel<1>" in nm for nm in names), names
    want = eg._segsum_plain(flat, order, keys, out.clone())
    torch.cuda.synchronize()
    _bit_equal(got, want, "scalar path")
    lib = eg._lib()
    stream = torch.cuda.current_stream().cuda_stream
    args = [flat.data_ptr(), order.data_ptr(), keys.data_ptr(),
            out.data_ptr(), out.data_ptr(), flat.shape[0], 128, 50000]
    assert lib.hetu_embed_grad_segsum(*args, eg.MAX_CHUNK + 1, stream) == 1


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
    flat, order, sidx = eg._prep(vec, idx)
    out = torch.zeros((vocab, 8), device=dev)
    bad = [((flat.double(), order, sidx, out), "float32"),
           ((flat, order.int(), sidx, out), "int64"),
           ((flat, order, sidx.long(), out), "int32"),
           ((flat, order, sidx, out.double()), "float32"),
           ((flat.t(), order, sidx, out), "contiguous"),
           ((flat, order[::2], sidx[::2], out), "contiguous"),
           ((flat, order, sidx.cpu(), out), "cpu"),
           ((flat, order, sidx, out.cpu()), "cpu"),
           ((flat, order[:-1], sidx[:-1], out), "shape"),
           ((flat, order, sidx, out[:, :4].contiguous()), "out has shape"),
           ((flat[:0], order[:0], sidx[:0], out), "n, dim >= 1"),
           ((flat.reshape(-1), order, sidx, out), "n, dim")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("fused_embed_grad", *args)
    assert registry.launch_counts()["fused_embed_grad"] == 0


def test_wdl_step_on_the_card_matches_the_cpu(dev):
    """WDL-Criteo at a small vocabulary (500 rows, embedding 16, batch 32)
    on the card: 1 fused_embed_grad and 1 fused_sgd launch (the five
    parameters as one group) a step, none
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
                                                    "fused_sgd": 1}
            assert rows[0]["launches_same_every_step"]
    np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
    rows = list(ctr_main.run(dev, "dfm_criteo", batch_size=32, dim=500,
                             steps=2, kernels="off"))
    assert rows[0]["launches"] == {}


# -- the quantized all-reduce's quantize and dequantize ---------------------

def _quant_input(n, dev, edge):
    x = _rand((n,), 7, dev, 3.0)
    if edge:
        x[:300] = 0.0                       # all-zero blocks
        x[400] = float("nan")
        x[900] = float("inf")
        x[1300] = -0.0
        x[1800] = 127.0 / 8                 # x / scale = x * 8 here:
        x[1801:1800 + 256] = (torch.arange(255, device=dev) % 9 - 3.5) / 8
    return x


def _same_bits(a, b):
    if a.dtype != torch.float32:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("block", [256, 128, 64, 7])
@pytest.mark.parametrize("n,edge", [(786432, False), (2560, False),
                                    (8 * 256 + 77, True), (1, False)])
def test_quant_kernels_match_plain_bit_for_bit(dev, mode, block, n, edge):
    """The payload crosses the wire: kernel and plain version agree bit for
    bit (NaN scales and values by position)."""
    from hetu_tpu_torch.kernels import quant_comm as qc
    x = _quant_input(n, dev, edge)
    q, s, k = qc.quantize_blocks(x, block, mode)
    out = qc.dequantize_blocks(q, s, k, block)
    torch.cuda.synchronize()
    assert registry.launch_counts()["quant_blocks"] == 1
    assert registry.launch_counts()["dequant_blocks"] == 1
    qp, sp, kp = qc._quant_plain(x, block=block, mode=mode)
    assert k == kp == n and q.dtype == qp.dtype
    assert _same_bits(q, qp) and _same_bits(s, sp)
    assert _same_bits(out, qc._dequant_plain(qp, sp, n=kp, block=block))


def test_quant_kernel_past_65535_blocks_and_empty(dev):
    from hetu_tpu_torch.kernels import quant_comm as qc
    x = _rand((70000 * 64 + 5,), 8, dev)
    q, s, n = qc.quantize_blocks(x, 64, "int8")
    qp, sp, _ = qc._quant_plain(x, block=64, mode="int8")
    assert s.numel() == 70001 and _same_bits(q, qp) and _same_bits(s, sp)
    registry.reset_launch_counts()
    q, s, n = qc.quantize_blocks(x[:0], 256, "fp8")
    assert n == 0 and q.numel() == 0 and s.numel() == 0
    assert qc.dequantize_blocks(q, s, 0, 256).numel() == 0
    assert registry.launch_counts()["quant_blocks"] == 0   # n = 0: none


def test_ineligible_quant_calls_raise(dev):
    from hetu_tpu_torch.kernels import quant_comm as qc
    x = _rand((1000,), 9, dev)
    q, s, n = qc.quantize_blocks(x, 64, "int8")
    with pytest.raises(registry.KernelEligibilityError, match="int8/fp8"):
        registry.dispatch("quant_blocks", x, block=64, mode="int4")
    with pytest.raises(registry.KernelEligibilityError, match="float"):
        registry.dispatch("quant_blocks", x.int(), block=64, mode="int8")
    bad = [((q.float(), s), "int8 or float8"), ((q, s.double()), "float32"),
           ((q, s.cpu()), "cpu"), ((q[:-1], s), "blocks of"),
           ((q[::2], s[::2]), "contiguous")]
    for args, why in bad:
        with pytest.raises(registry.KernelEligibilityError, match=why):
            registry.dispatch("dequant_blocks", *args, n=n, block=64)
    with pytest.raises(registry.KernelEligibilityError, match="outside"):
        registry.dispatch("dequant_blocks", q, s, n=q.numel() + 1, block=64)


# the MLP's three quantized gradients (fc1-fc3 weights), and an edge tensor
MLP_QUANT = (786432, 65536, 2560, 8 * 256 + 77)


def _same_outputs(got, want, what):
    for g, w in zip(got, want):
        assert (g is None) == (w is None), what
        if g is not None:
            assert g.dtype == w.dtype and _same_bits(g, w), what


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("block", [256, 128, 64, 7])
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_quant_group_kernels_match_plain_bit_for_bit(dev, mode, block, dp):
    """The group quantize (the mean over dp, the residual in and out) into
    the send buffer, and the group dequantize of dp ranks' rows into the
    param-major output, against the plain group versions and a rerun, bit
    for bit."""
    from hetu_tpu_torch import comm_quant as cq
    from hetu_tpu_torch.kernels import quant_comm as qc
    state = cq.QarGroup(MLP_QUANT, dp, cq.QuantPolicy(mode, block=block), dev)
    pl = state.plan
    shard = _quant_input(pl.shard, dev, True)
    for resid in (_rand((pl.shard,), 3, dev, 0.01), None):
        out = (state.send_q, state.send_scales,
               None if resid is None else torch.empty_like(shard))
        got = qc._quant_kernel(shard, block=block, mode=mode, dp=dp,
                               residual=resid, out=out)
        again = qc._quant_kernel(shard, block=block, mode=mode, dp=dp,
                                 residual=resid)
        want = qc._quant_group_plain(shard, block=block, mode=mode, dp=dp,
                                     residual=resid)
        torch.cuda.synchronize()
        _same_outputs(got, want, (mode, block, dp, resid is None))
        _same_outputs(again, want, "rerun")
    rows = state.recv.view(dp, pl.chunk)
    for r in range(dp):
        q, s, _ = qc._quant_plain(_rand((pl.shard,), 20 + r, dev, 3.0),
                                  block=block, mode=mode)
        rows[r, :pl.shard] = q.view(torch.uint8)
        rows[r, pl.q_bytes:pl.q_bytes + 4 * pl.blocks] = s.view(torch.uint8)
    q, s = state.recv_q, state.recv_scales
    n = sum(MLP_QUANT)
    got = [qc._dequant_kernel(q, s, n=n, block=block, plan=pl)
           for _ in range(2)]
    want = qc._dequant_group_plain(q, s, n=n, block=block, plan=pl)
    for o, k in zip(pl.out_offs, MLP_QUANT):
        assert all(_same_bits(g[o:o + k], want[o:o + k]) for g in got)
    assert registry.launch_counts()["quant_blocks"] == 4
    assert registry.launch_counts()["dequant_blocks"] == 2


def test_quant_c_entries_refuse_a_vector_path_for_another_block(dev):
    from hetu_tpu_torch.kernels import quant_comm as qc
    x = torch.zeros(128, device=dev)
    q = torch.empty(128, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    assert qc._lib().hetu_quant_group(x.data_ptr(), None, None, q.data_ptr(),
                                      x.data_ptr(), 128, 128, 1, 1, 0, 8,
                                      stream) != 0
    plan = qc.plan_on(qc.qar_plan((128,), 1, 128), dev)
    assert qc._lib().hetu_dequant_group(
        q.data_ptr(), 128, x.data_ptr(), 1, x.data_ptr(), plan.data_ptr(), 1,
        1, 128, 1, 0, 2, stream) != 0


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_grouped_all_reduce_equals_per_tensor_on_the_card(dev, tmp_path,
                                                          mode):
    """quantized_allreduce_group over the MLP's three quantized gradients
    (NCCL, world of one) against quantized_allreduce per tensor, bit for
    bit, values and residuals, over 3 steps."""
    from hetu_tpu_torch import comm_quant as cq
    from hetu_tpu_torch.parallel import multihost
    shapes = [(3072, 256), (256, 256), (256, 10)]
    pol = cq.QuantPolicy(mode)
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, device=dev)
    try:
        state = cq.QarGroup([a * b for a, b in shapes], 1, pol, dev)
        r_g = state.residual_views()
        r_t = [torch.zeros(cq.shard_size(a * b, 1, pol.block), device=dev)
               for a, b in shapes]
        for step in range(3):
            xs = [_rand(s, 30 + 3 * step + i, dev, 0.1)
                  for i, s in enumerate(shapes)]
            v_g, r_g = cq.quantized_allreduce_group(xs, r_g, None, pol, state)
            per = [cq.quantized_allreduce(x, r, None, pol)
                   for x, r in zip(xs, r_t)]
            r_t = [r for _, r in per]
            for (v, r), vg, rg in zip(per, v_g, r_g):
                assert _same_bits(v, vg) and _same_bits(r, rg), (mode, step)
    finally:
        multihost.shutdown()


def test_dp_mlp_on_the_card_world_of_one(dev, tmp_path):
    """comm_mode='AllReduce' over NCCL at world size 1 with an explicit
    mesh: int8 launches each leg once per step (the three quantized
    weights as one group),
    equals kernels='off' bit for bit over 3 SGD steps, and 'off' equals
    local mode bit for bit."""
    from hetu_tpu_torch.examples import cnn_main
    from hetu_tpu_torch.parallel import multihost
    rng = np.random.RandomState(0)
    data = (rng.randn(512, 64).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, 512)],
            rng.randn(128, 64).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, 128)], 64, 10)
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, device=dev)
    try:
        mesh = multihost.global_mesh(1)

        def run(**kw):
            loss, y, y_, op = cnn_main.build("mlp", "CIFAR10", 128, "sgd",
                                             0.1, data=data)
            ex = ht.Executor({"train": [loss, op]}, seed=0, **kw)
            registry.reset_launch_counts()
            losses = [ex.run("train")[0].asnumpy() for _ in range(3)]
            return (np.array(losses), registry.launch_counts(),
                    [ex.state["params"][id(n)] for n in ex.param_nodes])

        dp = dict(comm_mode="AllReduce", mesh=mesh, comm_quant="int8",
                  comm_quant_min_size=1024)
        l_q, c_q, p_q = run(**dp)
        assert c_q["quant_blocks"] == c_q["dequant_blocks"] == 3
        l_o, c_o, p_o = run(kernels="off", **dp)
        assert sum(c_o.values()) == 0
        assert np.array_equal(l_q, l_o)
        assert all(torch.equal(a, b) for a, b in zip(p_q, p_o))
        l_dp, _, p_dp = run(comm_mode="AllReduce", mesh=mesh)
        l_loc, _, p_loc = run()
        assert np.array_equal(l_dp, l_loc)
        assert all(torch.equal(a, b) for a, b in zip(p_dp, p_loc))
    finally:
        multihost.shutdown()


# -- the CNN zoo's graph ops on the card (conv, pooling, BatchNorm, dropout) --

def _zoo_run(model, ctx, steps=3, **kw):
    """``model`` of cnn_models on 16 seeded images, ``steps`` SGD steps at
    lr 0.01 from the executor seed 0: (losses, parameters, launches)."""
    from hetu_tpu_torch.examples import cnn_models
    rng = np.random.RandomState(0)
    shape = (1, 28, 28) if model in ("lenet", "cnn_3_layers") else (3, 32, 32)
    xv = rng.randn(16, *shape).astype(np.float32)
    yv = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)]
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y_", trainable=False)
    loss, _ = cnn_models.MODELS[model](x, y_, 10)
    op = ht.optim.SGDOptimizer(0.01).minimize(loss)
    ex = ht.Executor({"train": [loss, op]}, ctx=ctx, seed=0, **kw)
    registry.reset_launch_counts()
    losses = [float(ex.run("train", feed_dict={x: xv, y_: yv})[0].asnumpy())
              for _ in range(steps)]
    return (np.array(losses), [ex.state["params"][id(n)].cpu()
                               for n in ex.param_nodes],
            registry.launch_counts(), ex)


@pytest.mark.parametrize("model,steps", [("lenet", 3), ("cnn_3_layers", 3),
                                         ("resnet18", 1)])
def test_zoo_model_on_the_card_matches_the_cpu(dev, model, steps):
    """cuDNN's convolutions in full float32 (no TF32) and the port's
    BatchNorm on the card against the same steps on the CPU: losses
    within rtol 1e-4 (the two sum the convolutions in other orders;
    ResNet-18's first loss alone, since a ReLU input within rounding of 0
    can take the other side and move its later steps by more)."""
    got, p_gpu, counts, ex = _zoo_run(model, ht.gpu(0), steps)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    want, p_cpu, _, _ = _zoo_run(model, ht.cpu(0), steps)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    launches = -(-len(p_gpu) // fused_opt.MAX_TENSORS)
    assert counts["fused_sgd"] == steps * launches
    assert sum(counts.values()) == counts["fused_sgd"]
    for s in ex.state["op_state"].values():
        assert all(v.is_cuda and v.dtype == torch.float32 for v in s.values())


def test_zoo_bf16_on_the_card_keeps_float32_state(dev):
    got, params, counts, ex = _zoo_run("resnet18", ht.gpu(0),
                                       dtype="bfloat16")
    assert np.isfinite(got).all() and counts["fused_sgd"] == 3 * 2
    assert all(p.dtype == torch.float32 for p in params)
    for s in ex.state["op_state"].values():
        assert all(v.dtype == torch.float32 for v in s.values())


def test_dropout_masks_on_the_card(dev):
    """The mask drawn on the card keeps its share within 4 sigma, the
    gradient op redraws it in the same step, and a seed repeats it."""
    def step(seed):
        x = ht.Variable(name="x", value=np.ones((300, 200), np.float32))
        g1 = ht.Variable(name="g1", value=np.ones((300, 200), np.float32),
                         trainable=False)
        fwd = ht.dropout_op(x, 0.7)
        regrad = ht.dropout_gradient_op(g1, 0.7, fwd)
        loss = ht.reduce_sum_op(fwd, [0, 1])
        op = ht.optim.SGDOptimizer(0.0).minimize(loss)
        ex = ht.Executor({"train": [fwd, regrad, op]}, seed=seed)
        return ex.run("train", convert_to_numpy_ret_vals=True)[:2]

    out, regrad = step(0)
    kept = (out != 0).mean()
    assert abs(kept - 0.7) < 4 * np.sqrt(0.7 * 0.3 / out.size)
    np.testing.assert_array_equal(regrad, out)
    np.testing.assert_array_equal(step(0)[0], out)
    assert (step(1)[0] != out).any()


# -- slice 6b and NCF: DistGCN, the sampled GCN, sparse_model, NCF -----------

def test_distgcn_world_of_one_on_the_card(dev, tmp_path):
    """gnn_dist on a 1 x 1 grid over NCCL (run_dist.py's 256-node graph,
    30 epochs): 3 csr_spmm launches an epoch (2 forward, 1 backward; the
    features need no gradient), none under kernels='off', and the two
    runs' losses and weights bit-equal (the CSR kernel is bit-equal to its
    plain version; the one-rank collectives copy)."""
    from hetu_tpu_torch.examples import gnn_dist, gnn_model
    from hetu_tpu_torch.parallel import multihost
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, device=dev)
    try:
        grid = multihost.process_grid(1, 1)
        data = (*gnn_model.synthetic_graph(256, 4), 4)
        runs = {}
        for kernels in ("auto", "off"):
            tr = gnn_dist.Trainer(grid, data, kernels=kernels)
            rows = list(gnn_dist.run(grid, data, 30, trainer=tr))
            runs[kernels] = ([r["loss"] for r in rows[:-1]],
                             [r["launches"] for r in rows[:-1]], tr.ws)
        losses, launches, ws = runs["auto"]
        assert launches == [{"csr_spmm": 3}] * 30
        assert runs["off"][1] == [{}] * 30
        assert losses == runs["off"][0] and losses[-1] < 0.5 * losses[0]
        assert all(torch.equal(a, b) for a, b in zip(ws, runs["off"][2]))
    finally:
        multihost.shutdown()


def test_sampled_gcn_step_on_the_card_matches_the_cpu(dev):
    """gnn_sampled's model on one sampled batch (the script's defaults):
    1 fused_adam launch a step, the first step's loss, rows' gradient and
    prediction bit-equal to kernels='off', 3 steps within rel 1e-5 of the
    CPU from the same executor seed."""
    from hetu_tpu_torch.dataloader import GNNDataLoaderOp
    from hetu_tpu_torch.examples import gnn_sampled
    args = gnn_sampled.parse_args([])
    adj, labels = gnn_sampled.make_graph(args.nodes, args.classes,
                                         args.degree)
    b = gnn_sampled.SubgraphSampler(adj, labels, args.nseed, args.nmax,
                                    args.fanout, seed=100).next()
    rows = np.random.RandomState(0).normal(
        0, 0.1, (args.nmax, args.hidden)).astype(np.float32)
    out = {}
    for name, ctx, kernels in (("card", ht.gpu(0), None),
                               ("off", ht.gpu(0), "off"),
                               ("cpu", ht.cpu(0), None)):
        loader = GNNDataLoaderOp(lambda _g: b["adj"])
        try:
            ex, (x, y_), _ = gnn_sampled.build(args, loader, ctx, 0, kernels)
            GNNDataLoaderOp.step(None)
            GNNDataLoaderOp.step(None)
            steps, counts = [], []
            for _ in range(3):
                registry.reset_launch_counts()
                steps.append([r.asnumpy() for r in ex.run(
                    "train", feed_dict={x: rows, y_: b["y"]})[:3]])
                counts.append({k: v for k, v in
                               registry.launch_counts().items() if v})
            out[name] = (steps, counts)
        finally:
            loader.close()
    assert out["card"][1] == [{"fused_adam": 1}] * 3
    assert out["off"][1] == [{}] * 3
    for a, b_ in zip(out["card"][0][0], out["off"][0][0]):
        assert np.array_equal(a, b_)
    for step_card, step_cpu in zip(out["card"][0], out["cpu"][0]):
        np.testing.assert_allclose(step_card[0], step_cpu[0], rtol=1e-5)


def test_sparse_model_on_the_card_matches_the_cpu(dev):
    """GCN's sparse_model (an embedding table before the GCN stack) 3 SGD
    steps: a step launches csr_spmm 4 times (2 forward, 2 backward: the
    features are the table's rows, so layer 1's product has a gradient
    too), fused_embed_grad once and fused_sgd once; the losses within rel
    1e-4 of the CPU from the same executor seed."""
    from hetu_tpu_torch.examples import gnn_model
    rows, cols, _, labels = gnn_model.synthetic_graph(256, 4)
    vals = gnn_model.normalize_adj(rows, cols, 256)
    rng = np.random.RandomState(3)
    index = rng.randint(0, 40, (256, 3)).astype(np.float32)
    onehot = gnn_model.convert_to_one_hot(labels, 4)
    mask = (np.random.RandomState(1).rand(256) < 0.7).astype(np.float32)
    losses, counts = {}, []
    for ctx in (ht.gpu(0), ht.cpu(0)):
        (loss, _, op), nodes = gnn_model.sparse_model(3, 16, 40, 4, 4, 0.5)
        ex = ht.Executor([loss, op], ctx=ctx, seed=0)
        adj = ht.sparse_array(vals, (rows, cols), (256, 256), ctx=ctx)
        feed = dict(zip(nodes, (index, onehot, mask, adj)))
        got = []
        for _ in range(3):
            registry.reset_launch_counts()
            got.append(float(ex.run("default", feed_dict=feed)[0].asnumpy()))
            if ctx.device_type == "gpu":
                counts.append({k: v for k, v in
                               registry.launch_counts().items() if v})
        losses[ctx.device_type] = got
    assert counts == [{"csr_spmm": 4, "fused_embed_grad": 1,
                       "fused_sgd": 1}] * 3
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)


def test_ncf_on_the_card_matches_the_cpu(dev):
    """NCF in local mode (tests/test_ctr_models.py's data, batch 256, lr
    0.3, embedding stddev 0.3) 10 steps: 1 fused_sgd and 2
    fused_embed_grad launches a step, the first step bit-equal to
    kernels='off', the losses within rel 1e-5 of the CPU."""
    from hetu_tpu_torch.examples import ncf
    data = ncf.getdata(num_users=100, num_items=200, n_pos=2000)
    model = dict(learning_rate=0.3, embed_stddev=0.3)
    runs = {}
    for name, device, kernels in (("card", dev, None), ("off", dev, "off"),
                                  ("cpu", "cpu", None)):
        tr = ncf.Trainer(device, data, 256, kernels=kernels, **model)
        res = next(ncf.run(device, steps=10, trainer=tr))
        runs[name] = res
    assert runs["card"]["launches_per_step"] == {"fused_sgd": 1,
                                                 "fused_embed_grad": 2}
    assert runs["card"]["launches_same_every_step"]
    assert runs["off"]["launches_per_step"] == {}
    assert runs["card"]["losses"][0] == runs["off"]["losses"][0]
    np.testing.assert_allclose(runs["card"]["losses"],
                               runs["cpu"]["losses"], rtol=1e-5)
