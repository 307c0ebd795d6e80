"""hetu_tpu_torch's CUDA kernels on the card. These tests need a CUDA card
(the kernels have no CPU or interpret mode) and skip without one; run them
on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances as in chip_smoke.py: SGD rtol 1e-6 / atol 1e-7, Adam rtol 1e-5
/ atol 1e-6 (powf in the kernel against torch.pow in beta**t).
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
