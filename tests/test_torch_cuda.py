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
