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
