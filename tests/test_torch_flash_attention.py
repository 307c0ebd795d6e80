"""hetu_tpu_torch's flash attention forward against the JAX package.

The port's plain version (what a CPU tensor runs) is held against
``hetu_tpu.kernels.flash_attention``'s Pallas forward ``_fwd_pallas`` in
interpret mode, as tests/test_attention.py runs it, for ``o`` and ``lse``,
and against the unfused ``mha_reference``. The CUDA kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: f32 rtol/atol 2e-5 (the same online softmax, summed in another
order); bf16 rtol/atol 2e-2 (one bf16 rounding of o on each side).
"""
import numpy as np
import pytest
import torch

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


def test_backward_is_not_ported():
    q, k, v = (_t(x).requires_grad_() for x in _qkv(4, s=32))
    o = tfa.flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="pretraining slice"):
        o.sum().backward()


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
