"""hetu_tpu_torch's decoding (``models/generate.py``) against the JAX
package's (``hetu_tpu.models.generate``), on the CPU in f32.

The same params (``hetu_tpu``'s init, carried across with
``interop.tree_from_numpy``) and the same seeded prompts go through both
packages at 2 layers and d 64, in four dialects: pre-LN; post-LN with
projection biases (non-zero), erf gelu and eps 1e-12; RoPE with GQA,
RMSNorm and SwiGLU and no position table; a tied head.

Tolerances: tokens equal (greedy, chunked prefill on and off, ragged
batches, the EOS loop and its stop position, beam search, speculative
decoding and its rounds); per-position logits and beam scores within rtol
1e-5, atol 1e-6 (f32 sums in another order). Sampling draws other bits
than ``jax.random.categorical``, so it is held by its own properties: the
top-k support, one seed giving one result, and the draws not moving with
the prefill.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.models import generate as jg, transformer as jt
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import generate as tg, transformer as tt
from test_torch_threads import one_torch_thread  # noqa: F401

BASE = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=24, remat=False)
DIALECTS = {
    "preln": {},
    "postln_bias": dict(post_ln=True, attn_proj_bias=True, ln_eps=1e-12,
                        gelu_exact=True),
    "rope_gqa": dict(rope=True, n_kv_heads=2, norm="rmsnorm", mlp="swiglu",
                     use_pos_emb=False),
    "tied": dict(tied_head=True),
}
CLOSE = dict(rtol=1e-5, atol=1e-6)
B, P, M = 3, 5, 12


def _pair(seed, **kw):
    """(JAX config, port config, JAX params, port params)."""
    jc = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tc = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                 jc))
    if kw.get("attn_proj_bias"):
        # non-zero biases, so a dropped bias add shows
        rng = np.random.RandomState(seed)
        for k in ("bqkv", "bo"):
            jp["blocks"][k] = (0.1 * rng.randn(*jp["blocks"][k].shape)
                               ).astype(np.float32)
    tp = tree_from_numpy(jp, "cpu", like=tt.init_params(0, tc, "cpu"))
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


@functools.lru_cache(maxsize=None)
def _model(name, seed=0, **over):
    return _pair(seed, **dict(BASE, **over), **DIALECTS[name])


@pytest.fixture(scope="module", params=list(DIALECTS))
def model(request):
    return (request.param,) + _model(request.param)


def _prompt(shape, seed, low=0):
    return np.random.RandomState(seed).randint(
        low, BASE["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked",
                                                        "tokenwise"])
def test_greedy_tokens_and_logits_match_jax(model, chunked):
    _, jc, tc, jp, tp = model
    prompt = _prompt((B, P), 1)
    jt_, jl = jg.make_generate_fn(jc, M, chunked_prefill=chunked)(
        jp, jnp.asarray(prompt), jax.random.PRNGKey(0))
    tt_, tl = tg.make_generate_fn(tc, M, chunked_prefill=chunked)(
        tp, torch.from_numpy(prompt), 0)
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt_))
    assert tl.shape == (B, M, BASE["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CLOSE)


def test_decode_logits_equal_the_full_forward(model):
    """Teacher-forced incremental logits against the port's own training
    forward over the whole sequence (the cache path and the batch path
    are one network)."""
    _, _, tc, _, tp = model
    seq = torch.from_numpy(_prompt((B, M), 2))
    toks, logits = tg.make_generate_fn(tc, M)(tp, seq, 0)
    full, _ = tt.forward(tp, seq, tc)
    assert torch.equal(toks, seq.long())
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=1e-5,
                               atol=2e-5)


def test_ragged_and_eos_match_jax(model):
    _, jc, tc, jp, tp = model
    lens = [2, 5, 3]
    prompt = _prompt((B, P), 3, low=1)
    jtok, jl = jg.make_generate_fn(jc, M)(
        jp, jnp.asarray(prompt), jax.random.PRNGKey(0),
        prompt_lens=jnp.asarray(lens, jnp.int32))
    ttok, tl = tg.make_generate_fn(tc, M)(tp, torch.from_numpy(prompt), 0,
                                          prompt_lens=lens)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CLOSE)
    # each ragged row equals its solo decode by the same (tokenwise) path
    for b, ln in enumerate(lens):
        solo, _ = tg.make_generate_fn(tc, M)(
            tp, torch.from_numpy(prompt[b:b + 1, :ln]), 0, prompt_lens=[ln])
        assert torch.equal(solo[0], ttok[b]), b

    # the EOS loop, rectangular (chunked prefill) and ragged: a token row 0
    # emits is the eos, so rows stop early
    eos = int(ttok[0, lens[0] + 1])
    for kw, jkw in (({}, {}),
                    (dict(prompt_lens=lens),
                     dict(prompt_lens=jnp.asarray(lens, jnp.int32)))):
        je, jstop = jg.make_eos_generate_fn(jc, M, eos)(
            jp, jnp.asarray(prompt), jax.random.PRNGKey(0), **jkw)
        te, tstop = tg.make_eos_generate_fn(tc, M, eos)(
            tp, torch.from_numpy(prompt), 0, **kw)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        assert tstop == int(jstop)


def test_beam_search_matches_jax(model):
    _, jc, tc, jp, tp = model
    prompt = _prompt((2, 3), 4)
    for k in (1, 4):
        jtok, js = jg.make_beam_search_fn(jc, 9, k)(jp, jnp.asarray(prompt))
        ttok, ts = tg.make_beam_search_fn(tc, 9, k)(tp,
                                                    torch.from_numpy(prompt))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **CLOSE)
        assert (ts[:, :-1] >= ts[:, 1:]).all()
    # K = 1 is greedy
    greedy = tg.generate(tp, tc, prompt, 9)
    np.testing.assert_array_equal(
        tg.make_beam_search_fn(tc, 9, 1)(tp, prompt)[0][:, 0].numpy(), greedy)


@pytest.mark.parametrize("name,k,p", [
    ("preln", 1, 3), ("preln", 3, 5), ("preln", 4, 1), ("postln_bias", 3, 5),
    ("rope_gqa", 1, 3), ("rope_gqa", 4, 1), ("tied", 3, 5)])
def test_speculative_matches_jax_and_plain_greedy(name, k, p):
    jc, tc, jp, tp = _model(name)
    # the draft: another, narrower model of the same dialect
    djc, dtc, djp, dtp = _model(name, 99, n_layers=1, d_model=32, d_ff=64)
    prompt = _prompt((1, p), 5 + k)
    jtok, jrounds = jg.make_speculative_generate_fn(jc, djc, 16, k=k)(
        jp, djp, jnp.asarray(prompt))
    ttok, trounds = tg.make_speculative_generate_fn(tc, dtc, 16, k=k)(
        tp, dtp, torch.from_numpy(prompt))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert trounds == int(jrounds)
    np.testing.assert_array_equal(ttok.numpy(),
                                  tg.generate(tp, tc, prompt, 16))


def test_sampling_support_and_determinism(model):
    _, _, tc, _, tp = model
    prompt = torch.from_numpy(_prompt((B, P), 6))
    fn = tg.make_generate_fn(tc, M, sample=True, top_k=3)
    toks, logits = fn(tp, prompt, 7, temperature=0.7)
    # every generated token is among the 3 most likely at its step
    top = torch.topk(logits[:, P - 1:M - 1], 3, dim=-1).indices
    assert (top == toks[:, P:, None]).any(-1).all()
    assert torch.equal(fn(tp, prompt, 7, temperature=0.7)[0], toks)
    assert not torch.equal(fn(tp, prompt, 8, temperature=0.7)[0], toks)
    # step t draws from fold_in(key, t): the tokenwise path and a
    # rectangular prompt_lens draw what the chunked prefill draws
    tokenwise = tg.make_generate_fn(tc, M, sample=True, top_k=3,
                                    chunked_prefill=False)
    assert torch.equal(tokenwise(tp, prompt, 7, temperature=0.7)[0], toks)
    assert torch.equal(fn(tp, prompt, 7, temperature=0.7,
                          prompt_lens=[P] * B)[0], toks)
    # an unrestricted sample at a high temperature leaves the top 3
    wide = tg.make_generate_fn(tc, M, sample=True)(tp, prompt, 7, 5.0)[0]
    assert not (top == wide[:, P:, None]).any(-1).all()


def test_config_hashes_with_a_torch_dtype():
    a = tt.TransformerConfig(dtype=torch.bfloat16, **BASE)
    b = tt.TransformerConfig(dtype=torch.bfloat16, **BASE)
    assert a == b and hash(a) == hash(b)
    assert a != tt.TransformerConfig(dtype=torch.float32, **BASE)
    assert tg.make_generate_fn(a, M) is tg.make_generate_fn(b, M)


def test_decode_refuses_what_it_does_not_serve():
    tc = tt.TransformerConfig(dtype=torch.float32, **BASE)
    # mesh decoding runs since slice 8b (tests/test_torch_tp.py); an
    # object that is no DeviceMesh is refused
    with pytest.raises(NotImplementedError, match="DeviceMesh"):
        tg.make_generate_fn(tc, M, mesh=object())
    with pytest.raises(ValueError, match="max_len"):
        tg.make_generate_fn(tc, BASE["max_seq_len"] + 1)
    with pytest.raises(ValueError, match="causal"):
        tg.make_generate_fn(tt.TransformerConfig(
            dtype=torch.float32, causal=False, **BASE), M)
    with pytest.raises(ValueError, match="eos_id"):
        tg.make_eos_generate_fn(tc, M, BASE["vocab_size"])
