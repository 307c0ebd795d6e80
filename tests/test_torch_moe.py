"""hetu_tpu_torch's switch MoE MLP (``transformer._moe_mlp``) against the
JAX trunk's (``hetu_tpu.models.transformer._moe_mlp``).

The JAX package's params (its init, carried across by
``interop.tree_from_numpy``) and one seeded batch go through both
packages' forward, loss, gradient and ``make_train_step``, with remat off
and on. The batch overflows the experts' capacity (capacity factor 1.0
over 4 experts, the router's random split uneven), so every layer drops
tokens; ``test_batch_drops_tokens`` holds that.

Tolerances: f32 forward, aux, loss and gradients rtol 1e-5 / atol 1e-6 (f32
sums in another order; a dispatched token's row is copied exactly, and
the combine multiplies it by one gate). After three AdamW steps the params
are held as ``tests/test_torch_bert.py`` holds its train steps (atol 5e-5:
AdamW divides each gradient by its own running RMS, so a 1e-7 difference
in a gradient near 0 becomes a visible part of its step), m atol 1e-6, v
atol 1e-9. bf16: logits, aux and gradients by relative L2 within
BF16_REL (both sides round activations to bf16 at the same places and
sum in another order over two layers).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.models import transformer as jt
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import generate as tgen, transformer as tt
from test_torch_threads import one_torch_thread  # noqa: F401

MOE = dict(vocab_size=67, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=16, n_experts=4, capacity_factor=1.0, remat=False)
B, T = 4, 16
F32 = dict(rtol=1e-5, atol=1e-6)
PARAMS = dict(rtol=0, atol=5e-5)
M_TOL = dict(rtol=0, atol=1e-6)
V_TOL = dict(rtol=0, atol=1e-9)
BF16_REL = 2e-2
LR = 1e-3


def _configs(dtype="float32", **kw):
    kw = dict(MOE, **kw)
    return (jt.TransformerConfig(dtype=getattr(jnp, dtype), **kw),
            tt.TransformerConfig(dtype=getattr(torch, dtype), **kw))


@pytest.fixture(scope="module")
def pair():
    jc, tc = _configs()
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                         like=tt.init_params(0, tc, "cpu"))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, MOE["vocab_size"], (B, T)).astype(np.int32)
    targets = rng.randint(0, MOE["vocab_size"], (B, T)).astype(np.int32)
    return jp, tp, tokens, targets


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                               else tree, dtype=np.float32)}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _dropped_shares(monkeypatch):
    """Record each MoE layer's dropped share while the port runs."""
    shares, orig = [], tt._moe_mlp

    def spy(h, p, cfg, mesh):
        keep = tt.moe_route(h.reshape(-1, h.shape[-1]), p["router"], cfg)[5]
        shares.append(1.0 - float(keep.float().mean()))
        return orig(h, p, cfg, mesh)

    monkeypatch.setattr(tt, "_moe_mlp", spy)
    return shares


def test_batch_drops_tokens(pair, monkeypatch):
    """Every layer overflows an expert's capacity, and a dropped token's
    MoE output is a zero row; the routing equals the JAX package's."""
    jp, tp, tokens, _ = pair
    jc, tc = _configs()
    shares = _dropped_shares(monkeypatch)
    with torch.no_grad():
        tt.forward(tp, torch.from_numpy(tokens), tc)
    assert len(shares) == MOE["n_layers"] and min(shares) > 0, shares
    # layer 0's MLP input, its routing and output against the JAX one's
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, MOE["d_model"]).astype(np.float32)
    lp = {k: v[0] for k, v in tp["blocks"].items()}
    jlp = {k: v[0] for k, v in jp["blocks"].items()}
    with torch.no_grad():
        out, aux = tt._moe_mlp(torch.from_numpy(x), lp, tc, None)
        keep = tt.moe_route(torch.from_numpy(x).reshape(B * T, -1),
                            lp["router"], tc)[5].numpy()
    jout, jaux = jt._moe_mlp(jnp.asarray(x), jlp, jc, None)
    assert 0 < (~keep).sum() < B * T
    np.testing.assert_array_equal(out.reshape(B * T, -1).numpy()[~keep], 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)


def test_router_ties_take_the_first_expert():
    """A zero router ties every expert: all tokens go to expert 0 (the
    first index, as jnp.argmax), the first ``cap`` of them kept in order."""
    _, tc = _configs()
    S = 24
    x = torch.randn(S, MOE["d_model"])
    probs, gate, expert, onehot, pos, keep, cap = tt.moe_route(
        x, torch.zeros(MOE["d_model"], MOE["n_experts"]), tc)
    assert cap == int(MOE["capacity_factor"] * S / MOE["n_experts"])
    assert expert.tolist() == [0] * S and pos.tolist() == list(range(S))
    assert keep.tolist() == [True] * cap + [False] * (S - cap)
    assert pos.dtype == torch.int64
    np.testing.assert_allclose(gate.numpy(), 1.0 / MOE["n_experts"])


@pytest.mark.parametrize("fused", [False, True], ids=["dot_ce", "fused_ce"])
def test_forward_aux_and_loss_match_jax(pair, fused):
    jp, tp, tokens, targets = pair
    jc, tc = _configs(fused_lm_ce=fused, attn_impl="flash" if fused
                      else "dot")
    jl, ja = jt.forward(jp, jnp.asarray(tokens), jc)
    with torch.no_grad():
        tl, ta = tt.forward(tp, torch.from_numpy(tokens), tc)
        tloss = tt.loss_fn(tp, torch.from_numpy(tokens),
                           torch.from_numpy(targets), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    np.testing.assert_allclose(float(ta), float(ja), **F32)
    assert float(ta) > 0
    jloss = jt.loss_fn(jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_gradients_match_jax(pair, remat):
    jp, tp, tokens, targets = pair
    jc, tc = _configs(remat=remat)
    jloss, jg = jax.value_and_grad(jt.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    tloss, tg = tt.value_and_grad(tt.loss_fn, tp, torch.from_numpy(tokens),
                                  torch.from_numpy(targets), tc)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    want, got = _flat(jg), _flat(tg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)
    # the router and the experts get gradients (the aux term and the gate)
    assert np.abs(got["/blocks/router"]).max() > 0
    assert np.abs(got["/blocks/w1"]).max() > 0


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_steps_match_jax(pair, remat):
    jp, tp0, tokens, targets = pair
    jc, tc = _configs(remat=remat)
    jp = jax.tree.map(jnp.array, jp)
    jopt = jt.init_opt_state(jp)
    tp = tt.tree_map(torch.clone, tp0)
    topt = tt.init_opt_state(tp)
    jstep = jt.make_train_step(jc, lr=LR)
    tstep = tt.make_train_step(tc, lr=LR)
    for _ in range(3):
        jl, jp, jopt = jstep(jp, jopt, jnp.asarray(tokens),
                             jnp.asarray(targets))
        tl, tp, topt = tstep(tp, topt, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
        np.testing.assert_allclose(float(tl), float(jl), **F32)
    for got, want, tol in ((tp, jp, PARAMS), (topt["m"], jopt["m"], M_TOL),
                           (topt["v"], jopt["v"], V_TOL)):
        g, w = _flat(got), _flat(want)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)
    assert float(topt["t"]) == float(jopt["t"]) == 3.0


def test_bf16_forward_and_gradients_match_jax(pair):
    jp, tp, tokens, targets = pair
    jc, tc = _configs("bfloat16")
    jl, ja = jt.forward(jp, jnp.asarray(tokens), jc)
    with torch.no_grad():
        tl, ta = tt.forward(tp, torch.from_numpy(tokens), tc)
    assert _rel_l2(tl.numpy(), np.asarray(jl, np.float32)) < BF16_REL
    assert abs(float(ta) - float(ja)) / abs(float(ja)) < BF16_REL
    _, jg = jax.value_and_grad(jt.loss_fn)(
        jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    _, tg = tt.value_and_grad(tt.loss_fn, tp, torch.from_numpy(tokens),
                              torch.from_numpy(targets), tc)
    got, want = _flat(tg), _flat(jg)
    allg = np.concatenate([got[k].ravel() for k in sorted(want)])
    allw = np.concatenate([want[k].ravel() for k in sorted(want)])
    assert _rel_l2(allg, allw) < BF16_REL


def test_decode_refuses_moe(pair):
    _, tp, tokens, _ = pair
    _, tc = _configs()
    with pytest.raises(ValueError, match="no MoE"):
        tgen.make_generate_fn(tc, 8)
    with pytest.raises(ValueError, match="swiglu"):
        dataclasses.replace(tc, mlp="swiglu")
