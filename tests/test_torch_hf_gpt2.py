"""hetu_tpu_torch's GPT-2 import and export (``models/hf_gpt2.py``)
against the JAX package's and against ``transformers``.

A seeded random-weight ``GPT2LMHeadModel`` (and its bare ``GPT2Model``)
goes through both packages' ``params_from_hf``: the numpy trees are
bit-equal and the head is tied (no ``head`` param). The port's f32 logits
(``attn_impl="dot"``) match the HF torch forward and the JAX package's
within atol/rtol 3e-4, and greedy generation equals ``transformers``'
``generate``, as ``tests/test_hf_gpt2.py`` holds the JAX package's.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from hetu_tpu.models import hf_gpt2 as jhf
from hetu_tpu.models import transformer as jt
from hetu_tpu_torch.models import generate as tgen
from hetu_tpu_torch.models import hf_gpt2 as thf
from hetu_tpu_torch.models import transformer as tt
from test_torch_hf_llama import _assert_trees_bit_equal, hf_logits
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=3e-4, rtol=3e-4)


def small_hf_config(**over):
    kw = dict(vocab_size=96, n_positions=32, n_embd=48, n_layer=2, n_head=4)
    kw.update(over)
    return transformers.GPT2Config(**kw)


def _eval_cfg(cfg):
    return dataclasses.replace(cfg, remat=False, attn_impl="dot",
                               fused_lm_ce=False)


@pytest.fixture(scope="module")
def gpt2_pair():
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(small_hf_config()).eval()
    tp, tc = thf.params_from_hf(model, device="cpu")
    jp, jc = jhf.params_from_hf(model)
    return model, tp, _eval_cfg(tc), jp, _eval_cfg(jc)


@pytest.mark.parametrize("cls", ["GPT2LMHeadModel", "GPT2Model"])
def test_params_bit_equal_to_jax(cls):
    torch.manual_seed(1)
    model = getattr(transformers, cls)(small_hf_config()).eval()
    tp, tc = thf.params_from_hf(model, device="cpu")
    jp, jc = jhf.params_from_hf(model)
    _assert_trees_bit_equal(tp, jp)
    assert tc.tied_head and "head" not in tp and tc.attn_proj_bias
    for f in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
              "max_seq_len", "ln_eps", "gelu_exact"):
        assert getattr(tc, f) == getattr(jc, f), f


def test_logits_match_hf_and_jax(gpt2_pair):
    model, tp, tc, jp, jc = gpt2_pair
    ids = np.random.default_rng(1).integers(0, tc.vocab_size, (3, 24))
    with torch.no_grad():
        ours, _ = tt.forward(tp, torch.from_numpy(ids), tc)
    np.testing.assert_allclose(ours.numpy(), hf_logits(model, ids), **TOL)
    theirs, _ = jt.forward(jp, jnp.asarray(ids, jnp.int32), jc)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_kv_cache_decode_matches_hf(gpt2_pair):
    model, tp, tc, _, _ = gpt2_pair
    ids = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 16))
    toks, logits = tgen.make_generate_fn(tc, 16)(tp, torch.from_numpy(ids),
                                                 0)
    np.testing.assert_array_equal(toks.numpy(), ids)
    np.testing.assert_allclose(logits.numpy(), hf_logits(model, ids), **TOL)


def test_greedy_generation_matches_hf_generate(gpt2_pair):
    """Whole-loop equality with an explicit all-ones attention mask (HF
    would otherwise mask prompt tokens that equal pad_token_id)."""
    model, tp, tc, _, _ = gpt2_pair
    prompt = np.random.default_rng(5).integers(
        0, tc.vocab_size, (3, 8)).astype(np.int32)
    ours = tgen.generate(tp, tc, prompt, max_len=18)
    with torch.no_grad():
        ref = model.generate(
            torch.tensor(prompt, dtype=torch.long),
            attention_mask=torch.ones((3, 8), dtype=torch.long),
            max_new_tokens=10, do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(ours, ref.numpy())


def test_train_then_export_roundtrip(gpt2_pair):
    """A step on the imported weights (the tied head's gradient flows into
    the one embedding), exported into a fresh GPT2LMHeadModel: its logits
    equal the port's, and the state dict round-trips bit for bit."""
    model, tp, tc, _, _ = gpt2_pair
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 17)))
    trained = tt.tree_map(torch.clone, tp)
    opt = tt.init_opt_state(trained)
    step = tt.make_train_step(tc, lr=1e-3)
    l1, trained, opt = step(trained, opt, toks[:, :-1], toks[:, 1:])
    l2, trained, opt = step(trained, opt, toks[:, :-1], toks[:, 1:])
    assert float(l2) < float(l1)
    assert not torch.equal(trained["embed"], tp["embed"])
    fresh = transformers.GPT2LMHeadModel(model.config).eval()
    thf.export_to_hf(trained, tc, fresh)
    ids = rng.integers(0, tc.vocab_size, (3, 20))
    with torch.no_grad():
        ours, _ = tt.forward(trained, torch.from_numpy(ids), tc)
    np.testing.assert_allclose(ours.numpy(), hf_logits(fresh, ids), **TOL)
    back, _ = thf.params_from_hf(fresh, device="cpu")
    _assert_trees_bit_equal(back, trained)


def test_state_dict_round_trip_and_stand_in(gpt2_pair):
    model, tp, tc, _, _ = gpt2_pair
    want = {k[len("transformer."):]: v.numpy()
            for k, v in model.state_dict().items()
            if k.startswith("transformer.") and ".attn.bias" not in k
            and ".attn.masked_bias" not in k}
    got = thf.state_dict_from_params(tp, tc)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    sd = model.state_dict()
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(**model.config.to_dict()),
        state_dict=lambda: sd)
    sp, sc = thf.params_from_hf(stand_in, device="cpu")
    _assert_trees_bit_equal(sp, tp)
    assert _eval_cfg(sc) == tc


@pytest.mark.parametrize("over,match", [
    (dict(scale_attn_by_inverse_layer_idx=True), "inverse_layer_idx"),
    (dict(reorder_and_upcast_attn=True), "reorder_and_upcast_attn"),
    (dict(scale_attn_weights=False), "scale_attn_weights"),
    (dict(activation_function="relu"), "activation"),
])
def test_import_refuses_attention_variants(over, match):
    torch.manual_seed(2)
    model = transformers.GPT2LMHeadModel(small_hf_config(**over)).eval()
    with pytest.raises(NotImplementedError, match=match):
        thf.params_from_hf(model, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        jhf.params_from_hf(model)


@pytest.mark.parametrize("case,match", [
    ("truncated_cfg", "n_layers"), ("layer_mismatch", "no slot"),
    ("untied_export", "tied_head"), ("cross_attention", "add_cross"),
])
def test_refusals(gpt2_pair, case, match):
    model, tp, tc, jp, jc = gpt2_pair
    if case == "truncated_cfg":
        with pytest.raises(ValueError, match=match):
            thf.params_from_hf(model, thf.config_from_hf(model.config,
                                                         n_layers=1), "cpu")
    elif case == "layer_mismatch":
        # 2-layer params into a 1-layer model raise, never truncate
        small = transformers.GPT2LMHeadModel(small_hf_config(
            n_layer=1)).eval()
        with pytest.raises(ValueError, match=match):
            thf.export_to_hf(tp, tc, small)
    elif case == "untied_export":
        with pytest.raises(ValueError, match=match):
            thf.export_to_hf(tp, dataclasses.replace(tc, tied_head=False),
                             model)
    else:
        cfg = types.SimpleNamespace(**dict(model.config.to_dict(),
                                           add_cross_attention=True))
        with pytest.raises(NotImplementedError, match=match):
            thf.config_from_hf(cfg)
        with pytest.raises(NotImplementedError, match=match):
            jhf.config_from_hf(cfg)


def test_standin_has_the_transformers_layout():
    """``hf_standins.gpt2`` at small widths has GPT2LMHeadModel's names and
    shapes, lm_head the very tensor of wte, and imports as the model."""
    from hetu_tpu_torch.examples import hf_standins
    small = dict(vocab_size=96, n_positions=32, n_embd=48, n_layer=2,
                 n_head=4)
    want = {k: tuple(v.shape) for k, v in transformers.GPT2LMHeadModel(
        small_hf_config()).state_dict().items()
            if ".attn.bias" not in k and ".attn.masked_bias" not in k}
    stand_in = hf_standins.gpt2(3, "cpu", **small)
    sd = stand_in.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sd["lm_head.weight"] is sd["transformer.wte.weight"]
    params, cfg = thf.params_from_hf(stand_in, device="cpu")
    assert cfg.tied_head and cfg.d_model == 48
    got = thf.state_dict_from_params(params, cfg)
    for k, v in sd.items():
        if k.startswith("transformer."):
            assert np.array_equal(got[k[len("transformer."):]], v.numpy()), k


def _reference_example(name):
    """examples/nlp/<name>.py as a module of its own name."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "nlp", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record_losses(monkeypatch, module, name, at=0):
    """Wrap ``module.name`` (a step factory) so each step's loss (output
    ``at``) is recorded as a float."""
    losses, make = [], getattr(module, name)

    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(*a):
            out = step(*a)
            losses.append(float(out[at]))
            return out
        return recorded

    monkeypatch.setattr(module, name, factory)
    return losses


def test_pipeline_example_matches_the_reference(monkeypatch):
    """gpt2_pipeline.main on the CPU (tokenizer -> import -> 2 steps ->
    greedy/sampled/speculative decode -> export -> HF generates the same
    tokens; the asserts live inside the script): its losses equal the
    reference example's from the same imported weights within rel 1e-5."""
    from hetu_tpu_torch.examples import gpt2_pipeline
    argv = ["--steps", "2", "--max-len", "20", "--spec-k", "2"]
    ours = _record_losses(monkeypatch, tt, "make_train_step")
    last = gpt2_pipeline.main(argv, device="cpu")
    theirs = _record_losses(monkeypatch, jt, "make_train_step")
    _reference_example("gpt2_pipeline").main(argv)
    assert len(ours) == len(theirs) == 2 and last == ours[-1]
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
