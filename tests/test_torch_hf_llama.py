"""hetu_tpu_torch's Llama import and export (``models/hf_llama.py``)
against the JAX package's and against ``transformers``.

Random-weight ``transformers`` models (no network; seeded) in three
dialects: GQA with an untied head (num_key_value_heads < heads), MHA with
a tied head, and a windowless Mistral config. Each goes through both
packages' ``params_from_hf``: the two numpy trees are bit-equal. The
port's f32 logits (``attn_impl="dot"``) match the HF torch forward and
the JAX package's within atol/rtol 3e-4, as ``tests/test_hf_llama.py``
holds the JAX package's; greedy generation equals ``transformers``'
``generate`` token for token, as there. A stand-in with only ``config``
and ``state_dict()`` imports exactly as the model does (the card's path,
where ``transformers`` is not installed).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from hetu_tpu.models import hf_llama as jhf
from hetu_tpu.models import transformer as jt
from hetu_tpu_torch.models import generate as tgen
from hetu_tpu_torch.models import hf_llama as thf
from hetu_tpu_torch.models import transformer as tt
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=3e-4, rtol=3e-4)


def small_hf_config(**over):
    kw = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2,  # GQA
              intermediate_size=112, max_position_embeddings=64,
              rms_norm_eps=1e-6, rope_theta=10000.0,
              tie_word_embeddings=False)
    kw.update(over)
    return transformers.LlamaConfig(**kw)


def _model(variant):
    torch.manual_seed({"gqa": 0, "mha_tied": 7, "mistral": 10}[variant])
    if variant == "mistral":
        return transformers.MistralForCausalLM(transformers.MistralConfig(
            vocab_size=96, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=112, max_position_embeddings=64,
            rms_norm_eps=1e-6, sliding_window=None)).eval()
    if variant == "mha_tied":
        return transformers.LlamaForCausalLM(small_hf_config(
            num_key_value_heads=4, tie_word_embeddings=True)).eval()
    return transformers.LlamaForCausalLM(small_hf_config()).eval()


def _eval_cfg(cfg):
    return dataclasses.replace(cfg, remat=False, attn_impl="dot",
                               fused_lm_ce=False)


@pytest.fixture(scope="module", params=["gqa", "mha_tied", "mistral"])
def imported(request):
    """(variant, HF model, the port's params and cfg, the JAX package's)."""
    model = _model(request.param)
    tp, tc = thf.params_from_hf(model, device="cpu")
    jp, jc = jhf.params_from_hf(model)
    return request.param, model, tp, _eval_cfg(tc), jp, _eval_cfg(jc)


def hf_logits(model, ids):
    with torch.no_grad():
        return model(input_ids=torch.tensor(ids)).logits.numpy()


def _assert_trees_bit_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_bit_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = got.detach().cpu().numpy(), np.asarray(want)
    assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, path
    assert np.array_equal(g, w), path


def test_params_bit_equal_to_jax(imported):
    variant, _, tp, tc, jp, jc = imported
    _assert_trees_bit_equal(tp, jp)
    assert tc.n_kv_heads == jc.n_kv_heads == (0 if variant == "mha_tied"
                                              else 2)
    assert tc.tied_head == ("head" not in tp) == (variant == "mha_tied")
    for f in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
              "max_seq_len", "ln_eps", "norm", "rope", "rope_theta", "mlp",
              "use_pos_emb", "causal"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.dtype == torch.float32


def test_logits_match_hf_and_jax(imported):
    _, model, tp, tc, jp, jc = imported
    ids = np.random.default_rng(1).integers(0, tc.vocab_size, (3, 20))
    with torch.no_grad():
        ours, _ = tt.forward(tp, torch.from_numpy(ids), tc)
    np.testing.assert_allclose(ours.numpy(), hf_logits(model, ids), **TOL)
    theirs, _ = jt.forward(jp, jnp.asarray(ids, jnp.int32), jc)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_kv_cache_decode_matches_hf(imported):
    """RoPE through the cache: teacher-forced incremental logits equal the
    torch full forward (rotated keys cached at absolute positions)."""
    _, model, tp, tc, _, _ = imported
    ids = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 14))
    toks, logits = tgen.make_generate_fn(tc, 14)(tp, torch.from_numpy(ids),
                                                 0)
    np.testing.assert_array_equal(toks.numpy(), ids)
    np.testing.assert_allclose(logits.numpy(), hf_logits(model, ids), **TOL)


def test_greedy_generation_matches_hf_generate(imported):
    _, model, tp, tc, _, _ = imported
    prompt = np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 6)).astype(np.int32)
    ours = tgen.generate(tp, tc, prompt, max_len=16)
    with torch.no_grad():
        ref = model.generate(
            torch.tensor(prompt, dtype=torch.long),
            attention_mask=torch.ones((2, 6), dtype=torch.long),
            max_new_tokens=10, do_sample=False, pad_token_id=0)
    np.testing.assert_array_equal(ours, ref.numpy())
    # the imported model rides speculative decoding (self-draft: exact)
    spec, rounds = tgen.make_speculative_generate_fn(tc, tc, 16, k=3)(
        tp, tp, prompt[:1])
    np.testing.assert_array_equal(spec.numpy()[0], ours[0])
    assert rounds == -(-(16 - 6 - 1) // 4)


def test_params_own_their_storage(imported):
    """The relayout runs on the checkpoint's device, yet every leaf is a
    contiguous copy: training the params in place leaves the checkpoint
    as it was."""
    _, model, tp, _, _, _ = imported
    held = {t.untyped_storage().data_ptr()
            for t in model.state_dict().values()}
    for leaf in tt.tree_leaves(tp):
        assert leaf.is_contiguous()
        assert leaf.untyped_storage().data_ptr() not in held


def test_train_then_export_roundtrip(imported):
    """Two steps on the imported weights (the loss falls), exported into a
    fresh torch model: its logits equal the port's."""
    _, model, tp, tc, _, _ = imported
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 17)))
    trained = tt.tree_map(torch.clone, tp)
    opt = tt.init_opt_state(trained)
    step = tt.make_train_step(tc, lr=1e-3)
    l1, trained, opt = step(trained, opt, toks[:, :-1], toks[:, 1:])
    l2, trained, opt = step(trained, opt, toks[:, :-1], toks[:, 1:])
    assert float(l2) < float(l1)
    fresh = type(model)(model.config).eval()
    thf.export_to_hf(trained, tc, fresh)
    ids = rng.integers(0, tc.vocab_size, (3, 12))
    with torch.no_grad():
        ours, _ = tt.forward(trained, torch.from_numpy(ids), tc)
    np.testing.assert_allclose(ours.numpy(), hf_logits(fresh, ids), **TOL)


def test_state_dict_round_trip_and_stand_in(imported):
    """``state_dict_from_params`` gives back the checkpoint bit for bit,
    and a stand-in carrying only ``config`` and ``state_dict()`` (a
    namespace of the config's fields) imports exactly as the model."""
    _, model, tp, tc, _, _ = imported
    want = {k[len("model."):] if k.startswith("model.") else k: v.numpy()
            for k, v in model.state_dict().items() if "rotary_emb" not in k}
    if tc.tied_head:
        want.pop("lm_head.weight")
    got = thf.state_dict_from_params(tp, tc)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(**model.config.to_dict()),
        state_dict=lambda: sd)
    sp, sc = thf.params_from_hf(stand_in, device="cpu")
    _assert_trees_bit_equal(sp, tp)
    assert _eval_cfg(sc) == tc


def _fake_cfg(**over):
    kw = dict(vocab_size=96, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, num_hidden_layers=2,
              intermediate_size=112, max_position_embeddings=64,
              rms_norm_eps=1e-6, rope_theta=10000.0,
              tie_word_embeddings=False, hidden_act="silu",
              attention_bias=False, rope_scaling=None, sliding_window=None,
              head_dim=None)
    kw.update(over)
    return types.SimpleNamespace(**kw)


@pytest.mark.parametrize("case,error,match", [
    ("attention_bias", NotImplementedError, "attention_bias"),
    ("sliding_window", NotImplementedError, "sliding_window"),
    ("head_dim", NotImplementedError, "head_dim"),
    ("hidden_act", NotImplementedError, "hidden_act"),
    ("rope_scaling", NotImplementedError, "rope_scaling"),
    ("truncated_cfg", ValueError, "n_layers"),
    ("no_lm_head", ValueError, "no lm_head"),
])
def test_import_refuses(case, error, match):
    """Every refusal of the reference's importer, in both packages."""
    sd = _model("gqa").state_dict()
    bad = {"attention_bias": dict(attention_bias=True),
           "sliding_window": dict(sliding_window=4096),
           "head_dim": dict(head_dim=32),
           "hidden_act": dict(hidden_act="gelu"),
           "rope_scaling": dict(rope_scaling={"rope_type": "linear",
                                              "factor": 2.0})}.get(case, {})
    model = types.SimpleNamespace(config=_fake_cfg(**bad), state_dict=lambda:
                                  sd)
    kw, jkw = {}, {}
    if case == "truncated_cfg":
        kw = dict(cfg=thf.config_from_hf(model.config, n_layers=1))
        jkw = dict(cfg=jhf.config_from_hf(model.config, n_layers=1))
    if case == "no_lm_head":
        model.state_dict = lambda: {k: v for k, v in sd.items()
                                    if not k.startswith("lm_head.")}
    with pytest.raises(error, match=match):
        thf.params_from_hf(model, device="cpu", **kw)
    with pytest.raises(error, match=match):
        jhf.params_from_hf(model, **jkw)


def _hf_layout(sd, skip=("rotary_emb",)):
    return {k: tuple(v.shape) for k, v in sd.items()
            if not any(s in k for s in skip)}


def test_standin_has_the_transformers_layout():
    """``hf_standins.llama`` at small widths has LlamaForCausalLM's names
    and shapes (tied and untied), and imports as the model does."""
    from hetu_tpu_torch.examples import hf_standins
    for tied in (False, True):
        small = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2,
                     intermediate_size=112, max_position_embeddings=64,
                     tie_word_embeddings=tied)
        want = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            **small)).state_dict()
        if tied:
            want = {k: v for k, v in want.items() if k != "lm_head.weight"}
        stand_in = hf_standins.llama(3, "cpu", **small)
        assert _hf_layout(stand_in.state_dict()) == _hf_layout(want)
        params, cfg = thf.params_from_hf(stand_in, device="cpu")
        assert cfg.n_kv_heads == 2 and cfg.tied_head == tied
        sd = thf.state_dict_from_params(params, cfg)
        for k, v in stand_in.state_dict().items():
            assert np.array_equal(sd[k[len("model."):] if k.startswith(
                "model.") else k], v.numpy()), k
    full = hf_standins.TINYLLAMA
    cfg = thf.config_from_hf(types.SimpleNamespace(**full))
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (2048, 22, 32, 4, 64,
                                                         5632, 32000)


NO_TRANSFORMERS = """
import sys
sys.modules["transformers"] = None          # any import of it now fails
import torch
from hetu_tpu_torch.models import (hf_bert, hf_common, hf_gpt2, hf_llama,
                                   hf_vit, transformer, vit)
from hetu_tpu_torch.examples import (finetune_hf_bert, gpt2_pipeline,
                                     hf_standins)
llama = hf_standins.llama(0, "cpu", vocab_size=96, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=2, intermediate_size=112,
                          max_position_embeddings=64)
p, c = hf_llama.params_from_hf(llama, device="cpu")
logits, _ = transformer.forward(p, torch.zeros((1, 8), dtype=torch.long), c)
assert logits.shape == (1, 8, 96) and torch.isfinite(logits).all()
v = hf_standins.vit_classifier(0, "cpu", image_size=32, patch_size=8,
                               hidden_size=48, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=96,
                               num_labels=5)
p, c = hf_vit.params_from_hf(v, device="cpu")
out = vit.classify_logits(p, torch.zeros((2, 3, 32, 32)), c)
assert out.shape == (2, 5) and c.n_classes == 5
for leg in (finetune_hf_bert.demo_model, gpt2_pipeline.load):
    try:
        leg()
    except ImportError:
        pass
    else:
        raise AssertionError(f"{leg.__name__} ran without transformers")
assert not any(m.split(".")[0] in ("jax", "hetu_tpu") for m in sys.modules)
print("ok")
"""


def test_port_hf_modules_need_no_transformers():
    """Every new module of the port imports with ``transformers`` unusable,
    and a Llama and a ViT stand-in import and run: the card's path. Only
    the two legs that build a ``transformers`` model need the package."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", NO_TRANSFORMERS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
