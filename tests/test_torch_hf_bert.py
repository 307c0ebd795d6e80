"""hetu_tpu_torch's BERT import and export (``models/hf_bert.py``) against
the JAX package's and against ``transformers``.

Seeded random-weight ``BertModel``, ``BertForPreTraining`` and
``BertForSequenceClassification`` go through both packages'
``params_from_hf``: the numpy trees are bit-equal. The port's f32 forward
(``attn_impl="dot"``) matches the HF torch forward and the JAX package's:
hidden states, NSP and classifier logits within atol/rtol 2e-4, MLM
logits within 3e-4, with and without a ragged padding mask, as
``tests/test_hf_bert.py`` holds the JAX package's.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from hetu_tpu.models import bert as jb
from hetu_tpu.models import hf_bert as jhf
from hetu_tpu_torch.models import bert as tb
from hetu_tpu_torch.models import hf_bert as thf
from hetu_tpu_torch.models import transformer as tt
from test_torch_hf_llama import _assert_trees_bit_equal
from test_torch_threads import one_torch_thread  # noqa: F401

HID = dict(atol=2e-4, rtol=2e-4)
MLM = dict(atol=3e-4, rtol=3e-4)


def small_hf_config(**over):
    kw = dict(vocab_size=211, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=48, type_vocab_size=2,
              hidden_act="gelu", layer_norm_eps=1e-12)
    kw.update(over)
    return transformers.BertConfig(**kw)


def make_batch(rng, B=3, T=16, ragged=False):
    ids = rng.integers(0, 211, size=(B, T)).astype(np.int64)
    seg = rng.integers(0, 2, size=(B, T)).astype(np.int64)
    mask = np.ones((B, T), np.int64)
    if ragged:
        for b in range(B):
            mask[b, rng.integers(T // 2, T + 1):] = 0
    return ids, seg, mask


def _eval_cfg(cfg, **kw):
    return dataclasses.replace(cfg, attn_impl="dot", fused_mlm_ce=False,
                               remat=False, **kw)


@pytest.fixture(scope="module")
def pretraining_pair():
    torch.manual_seed(0)
    model = transformers.BertForPreTraining(small_hf_config()).eval()
    tp, tc = thf.params_from_hf(model, device="cpu")
    jp, jc = jhf.params_from_hf(model)
    return model, tp, _eval_cfg(tc), jp, _eval_cfg(jc)


def _encode(params, cfg, ids, seg, mask):
    with torch.no_grad():
        return tb.encode(params, torch.from_numpy(ids), torch.from_numpy(seg),
                         cfg, input_mask=torch.from_numpy(mask))


@pytest.mark.parametrize("cls", ["BertModel", "BertForPreTraining",
                                 "BertForSequenceClassification"])
def test_params_bit_equal_to_jax(cls):
    torch.manual_seed(1)
    model = getattr(transformers, cls)(small_hf_config(num_labels=5)).eval()
    tp, tc = thf.params_from_hf(model, device="cpu")
    jp, jc = jhf.params_from_hf(model)
    _assert_trees_bit_equal(tp, jp)
    heads = {"BertModel": {"pool_w"}, "BertForPreTraining": {"mlm_dense",
                                                             "nsp_w"},
             "BertForSequenceClassification": {"cls_w"}}[cls]
    assert heads <= set(tp)
    assert tc.post_ln and tc.attn_proj_bias and tc.gelu_exact
    for f in thf._ARCH_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_encoder_hidden_states_match(pretraining_pair, ragged):
    model, tp, tc, jp, jc = pretraining_pair
    ids, seg, mask = make_batch(np.random.default_rng(1), ragged=ragged)
    with torch.no_grad():
        ref = model.bert(input_ids=torch.tensor(ids),
                         token_type_ids=torch.tensor(seg),
                         attention_mask=torch.tensor(mask)).last_hidden_state
    h = _encode(tp, tc, ids, seg, mask).numpy()
    jh = np.asarray(jb.encode(jp, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(seg, jnp.int32), jc,
                              input_mask=jnp.asarray(mask, jnp.int32)))
    # only real (unpadded) positions are defined: HF lets padded queries
    # attend normally, and downstream consumers mask them
    real = mask.astype(bool)
    np.testing.assert_allclose(h[real], ref.numpy()[real], **HID)
    np.testing.assert_allclose(h[real], jh[real], **HID)


def test_mlm_and_nsp_logits_match(pretraining_pair):
    model, tp, tc, _, _ = pretraining_pair
    ids, seg, mask = make_batch(np.random.default_rng(2))
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids),
                    token_type_ids=torch.tensor(seg),
                    attention_mask=torch.tensor(mask))
        h = _encode(tp, tc, ids, seg, mask)
        all_pos = torch.arange(ids.shape[1]).expand(ids.shape)
        mlm = tb.mlm_logits(tp, h, all_pos, tc)
        nsp = tb.nsp_logits(tp, h)
    np.testing.assert_allclose(mlm.numpy(), out.prediction_logits.numpy(),
                               **MLM)
    np.testing.assert_allclose(nsp.numpy(),
                               out.seq_relationship_logits.numpy(), **HID)


def test_sequence_classifier_matches():
    torch.manual_seed(4)
    model = transformers.BertForSequenceClassification(
        small_hf_config(num_labels=5)).eval()
    tp, tc = thf.params_from_hf(model, device="cpu")
    ids, seg, mask = make_batch(np.random.default_rng(5), ragged=True)
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids),
                    token_type_ids=torch.tensor(seg),
                    attention_mask=torch.tensor(mask)).logits.numpy()
        ours = tb.classify_logits(tp, torch.from_numpy(ids),
                                  torch.from_numpy(seg), _eval_cfg(tc),
                                  input_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, **HID)


def test_train_then_export_roundtrip(pretraining_pair):
    """Two pretraining steps on the imported weights (the loss falls),
    exported into a fresh BertForPreTraining: its MLM and NSP logits equal
    the port's; exported into a bare BertModel, the heads drop and the
    encoder still matches."""
    model, tp, tc, _, _ = pretraining_pair
    rng = np.random.default_rng(9)
    B, T, P = 2, 16, 4
    batch = {
        "input_ids": torch.from_numpy(rng.integers(0, 211, (B, T))),
        "segment_ids": torch.zeros((B, T), dtype=torch.int64),
        "input_mask": torch.ones((B, T), dtype=torch.int64),
        "mlm_positions": torch.from_numpy(rng.integers(1, T, (B, P))),
        "mlm_ids": torch.from_numpy(rng.integers(0, 211, (B, P))),
        "mlm_weights": torch.ones((B, P)),
        "nsp_label": torch.from_numpy(rng.integers(0, 2, (B,))),
    }
    trained = tt.tree_map(torch.clone, tp)
    opt = tb.init_opt_state(trained)
    step = tb.make_pretrain_step(tc, lr=1e-3)
    l1, _, trained, opt = step(trained, opt, batch)
    l2, _, trained, opt = step(trained, opt, batch)
    assert float(l2) < float(l1)
    fresh = transformers.BertForPreTraining(small_hf_config()).eval()
    thf.export_to_hf(trained, tc, fresh)
    bare = transformers.BertModel(small_hf_config()).eval()
    thf.export_to_hf(trained, tc, bare)
    ids, seg, mask = make_batch(np.random.default_rng(10))
    with torch.no_grad():
        out = fresh(input_ids=torch.tensor(ids),
                    token_type_ids=torch.tensor(seg),
                    attention_mask=torch.tensor(mask))
        bare_h = bare(input_ids=torch.tensor(ids),
                      token_type_ids=torch.tensor(seg),
                      attention_mask=torch.tensor(mask)).last_hidden_state
        h = _encode(trained, tc, ids, seg, mask)
        all_pos = torch.arange(ids.shape[1]).expand(ids.shape)
        mlm = tb.mlm_logits(trained, h, all_pos, tc)
        nsp = tb.nsp_logits(trained, h)
    np.testing.assert_allclose(mlm.numpy(), out.prediction_logits.numpy(),
                               **MLM)
    np.testing.assert_allclose(nsp.numpy(),
                               out.seq_relationship_logits.numpy(), **HID)
    np.testing.assert_allclose(h.numpy(), bare_h.numpy(), **HID)


def test_state_dict_round_trip_and_stand_in(pretraining_pair):
    model, tp, tc, _, _ = pretraining_pair
    want = {k[len("bert."):] if k.startswith("bert.") else k: v.numpy()
            for k, v in model.state_dict().items()
            if not k.endswith(("position_ids", "token_type_ids"))}
    got = thf.state_dict_from_params(tp, tc)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    sd = model.state_dict()
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(**model.config.to_dict()),
        state_dict=lambda: sd)
    sp, _ = thf.params_from_hf(stand_in, device="cpu")
    _assert_trees_bit_equal(sp, tp)


@pytest.mark.parametrize("case,error,match", [
    ("preln_cfg", ValueError, "post-LN"),
    ("relative_positions", NotImplementedError, "position_embedding"),
    ("truncated_cfg", ValueError, "n_layers"),
    ("decoder", NotImplementedError, "decoder"),
    ("hidden_act", NotImplementedError, "hidden_act"),
    ("layer_mismatch", ValueError, "no slot"),
])
def test_refusals(pretraining_pair, case, error, match):
    """Every refusal of the reference's tests, in both packages."""
    model, tp, tc, _, _ = pretraining_pair
    shape = dict(vocab_size=211, d_model=64, n_heads=4, d_ff=128,
                 max_seq_len=48)
    over = {"relative_positions": dict(
        position_embedding_type="relative_key"),
        "decoder": dict(is_decoder=True),
        "hidden_act": dict(hidden_act="relu")}.get(case)
    if over is not None:
        torch.manual_seed(8)
        bad = transformers.BertModel(small_hf_config(**over)).eval()
        with pytest.raises(error, match=match):
            thf.params_from_hf(bad, device="cpu")
        with pytest.raises(error, match=match):
            jhf.params_from_hf(bad)
    elif case == "layer_mismatch":
        small = transformers.BertForPreTraining(
            small_hf_config(num_hidden_layers=1)).eval()
        with pytest.raises(error, match=match):
            thf.export_to_hf(tp, tc, small)
    else:
        mk, jmk = ((tb.BertConfig, jb.BertConfig) if case == "preln_cfg"
                   else (tb.BertConfig.hf, jb.BertConfig.hf))
        n = 2 if case == "preln_cfg" else 1
        with pytest.raises(error, match=match):
            thf.params_from_hf(model, mk(n_layers=n, **shape), "cpu")
        with pytest.raises(error, match=match):
            jhf.params_from_hf(model, jmk(n_layers=n, **shape))


def test_standin_has_the_transformers_layout():
    """``hf_standins.bert_classifier`` at small widths has
    BertForSequenceClassification's names and shapes, and imports."""
    from hetu_tpu_torch.examples import hf_standins
    small = dict(vocab_size=211, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=48)
    want = {k: tuple(v.shape) for k, v in
            transformers.BertForSequenceClassification(small_hf_config(
                num_labels=3)).state_dict().items()
            if not k.endswith(("position_ids", "token_type_ids"))}
    stand_in = hf_standins.bert_classifier(3, "cpu", num_labels=3, **small)
    assert {k: tuple(v.shape) for k, v in
            stand_in.state_dict().items()} == want
    params, cfg = thf.params_from_hf(stand_in, device="cpu")
    assert tuple(params["cls_w"].shape) == (64, 3) and cfg.n_layers == 2
    got = thf.state_dict_from_params(params, cfg)
    for k, v in stand_in.state_dict().items():
        assert np.array_equal(got[k[len("bert."):] if k.startswith("bert.")
                                  else k], v.numpy()), k


def test_finetune_example_matches_the_reference(monkeypatch):
    """finetune_hf_bert.main on the CPU at 2 steps from the reference's
    demo BertModel, the reference example's grafted head carried across:
    its losses equal the reference example's within rel 1e-5."""
    import jax
    from hetu_tpu_torch.examples import finetune_hf_bert
    from test_torch_hf_gpt2 import _record_losses, _reference_example
    jparams, jcfg = jhf.params_from_hf(finetune_hf_bert.demo_model())
    head = jb.init_classifier_params(jax.random.PRNGKey(0), jcfg, 2,
                                     pretrained=jparams)
    graft = tb.init_classifier_params

    def reference_head(seed, cfg, n, pretrained):
        params = graft(seed, cfg, n, pretrained=pretrained)
        for k in ("cls_w", "cls_b"):
            params[k] = torch.from_numpy(np.array(head[k]))
        return params

    monkeypatch.setattr(tb, "init_classifier_params", reference_head)
    ours = _record_losses(monkeypatch, tb, "make_finetune_step")
    acc = finetune_hf_bert.main(["--steps", "2"], device="cpu")
    theirs = _record_losses(monkeypatch, jb, "make_finetune_step")
    _reference_example("finetune_hf_bert").main(["--steps", "2"])
    assert len(ours) == len(theirs) == 2 and 0.0 <= acc <= 1.0
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
