"""hetu_tpu_torch's ViT (``models/vit.py``) and its HF import and export
(``models/hf_vit.py``) against the JAX package's and ``transformers``.

The flagship ViT: the JAX package's init carried across by
``interop.tree_from_numpy``, seeded images; ``patchify`` equal to the JAX
package's bit for bit (a pure relayout), ``encode`` and
``classify_logits`` in f32 within atol 1e-5, three ``make_train_step``
AdamW steps with the losses within rel 1e-5 and the params held as
``tests/test_torch_bert.py`` holds its train steps (atol 5e-5, m 1e-6, v
1e-9). The HF side: seeded ``ViTModel`` (no pooler) and
``ViTForImageClassification`` import bit-equal to the JAX package's
trees, and the port's hidden states and logits match the HF torch
forward within atol/rtol 2e-4, as ``tests/test_hf_vit.py`` holds the JAX
package's.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

transformers = pytest.importorskip("transformers")

from hetu_tpu.models import hf_vit as jhf
from hetu_tpu.models import vit as jv
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import hf_vit as thf
from hetu_tpu_torch.models import transformer as tt
from hetu_tpu_torch.models import vit as tv
from test_torch_hf_llama import _assert_trees_bit_equal
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(image_size=32, patch_size=8, d_model=48, n_heads=4, n_layers=2,
             d_ff=96, n_classes=6)
HID = dict(atol=1e-5, rtol=0)
HF = dict(atol=2e-4, rtol=2e-4)
PARAMS = dict(rtol=0, atol=5e-5)
M_TOL = dict(rtol=0, atol=1e-6)
V_TOL = dict(rtol=0, atol=1e-9)


def images(rng, n=2, size=32):
    return rng.standard_normal((n, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def vit_pair():
    jc, tc = jv.ViTConfig(**SMALL), tv.ViTConfig(**SMALL)
    jp = jv.init_params(jax.random.PRNGKey(0), jc)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                         like=tv.init_params(0, tc, "cpu"))
    return jc, tc, jp, tp


def test_patchify_is_the_reference_relayout(vit_pair):
    jc, tc, _, _ = vit_pair
    x = images(np.random.default_rng(1), n=3)
    got = tv.patchify(torch.from_numpy(x), tc).numpy()
    assert got.shape == (3, tc.n_patches, 3 * 8 * 8)
    assert np.array_equal(got, np.asarray(jv.patchify(jnp.asarray(x), jc)))
    # patch (gh, gw) = (1, 2) holds the image block in (c, ph, pw) order
    np.testing.assert_array_equal(got[0, 1 * 4 + 2],
                                  x[0, :, 8:16, 16:24].reshape(-1))


@pytest.mark.parametrize("fn", ["encode", "classify_logits"])
def test_forward_matches_jax(vit_pair, fn):
    jc, tc, jp, tp = vit_pair
    x = images(np.random.default_rng(2), n=3)
    with torch.no_grad():
        got = getattr(tv, fn)(tp, torch.from_numpy(x), tc).numpy()
    want = np.asarray(getattr(jv, fn)(jp, jnp.asarray(x), jc))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **HID)


def test_train_steps_match_jax(vit_pair):
    jc, tc, jp, tp = vit_pair
    jp = jax.tree.map(jnp.array, jp)
    jopt = jv.init_opt_state(jp)
    tp = tt.tree_map(torch.clone, tp)
    topt = tv.init_opt_state(tp)
    jstep, tstep = jv.make_train_step(jc, lr=1e-3), tv.make_train_step(
        tc, lr=1e-3)
    rng = np.random.default_rng(3)
    x = images(rng, n=8)
    labels = rng.integers(0, 6, 8).astype(np.int32)
    for _ in range(3):
        jl, ja, jp, jopt = jstep(jp, jopt, jnp.asarray(x),
                                 jnp.asarray(labels))
        tl, ta, tp, topt = tstep(tp, topt, torch.from_numpy(x),
                                 torch.from_numpy(labels))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert float(ta) == float(ja)
    for got, want, tol in ((tp, jp, PARAMS), (topt["m"], jopt["m"], M_TOL),
                           (topt["v"], jopt["v"], V_TOL)):
        _assert_tree_close(got, want, tol)
    assert float(topt["t"]) == float(jopt["t"]) == 3.0


def _assert_tree_close(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=path,
                               **tol)


def test_init_layout_matches_jax(vit_pair):
    """The port's own init has the reference's keys, shapes and dtypes,
    with and without a head, and a mesh is refused (slice 8)."""
    jc, tc, jp, _ = vit_pair
    tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                    like=tv.init_params(1, tc, "cpu"))
    headless = tv.init_params(1, dataclasses.replace(tc, n_classes=0), "cpu")
    assert "cls_w" not in headless and "cls_b" not in headless
    assert tv.count_params(tv.init_params(1, tc, "cpu")) == \
        jv.count_params(jp)
    assert tv.VIT_BASE.seq_len == 197 and tv.VIT_BASE.n_patches == 196
    with pytest.raises(NotImplementedError, match="mesh"):
        tv.make_train_step(tc, mesh=object())


# -- HF import and export ------------------------------------------------

def small_hf_config(**over):
    kw = dict(image_size=32, patch_size=8, num_channels=3, hidden_size=48,
              num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=96, hidden_act="gelu",
              layer_norm_eps=1e-12)
    kw.update(over)
    return transformers.ViTConfig(**kw)


def _hf_model(classes):
    torch.manual_seed(classes)
    if classes:
        return transformers.ViTForImageClassification(
            small_hf_config(num_labels=classes)).eval()
    return transformers.ViTModel(small_hf_config(),
                                 add_pooling_layer=False).eval()


@pytest.mark.parametrize("classes", [0, 7], ids=["vitmodel", "classifier"])
def test_hf_import_bit_equal_and_matches_hf(classes):
    model = _hf_model(classes)
    tp, tc = thf.params_from_hf(model, device="cpu")
    jp, jc = jhf.params_from_hf(model)
    _assert_trees_bit_equal(tp, jp)
    assert tc.n_classes == jc.n_classes == classes
    x = images(np.random.default_rng(4), n=3)
    with torch.no_grad():
        out = model(pixel_values=torch.tensor(x))
        if classes:
            got = tv.classify_logits(tp, torch.from_numpy(x), tc)
            ref = out.logits
        else:
            got = tv.encode(tp, torch.from_numpy(x), tc)
            ref = out.last_hidden_state
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **HF)


def test_hf_n_classes_validation_and_drop():
    """n_classes=0 drops the checkpoint's head; another count refuses."""
    model = _hf_model(7)
    tp, tc = thf.params_from_hf(
        model, thf.config_from_hf(model.config, n_classes=0), "cpu")
    jp, _ = jhf.params_from_hf(
        model, jhf.config_from_hf(model.config, n_classes=0))
    assert "cls_w" not in tp and tc.n_classes == 0
    _assert_trees_bit_equal(tp, jp)
    with pytest.raises(ValueError, match="n_classes"):
        thf.params_from_hf(model, thf.config_from_hf(model.config,
                                                     n_classes=3), "cpu")
    with pytest.raises(ValueError, match="n_classes"):
        jhf.params_from_hf(model, jhf.config_from_hf(model.config,
                                                     n_classes=3))
    assert not thf._has_classifier(_hf_model(0))


def test_hf_train_then_export_roundtrip():
    """A fine-tuning step on the imported weights, exported into a fresh
    ViTForImageClassification: its logits equal the port's; the state dict
    round-trips bit for bit, and a stand-in imports as the model."""
    model = _hf_model(4)
    tp, tc = thf.params_from_hf(model, device="cpu")
    sd = model.state_dict()
    want = {k[len("vit."):] if k.startswith("vit.") else k: v.numpy()
            for k, v in sd.items()}
    got = thf.state_dict_from_params(tp, tc)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(**model.config.to_dict()),
        state_dict=lambda: sd)
    _assert_trees_bit_equal(thf.params_from_hf(stand_in, device="cpu")[0],
                            tp)
    rng = np.random.default_rng(5)
    trained = tt.tree_map(torch.clone, tp)
    _, _, trained, _ = tv.make_train_step(tc, lr=1e-3)(
        trained, tv.init_opt_state(trained), torch.from_numpy(images(rng, 8)),
        torch.from_numpy(rng.integers(0, 4, 8)))
    fresh = _hf_model(4)
    thf.export_to_hf(trained, tc, fresh)
    x = images(rng, n=3)
    with torch.no_grad():
        ref = fresh(pixel_values=torch.tensor(x)).logits.numpy()
        ours = tv.classify_logits(trained, torch.from_numpy(x), tc).numpy()
    np.testing.assert_allclose(ours, ref, **HF)


@pytest.mark.parametrize("case,error,match", [
    ("truncated_cfg", ValueError, "n_layers"),
    ("qkv_bias", NotImplementedError, "qkv_bias"),
    ("hidden_act", NotImplementedError, "hidden_act"),
    ("layer_mismatch", ValueError, "no slot"),
])
def test_hf_refusals(case, error, match):
    model = _hf_model(0)
    if case == "truncated_cfg":
        with pytest.raises(error, match=match):
            thf.params_from_hf(model, thf.config_from_hf(model.config,
                                                         n_layers=1), "cpu")
        with pytest.raises(error, match=match):
            jhf.params_from_hf(model, jhf.config_from_hf(model.config,
                                                         n_layers=1))
    elif case == "layer_mismatch":
        tp, tc = thf.params_from_hf(_hf_model(4), device="cpu")
        small = transformers.ViTForImageClassification(
            small_hf_config(num_labels=4, num_hidden_layers=1)).eval()
        with pytest.raises(error, match=match):
            thf.export_to_hf(tp, tc, small)
    else:
        over = (dict(qkv_bias=False) if case == "qkv_bias"
                else dict(hidden_act="relu"))
        cfg = small_hf_config(**over)
        with pytest.raises(error, match=match):
            thf.config_from_hf(cfg)
        with pytest.raises(error, match=match):
            jhf.config_from_hf(cfg)


def test_standin_has_the_transformers_layout():
    """``hf_standins.vit_classifier`` at small widths has
    ViTForImageClassification's names and shapes, and imports."""
    from hetu_tpu_torch.examples import hf_standins
    small = dict(image_size=32, patch_size=8, hidden_size=48,
                 num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=96, num_labels=4)
    want = {k: tuple(v.shape) for k, v in _hf_model(4).state_dict().items()}
    stand_in = hf_standins.vit_classifier(3, "cpu", **small)
    assert {k: tuple(v.shape) for k, v in
            stand_in.state_dict().items()} == want
    params, cfg = thf.params_from_hf(stand_in, device="cpu")
    assert cfg.n_classes == 4 and cfg.seq_len == 17
    got = thf.state_dict_from_params(params, cfg)
    for k, v in stand_in.state_dict().items():
        assert np.array_equal(got[k[len("vit."):] if k.startswith("vit.")
                                  else k], v.numpy()), k
    full = thf.config_from_hf(types.SimpleNamespace(
        **hf_standins.VIT_B16), n_classes=1000)
    assert dataclasses.replace(full, dtype=tv.VIT_BASE.dtype) == \
        dataclasses.replace(tv.VIT_BASE, n_classes=1000)
