"""hetu_tpu_torch's BERT and transformer, forward and training, against
the JAX package.

The same params (``hetu_tpu``'s init, carried across with
``interop.tree_from_numpy``) and the same batch (numpy, seeded) go through
``hetu_tpu.models.{bert,transformer}`` and ``hetu_tpu_torch.models``' at a
small width, in f32. Attention runs ``flash`` on both sides (the JAX
package's Pallas kernels in interpret mode, the port's plain versions) and
``dot``; the MLM and LM losses run fused (likewise) and unfused. The train
steps start from the same params and AdamW state and take three steps.

Tolerances: hidden states and logits atol 1e-4 (two layers of f32 matmuls
summed in another order); losses rel 1e-5. After three AdamW steps at lr
1e-3: params atol 5e-5, a twentieth of one step (AdamW divides each
gradient by its own running RMS, so an element whose gradient is near 0
turns a 1e-7 difference in it into a visible part of its step; the worst
element seen moved 2.5e-5); m atol 1e-6 and v atol 1e-9 (gradients up to
~1 that agree to f32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.models import bert as jb, transformer as jt
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.kernels import embed_grad as teg, registry
from hetu_tpu_torch.models import bert as tb, transformer as tt
from test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=32, remat=False)
B, T, P = 4, 32, 5
HID = dict(atol=1e-4, rtol=0)
LOSS = dict(rtol=1e-5, atol=0)


def _configs(hf, **kw):
    jc = (jb.BertConfig.hf if hf else jb.BertConfig)(
        dtype=jnp.float32, **SMALL, **kw)
    tc = (tb.BertConfig.hf if hf else tb.BertConfig)(
        dtype=torch.float32, **SMALL, **kw)
    return jc, tc


@pytest.fixture(scope="module", params=[False, True], ids=["preln", "hf"])
def bert_pair(request):
    """(hf, JAX params, the port's params carried across)."""
    jc, tc = _configs(request.param)
    jp = jb.init_params(jax.random.PRNGKey(0), jc)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                         like=tb.init_params(0, tc, "cpu"))
    return request.param, jp, tp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    mask = np.ones((B, T), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    return {"input_ids": rng.randint(0, 97, (B, T)).astype(np.int32),
            "input_mask": mask,
            "segment_ids": (np.arange(T)[None, :] >= T // 2)
                           .astype(np.int32).repeat(B, 0),
            "mlm_positions": rng.randint(1, T, (B, P)).astype(np.int32),
            "mlm_ids": rng.randint(0, 97, (B, P)).astype(np.int32),
            "mlm_weights": (rng.rand(B, P) > 0.2).astype(np.float32),
            "nsp_label": rng.randint(0, 2, (B,)).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_encode_matches_jax(bert_pair, batch, impl):
    hf, jp, tp = bert_pair
    jc, tc = _configs(hf, attn_impl=impl)
    want = jb.encode(jp, batch["input_ids"], batch["segment_ids"], jc,
                     input_mask=batch["input_mask"])
    got = tb.encode(tp, torch.from_numpy(batch["input_ids"]),
                    torch.from_numpy(batch["segment_ids"]), tc,
                    input_mask=torch.from_numpy(batch["input_mask"]))
    assert got.shape == (B, T, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HID)


@pytest.mark.parametrize("impl,fused", [("dot", False), ("flash", True)])
def test_pretrain_loss_matches_jax(bert_pair, batch, impl, fused):
    hf, jp, tp = bert_pair
    jc, tc = _configs(hf, attn_impl=impl, fused_mlm_ce=fused)
    jl, (jm, jn) = jb.pretrain_loss(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    tl, (tm, tn) = tb.pretrain_loss(tp, _tb(batch), tc)
    np.testing.assert_allclose([float(tl), float(tm), float(tn)],
                               [float(jl), float(jm), float(jn)], **LOSS)


def test_classify_logits_matches_jax(bert_pair, batch):
    hf, jp, tp = bert_pair
    jc, tc = _configs(hf, attn_impl="flash")
    jcp = jb.init_classifier_params(jax.random.PRNGKey(1), jc, 3,
                                    pretrained=jp)
    tcp = tree_from_numpy(
        jax.tree.map(np.asarray, jcp), "cpu",
        like=tb.init_classifier_params(1, tc, 3, pretrained=tp))
    want = jb.classify_logits(jcp, batch["input_ids"], batch["segment_ids"],
                              jc, input_mask=batch["input_mask"])
    got = tb.classify_logits(tcp, torch.from_numpy(batch["input_ids"]),
                             torch.from_numpy(batch["segment_ids"]), tc,
                             input_mask=torch.from_numpy(batch["input_mask"]))
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HID)
    assert tb.count_params(tp) == jb.count_params(jp)


LM = dict(vocab_size=101, d_model=64, n_heads=4, n_layers=2, d_ff=128,
          max_seq_len=32, remat=False)


@pytest.mark.parametrize("tied", [False, True], ids=["dv_head", "vd_tied"])
@pytest.mark.parametrize("fused", [False, True])
def test_causal_lm_loss_matches_jax(tied, fused):
    kw = dict(LM, tied_head=tied, fused_lm_ce=fused, attn_impl="flash")
    jc = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tc = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jt.init_params(jax.random.PRNGKey(2), jc)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                         like=tt.init_params(0, tc, "cpu"))
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 101, (2, T)).astype(np.int32)
    targets = rng.randint(0, 101, (2, T)).astype(np.int32)
    want = jt.loss_fn(jp, jnp.asarray(tokens), jnp.asarray(targets), jc)
    got = tt.loss_fn(tp, torch.from_numpy(tokens), torch.from_numpy(targets),
                     tc)
    np.testing.assert_allclose(float(got), float(want), **LOSS)


@pytest.mark.parametrize("dialect", [
    dict(rope=True, use_pos_emb=False),
    dict(n_kv_heads=2),
    dict(mlp="swiglu", norm="rmsnorm"),
    dict(post_ln=True, gelu_exact=True, attn_proj_bias=True),
], ids=["rope", "gqa", "swiglu_rmsnorm", "postln"])
def test_dialects_forward_match_jax(dialect):
    kw = dict(LM, **dialect)
    jc = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tc = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jt.init_params(jax.random.PRNGKey(3), jc)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                         like=tt.init_params(0, tc, "cpu"))
    tokens = np.random.RandomState(2).randint(0, 101, (2, T)).astype(np.int32)
    want, _ = jt.forward(jp, jnp.asarray(tokens), jc)
    got, aux = tt.forward(tp, torch.from_numpy(tokens), tc)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HID)


def test_init_schedule_and_interop_checks():
    tc = tt.TransformerConfig(dtype=torch.float32, **LM)
    full = tt.init_params(7, tc, "cpu")
    trunk = tt.init_trunk_params(7, tc, "cpu")
    for k, v in trunk["blocks"].items():
        assert torch.equal(v, full["blocks"][k])
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0),
                                                 jt.TransformerConfig(**LM)))
    assert tt.count_params(full) == jt.count_params(jp)
    bad = dict(jp, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        tree_from_numpy(bad, "cpu", like=full)
    wrong = dict(jp, embed=np.zeros((5, 64), np.float32))
    with pytest.raises(ValueError, match="embed"):
        tree_from_numpy(wrong, "cpu", like=full)
    f64 = dict(jp, lnf_scale=jp["lnf_scale"].astype(np.float64))
    with pytest.raises(ValueError, match="lnf_scale: torch.float64"):
        tree_from_numpy(f64, "cpu", like=full)
    flat = dict(jp, blocks=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="blocks"):
        tree_from_numpy(flat, "cpu", like=full)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tb.BertConfig(dtype=torch.float32, **SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tree_from_numpy({"w": np.zeros(2, np.float32)})
    assert tb.init_params(0, cfg, "cpu")["embed"].device.type == "cpu"


def test_unported_paths_raise(batch):
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    ring = tt.TransformerConfig(dtype=torch.float32, attn_impl="ring", **LM)
    p = tt.init_params(0, ring, "cpu")
    with pytest.raises(NotImplementedError, match="ring.*slice 8"):
        tt.forward(p, tokens, ring)
    plain = tt.TransformerConfig(dtype=torch.float32, **LM)
    with pytest.raises(NotImplementedError, match="mesh"):
        tt.forward(p, tokens, plain, mesh=object())
    # the train steps' options that wait for later slices
    with pytest.raises(NotImplementedError, match="mesh"):
        tt.make_train_step(plain, mesh=object())
    with pytest.raises(NotImplementedError, match="zero1"):
        tt.make_train_step(plain, zero1=True)
    # training-time dropout is ported: its step refuses a missing key
    drop = tt.TransformerConfig(dtype=torch.float32, dropout_rate=0.1, **LM)
    pd = tt.init_params(0, drop, "cpu")
    with pytest.raises(ValueError, match="dropout_rng"):
        tt.make_train_step(drop)(pd, tt.init_opt_state(pd), tokens, tokens)
    cfg = tb.BertConfig(dtype=torch.float32, **SMALL)
    with pytest.raises(NotImplementedError, match="mesh"):
        tb.make_pretrain_step(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tb.make_finetune_step(cfg, mesh=object())


def test_auto_rules_and_batch_from_instances(batch):
    cfg = tt.TransformerConfig(**LM)
    kp = torch.zeros((2, 1, 1, 128))
    assert tt._resolve_attn_impl(cfg, None, 128, kp, "cpu") == "dot"
    assert tt._resolve_attn_impl(cfg, None, 128, kp, "cuda:0") == "flash"
    assert tt._resolve_attn_impl(cfg, None, 96, kp, "cuda:0") == "dot"
    flash = tt.TransformerConfig(attn_impl="flash", **LM)
    with pytest.warns(UserWarning, match="non-key-padding"):
        assert tt._resolve_attn_impl(flash, None, 128,
                                     torch.zeros((2, 1, 128, 128))) == "dot"
    # the reference's rule: T % min(128, T), so only T > 128 can miss it
    with pytest.warns(UserWarning, match="divisible by 128"):
        assert tt._resolve_attn_impl(flash, None, 192,
                                     torch.zeros((2, 1, 1, 192))) == "dot"
    assert tt._resolve_attn_impl(flash, None, 96, kp[..., :96]) == "flash"
    rows = [tuple(batch[k][i] for k in ("input_ids", "input_mask",
                                        "segment_ids", "mlm_positions",
                                        "mlm_ids")) + (int(batch["nsp_label"][i]),)
            for i in range(B)]
    want = jb.batch_from_instances(rows)
    got = tb.batch_from_instances(rows, "cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # and through the kernels' dispatch on the CPU: plain versions only
    registry.reset_stats()
    bc = tb.BertConfig(dtype=torch.float32, fused_mlm_ce=True,
                       attn_impl="flash", **SMALL)
    with torch.inference_mode():
        tb.pretrain_loss(tb.init_params(0, bc, "cpu"), got, bc)
    assert registry.dispatch_stats() == {
        ("flash_attention_fwd", "plain"): 2,
        ("fused_linear_nll_fwd", "plain"): 1}


def test_bert_forward_example_runs_on_the_cpu():
    from hetu_tpu_torch.examples import bert_forward
    # a vocabulary that holds BERT's special ids (101-103) and words (1000+)
    cfg = tb.BertConfig(dtype=torch.float32, **dict(SMALL, vocab_size=1100))
    batch = bert_forward.phase1_batch(cfg, 4, 32, n_pred=5, device="cpu")
    w = batch["mlm_weights"].numpy()
    assert w.shape == (4, 5) and (w.sum(1) >= 1).all()
    pos = batch["mlm_positions"].numpy()
    assert (batch["input_ids"].numpy()[np.arange(4)[:, None], pos][w > 0]
            == bert_forward.MASK).all()
    res = list(bert_forward.run("cpu", 4, 32, 2, iters=1, cfg=cfg))
    assert [r["entry"] for r in res] == ["pretrain_loss", "classify_logits"]
    assert np.isfinite(res[0]["mlm"]) and res[1]["logits_shape"] == [2, 2]
    assert res[0]["launches"] == {} and res[1]["launches"] == {}


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::flash_fwd_tc_kernel<64>(__nv_bfloat16 "
     "const*, ...)", "flash_attention_fwd"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64>(float const*, "
     "...)", "flash_attention_fwd"),
    ("void (anonymous namespace)::flash_bwd_dq_tc_kernel<64>(...)",
     "flash_attention_bwd"),
    ("void (anonymous namespace)::linear_nll_fwd_tc_kernel<false>(...)",
     "fused_linear_nll_fwd"),
    ("(anonymous namespace)::linear_nll_combine_kernel(float const*, ...)",
     "fused_linear_nll_fwd"),
    ("void (anonymous namespace)::linear_nll_bwd_g_tc_kernel<false>(...)",
     "fused_linear_nll_bwd"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>(...)", "other"),
    ("void (anonymous namespace)::spmm_chunk_kernel<true>(int const*, ...)",
     "csr_spmm"),
    ("void (anonymous namespace)::spmm_merge_kernel<false>(int const*, ...)",
     "csr_spmm"),
    ("(anonymous namespace)::spmv_chunk_kernel(int const*, long, ...)",
     "csr_spmv"),
    ("(anonymous namespace)::spmv_merge_kernel(int const*, long, ...)",
     "csr_spmv"),
    ("void (anonymous namespace)::segsum_chunk_kernel<4>(float const*, ...)",
     "fused_embed_grad"),
    ("void (anonymous namespace)::segsum_fold_kernel<1>(int const*, ...)",
     "fused_embed_grad"),
])
def test_profile_groups_each_kernel_under_its_port(name, group):
    """The step profile's groups (``bert_forward.kernel_group``) put each
    CUDA kernel of a ported function, f32 and bf16 alike, under its
    registry name."""
    from hetu_tpu_torch.examples import bert_forward
    assert bert_forward.kernel_group(name) == group


# -- training -----------------------------------------------------------------
TRAIN_LR = 1e-3
PARAMS = dict(rtol=0, atol=5e-5)
M_TOL = dict(rtol=0, atol=1e-6)
V_TOL = dict(rtol=0, atol=1e-9)


def _copy_jax(tree):
    """A fresh copy for a JAX step, which donates its params and state."""
    return jax.tree.map(jnp.array, tree)


def _carry(jparams, like):
    """The JAX params and a fresh AdamW state, carried to the port."""
    jopt = jb.init_opt_state(jparams)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", like=like)
    topt = tree_from_numpy(jax.tree.map(np.asarray, jopt), "cpu",
                           like=tt.init_opt_state(like))
    return jopt, tp, topt


def _assert_tree_close(got, want, tol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=path, **tol)


def _assert_state_close(tp, topt, jp, jopt):
    _assert_tree_close(tp, jp, PARAMS, "params")
    _assert_tree_close(topt["m"], jopt["m"], M_TOL, "m")
    _assert_tree_close(topt["v"], jopt["v"], V_TOL, "v")
    assert topt["t"].shape == () and float(topt["t"]) == float(jopt["t"])


def test_opt_state_carries_across(bert_pair):
    """tree_from_numpy carries an AdamW state {m, v, t}: two params-shaped
    trees and a 0-d f32 step count."""
    _, jp, tp = bert_pair
    jopt = jax.tree.map(lambda x: x + 0.5, jb.init_opt_state(jp))
    topt = tree_from_numpy(jax.tree.map(np.asarray, jopt), "cpu",
                           like=tb.init_opt_state(tp))
    assert topt["t"].shape == () and topt["t"].dtype == torch.float32
    assert float(topt["t"]) == 0.5
    _assert_tree_close(topt, jopt, dict(rtol=0, atol=0))


def test_pretrain_step_matches_jax(bert_pair, batch):
    """Three steps of make_pretrain_step through the flash and fused-CE
    backward, in the pre-LN and hf() dialects."""
    hf, jp, tp0 = bert_pair
    jc, tc = _configs(hf, attn_impl="flash", fused_mlm_ce=True)
    jopt, tp, topt = _carry(jp, tp0)
    jp = _copy_jax(jp)
    jstep = jb.make_pretrain_step(jc, lr=TRAIN_LR)
    tstep = tb.make_pretrain_step(tc, lr=TRAIN_LR)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jl, (jm, jn), jp, jopt = jstep(jp, jopt, jbatch)
        tl, (tm, tn), tp, topt = tstep(tp, topt, _tb(batch))
        np.testing.assert_allclose([float(tl), float(tm), float(tn)],
                                   [float(jl), float(jm), float(jn)], **LOSS)
    _assert_state_close(tp, topt, jp, jopt)


def test_finetune_step_matches_jax(bert_pair, batch):
    hf, jp, tp = bert_pair
    jc, tc = _configs(hf, attn_impl="flash")
    jcp = jb.init_classifier_params(jax.random.PRNGKey(1), jc, 3,
                                    pretrained=jp)
    jopt, tcp, topt = _carry(
        jcp, tb.init_classifier_params(1, tc, 3, pretrained=tp))
    jstep = jb.make_finetune_step(jc, lr=TRAIN_LR)
    tstep = tb.make_finetune_step(tc, lr=TRAIN_LR)
    keys = ("input_ids", "segment_ids", "input_mask")
    fb = dict({k: batch[k] for k in keys},
              label=np.array([0, 2, 1, 2], np.int32))
    jfb = {k: jnp.asarray(v) for k, v in fb.items()}
    for _ in range(3):
        jl, ja, jcp, jopt = jstep(jcp, jopt, jfb)
        tl, ta, tcp, topt = tstep(tcp, topt, _tb(fb))
        np.testing.assert_allclose(float(tl), float(jl), **LOSS)
        assert float(ta) == float(ja)
    _assert_state_close(tcp, topt, jcp, jopt)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("tied", [False, True], ids=["dv_head", "vd_tied"])
def test_lm_train_step_matches_jax(tied, accum):
    """transformer.make_train_step with the fused LM loss in both head
    layouts, with and without gradient accumulation."""
    kw = dict(LM, tied_head=tied, fused_lm_ce=True, attn_impl="flash")
    jc = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tc = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jt.init_params(jax.random.PRNGKey(4), jc)
    jopt, tp, topt = _carry(jp, tt.init_params(0, tc, "cpu"))
    rng = np.random.RandomState(5)
    shape = (accum, 2, T) if accum > 1 else (2, T)
    tokens = rng.randint(0, 101, shape).astype(np.int32)
    targets = rng.randint(0, 101, shape).astype(np.int32)
    jstep = jt.make_train_step(jc, lr=TRAIN_LR, accum_steps=accum)
    tstep = tt.make_train_step(tc, lr=TRAIN_LR, accum_steps=accum)
    for _ in range(3):
        jl, jp, jopt = jstep(jp, jopt, jnp.asarray(tokens),
                             jnp.asarray(targets))
        tl, tp, topt = tstep(tp, topt, torch.from_numpy(tokens),
                             torch.from_numpy(targets))
        np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _assert_state_close(tp, topt, jp, jopt)


EMBED_REL = 1e-5


def test_embedding_gradients_with_long_runs_match_jax_grad(bert_pair):
    """The first step's gradients of ``embed`` and ``type_emb`` through the
    port's ``lookup`` (the segment sum's plain version, two dispatches: the
    token and the type embedding) against ``jax.grad`` of the JAX package's
    pretraining loss from the same params, on a batch whose padding (id 0)
    and type ids give runs longer than a chunk: rel L2 at most EMBED_REL
    each (f32 through two layers; the JAX side's scatter-add and the MLM
    head's tied dW sum in another order)."""
    hf, jp, tp = bert_pair
    jc, tc = _configs(hf, attn_impl="flash", fused_mlm_ce=True)
    rng = np.random.RandomState(8)
    ids = rng.randint(1, 97, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for b, length in enumerate((T, 9, 4, 20)):
        ids[b, length:] = 0
        mask[b, length:] = 0
    lb = dict(input_ids=ids, input_mask=mask,
              segment_ids=(np.arange(T)[None, :] >= 6).astype(np.int32)
              .repeat(B, 0),
              mlm_positions=rng.randint(1, 4, (B, P)).astype(np.int32),
              mlm_ids=rng.randint(0, 97, (B, P)).astype(np.int32),
              mlm_weights=np.ones((B, P), np.float32),
              nsp_label=rng.randint(0, 2, (B,)).astype(np.int32))
    chunk = teg.chunk_rows(B * T, SMALL["d_model"])
    for key in ("input_ids", "segment_ids"):
        assert np.bincount(lb[key].ravel()).max() > 3 * chunk
    jbatch = {k: jnp.asarray(v) for k, v in lb.items()}
    want = jax.grad(lambda p: jb.pretrain_loss(p, jbatch, jc)[0])(jp)
    registry.reset_stats()
    _, got = tt.value_and_grad(tb.pretrain_loss, tp, _tb(lb), tc,
                               has_aux=True)
    assert registry.dispatch_stats()[("fused_embed_grad", "plain")] == 2
    for name in ("embed", "type_emb"):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert np.linalg.norm(g - w) <= EMBED_REL * np.linalg.norm(w), name


def test_remat_gives_the_same_gradients(batch):
    """cfg.remat recomputes each block in the backward: the same loss and
    gradients as keeping the activations, and the recompute runs the
    forward kernels again (2 layers: 4 flash forwards, 2 backwards)."""
    out = {}
    for remat in (False, True):
        cfg = tb.BertConfig(dtype=torch.float32, attn_impl="flash",
                            fused_mlm_ce=True, **dict(SMALL, remat=remat))
        registry.reset_stats()
        out[remat] = tt.value_and_grad(tb.pretrain_loss,
                                       tb.init_params(0, cfg, "cpu"),
                                       _tb(batch), cfg, has_aux=True)
        stats = registry.dispatch_stats()
        assert stats[("flash_attention_fwd", "plain")] == (4 if remat else 2)
        assert stats[("flash_attention_bwd", "plain")] == 2
    (loss, _), grads = out[True]
    (want_loss, _), want = out[False]
    assert float(loss) == float(want_loss)
    for g, w in zip(tt.tree_leaves(grads), tt.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_train_step_updates_in_place_under_the_callers_mode(batch):
    """The step returns the params and state it was given, updated in
    place; a step under kernels='off' dispatches every kernel call,
    backward and remat recompute included, to the plain versions."""
    cfg = tb.BertConfig(dtype=torch.float32, attn_impl="flash",
                        fused_mlm_ce=True, **dict(SMALL, remat=True))
    params = tb.init_params(0, cfg, "cpu")
    opt = tb.init_opt_state(params)
    embed = params["embed"]
    before = embed.clone()
    step = tb.make_pretrain_step(cfg)
    registry.reset_stats()
    with registry.active("off"):
        loss, _, new_params, new_opt = step(params, opt, _tb(batch))
    assert new_params is params and new_opt["m"] is opt["m"]
    assert new_params["embed"] is embed and not torch.equal(embed, before)
    assert float(new_opt["t"]) == 1.0 and torch.isfinite(loss)
    assert registry.dispatch_stats() == {
        ("flash_attention_fwd", "off"): 4, ("flash_attention_bwd", "off"): 2,
        ("fused_linear_nll_fwd", "off"): 1,
        ("fused_linear_nll_bwd", "off"): 1, ("fused_embed_grad", "off"): 2}


def test_bert_pretrain_example_runs_on_the_cpu():
    from hetu_tpu_torch.examples import bert_pretrain
    cfg = tb.BertConfig(dtype=torch.float32, attn_impl="flash",
                        fused_mlm_ce=True, **dict(SMALL, vocab_size=1100))
    res = list(bert_pretrain.run("cpu", steps=4, batch_size=4, seq_len=32,
                                 n_pred=5, lr=1e-3, cfg=cfg))
    steps, summary = res[:-1], res[-1]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert steps[-1]["loss"] < steps[0]["loss"]
    assert all(r["launches"] == {} for r in steps)
    assert summary["summary"] == "bert_pretrain" and summary["steps"] == 4
    assert summary["launches_same_every_step"] and summary["step_ms"] > 0
