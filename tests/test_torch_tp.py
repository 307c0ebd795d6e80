"""hetu_tpu_torch's transformer family on meshes that split a layer's
tensors (tp, sp) against the JAX package's, on the CPU.

Eight worker processes (one group for the file, file-store rendezvous,
port-only imports) run the cases below; this test holds them against the
JAX package on its 8-device virtual mesh (the same axes over the same
devices), from the same parameters (the JAX package's, cut to each rank's
slice by ``transformer.shard_params``) and data, and against the port's
own one-process step. Ports of the reference's tests:

- ``tests/test_transformer.py:44`` the trunk at dp 2 x tp 2 x sp 2, 3
  steps (ring attention over sp); a Llama-dialect config with one kv head
  under tp 2 (the kv column shared by both tp ranks, its gradient summed
  over them); ZeRO-1 on that mesh (slots of each rank's tp slice, over dp);
- ``tests/test_bert.py:135`` and ``:184`` BERT's pretraining step at dp 2 x
  tp 2 and at sp 2 x tp 2 on a padded batch (the mask rides the ring as a
  rotating per-key bias);
- ``tests/test_hf_vit.py:125`` ViT's forward at dp 2 x tp 2, and its step;
- ``tests/test_hf_llama.py:140``, ``tests/test_hf_gpt2.py:66`` the forwards
  of HF-imported Llama (GQA) and GPT-2 (tied head) at dp 2 x tp 2;
- ``tests/test_generate.py:216``, ``:238`` greedy decoding at dp 2 x tp 2:
  the tokens of one process, and with one kv head the cache's head axis
  replicated over tp;
- ``tests/test_transformer.py:360`` GPipe against 1F1B at dp 2 x pp 2 x
  tp 2: the first step's gradients against ``jax.grad`` of the JAX GPipe
  loss.

The four-rank cases run on ranks 0-3 and 4-7 side by side (each half a
mesh of its own). Tolerances: losses and logits rtol 1e-5 / atol 1e-6;
first-step gradients rtol 1e-5 and atol 1e-6 times the tensor's largest
magnitude; parameters after one AdamW step by ``_hold_adam``'s rule.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hetu_tpu.models import bert as jbert
from hetu_tpu.models import generate as jgen
from hetu_tpu.models import transformer as jtfm
from hetu_tpu.models import vit as jvit
from hetu_tpu.parallel import mesh as jmesh
from hetu_tpu.parallel import pipeline as jpl
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import generate as tg
from hetu_tpu_torch.models import transformer as tt
from test_torch_mesh import _flat, _hold_adam, _rand_batch
from test_torch_ring import start_ranks, wait_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LR, STEPS = 1e-2, 3
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=32, remat=False)
LLAMA = dict(LM, n_kv_heads=1, norm="rmsnorm", rope=True, mlp="swiglu",
             use_pos_emb=False)
BERT = dict(vocab_size=96, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq_len=32, remat=False)
VIT = dict(image_size=16, patch_size=4, n_classes=3, d_model=32, n_heads=4,
           n_layers=2, d_ff=64)
DECODE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq_len=16, remat=False)
PIPE_M, PIPE_MB = 3, 4

WORKER = r'''
import json
import sys

import numpy as np
import torch

from hetu_tpu_torch import interop
from hetu_tpu_torch.models import bert, generate, transformer as tfm, vit
from hetu_tpu_torch.parallel import mesh as meshlib, multihost
from hetu_tpu_torch.parallel import pipeline as pl

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 8, rank, device="cpu")
data = np.load(spec["data"])
out = {}


def tree(prefix):
    t = {}
    for k in data.files:
        if k.startswith(prefix + "/"):
            *path, leaf = k[len(prefix) + 1:].split("/")
            node = t
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[k]
    return t


def put(prefix, value):
    if isinstance(value, dict):
        for k, v in value.items():
            put(f"{prefix}/{k}", v)
    else:
        out[prefix] = value.detach().numpy().copy() if torch.is_tensor(
            value) else np.asarray(value)


def arr(name, dtype=torch.int64):
    return torch.from_numpy(data[name]).to(dtype)


def lm_cfg(name):
    return tfm.TransformerConfig(**spec["cfg"][name], dtype=torch.float32)


# -- the trunk at dp 2 x tp 2 x sp 2 (all eight ranks) ----------------------
mesh = meshlib.make_mesh(dp=2, tp=2, sp=2)
for name in ("lm", "gqa"):
    cfg = lm_cfg(name)
    tok, tgt = arr(name + "/tokens"), arr(name + "/targets")
    p = interop.mesh_tree(tree(name + "/params"), cfg, mesh, "cpu")
    dp = tfm.DataParallel(mesh)
    loss, g = tfm.value_and_grad(tfm.loss_fn, p, dp.seq_share(dp.share(tok)),
                                 dp.seq_share(dp.share(tgt)), cfg, mesh)
    tfm.sum_shared_kv_(g, cfg, mesh)
    dp.mean_([loss] + tfm.tree_leaves(g))
    put(name + "/grads", interop.mesh_to_numpy(g, cfg, mesh))
    out[name + "/grad_loss"] = loss.numpy()
    step, o, losses = tfm.make_train_step(cfg, mesh, lr=spec["lr"]), \
        tfm.init_opt_state(p), []
    for _ in range(spec["steps"]):
        loss, p, o = step(p, o, tok, tgt)
        losses.append(float(loss))
    out[name + "/losses"] = np.asarray(losses)
    if name == "lm":
        # each rank holds its heads' columns: q, k and v of its own heads
        out["lm/wqkv_shape"] = np.asarray(p["blocks"]["wqkv"].shape)
    else:
        _, nq, lo, hi = tfm.head_layout(cfg, 2, meshlib.axis_rank(mesh, "tp"))
        out["gqa/kv_heads_held"] = np.asarray([lo, hi])
# ZeRO-1 on the tp mesh against the replicated step
cfg = lm_cfg("lm")
tok, tgt = arr("lm/tokens"), arr("lm/targets")
res = {}
for z in (False, True):
    p = tfm.shard_params(interop.tree_from_numpy(tree("lm/params"), "cpu"),
                         cfg, mesh)
    o = tfm.shard_opt_state(tfm.init_opt_state(p), cfg, mesh, zero1=z)
    loss, p, o = tfm.make_train_step(cfg, mesh, lr=spec["lr"], zero1=z)(
        p, o, tok, tgt)
    res[z] = (float(loss), p, o)
out["z1/loss"], out["z1/rep_loss"] = np.asarray(res[True][0]), np.asarray(
    res[False][0])
put("z1/params", tfm.gather_params(res[True][1], cfg, mesh))
out["z1/param_diff"] = np.asarray(max(
    float((a - b).abs().max()) for a, b in zip(
        tfm.tree_leaves(res[True][1]), tfm.tree_leaves(res[False][1]))))
out["z1/m_embed_shape"] = np.asarray(res[True][2]["m"]["embed"].shape)

# -- four-rank meshes: ranks 0-3 and 4-7 side by side ------------------------
lo_half = meshlib.make_mesh(dp=2, tp=2, devices=range(4))
hi_half = meshlib.make_mesh(sp=2, tp=2, devices=range(4, 8))
decode_mesh = meshlib.make_mesh(dp=2, tp=2, devices=range(4, 8))
bcfg = bert.BertConfig(**spec["bert"], dtype=torch.float32)
batch = {k[len("bert/batch/"):]: torch.from_numpy(data[k])
         for k in data.files if k.startswith("bert/batch/")}
half = lo_half if rank < 4 else hi_half
tag = "dp2tp2" if rank < 4 else "sp2tp2"
p = bert.shard_params(interop.tree_from_numpy(tree("bert/params"), "cpu"),
                      bcfg, half)
loss, (mlm, nsp), p, _ = bert.make_pretrain_step(bcfg, half, lr=1e-3)(
    p, bert.init_opt_state(p), batch)
out[f"bert/{tag}/loss"] = np.asarray([float(loss), float(mlm), float(nsp)])
put(f"bert/{tag}/params", bert.gather_params(p, bcfg, half))
if rank < 4:
    vcfg = vit.ViTConfig(**spec["vit"], dtype=torch.float32)
    images, labels = arr("vit/images", torch.float32), arr("vit/labels")
    p = vit.shard_params(interop.tree_from_numpy(tree("vit/params"), "cpu"),
                         vcfg, lo_half)
    dp = tfm.DataParallel(lo_half)
    with torch.no_grad():
        out["vit/logits"] = vit.classify_logits(p, dp.share(images), vcfg,
                                                lo_half).numpy()
    loss, acc, p, _ = vit.make_train_step(vcfg, lr=1e-3, mesh=lo_half)(
        p, vit.init_opt_state(p), images, labels)
    out["vit/loss"] = np.asarray([float(loss), float(acc)])
    put("vit/params", vit.gather_params(p, vcfg, lo_half))
    for name in ("llama", "gpt2"):
        if name + "/tokens" not in data.files:
            continue
        cfg = tfm.TransformerConfig(**spec["hf"][name], dtype=torch.float32)
        p = tfm.shard_params(interop.tree_from_numpy(
            tree(name + "/params"), "cpu"), cfg, lo_half)
        with torch.no_grad():
            logits, _ = tfm.forward(p, dp.share(arr(name + "/tokens")), cfg,
                                    lo_half)
        out[name + "/logits"] = logits.numpy()
else:
    for name in ("decode", "decode_mqa"):
        cfg = tfm.TransformerConfig(**spec["cfg"][name], dtype=torch.float32)
        p = tfm.shard_params(interop.tree_from_numpy(
            tree(name + "/params"), "cpu"), cfg, decode_mesh)
        toks, logits = generate.make_generate_fn(cfg, 12, mesh=decode_mesh)(
            p, arr(name + "/prompt"))
        out[name + "/tokens"] = toks.numpy()
        out[name + "/logits"] = logits.numpy()
        out[name + "/cache_heads"] = np.asarray(
            generate._Weights(p, cfg, decode_mesh).nkv)
        out[name + "/wqkv_cols"] = np.asarray(p["blocks"]["wqkv"].shape[-1])

# -- GPipe and 1F1B at dp 2 x pp 2 x tp 2 (all eight ranks) ---------------
mesh = meshlib.make_mesh(dp=2, pp=2, tp=2)
cfg = lm_cfg("pipe")
tok, tgt = arr("pipe/tokens"), arr("pipe/targets")
s = meshlib.axis_rank(mesh, "pp")
p = pl.stage_params(interop.stage_tree(tree("pipe/params"), s, "cpu"), cfg,
                    mesh)
for leg, make in (("gpipe", pl.make_pipeline_train_step),
                  ("1f1b", pl.make_pipeline_train_step_1f1b)):
    loss, g = make(cfg, mesh, spec["pipe_m"], lr=spec["lr"]).fwd_bwd(
        p, tok, tgt)
    out[f"pipe/{leg}/loss"] = loss.numpy()
    put(f"pipe/{leg}/grads", tfm.gather_params(g, cfg, mesh))
np.savez(sys.argv[4], **out)
multihost.shutdown()
'''


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(jcfg, **over):
    """The port's TransformerConfig with a JAX config's fields."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name != "dtype"}
    kw.update(over)
    return kw


def _hf_pairs():
    """Small HF Llama (GQA, 2 kv heads) and GPT-2 (tied head) models
    imported by the JAX package: ``{name: (cfg fields, params, ids)}``, or
    {} without ``transformers``."""
    try:
        import transformers
    except ImportError:
        return {}
    from hetu_tpu.models import hf_gpt2, hf_llama
    out = {}
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=112,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        tie_word_embeddings=False)).eval()
    torch.manual_seed(1)
    gpt2 = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=96, n_positions=32, n_embd=48, n_layer=2,
        n_head=4)).eval()
    rng = np.random.default_rng(9)
    for name, model, mod, T in (("llama", llama, hf_llama, 12),
                                ("gpt2", gpt2, hf_gpt2, 24)):
        params, cfg = mod.params_from_hf(model)
        cfg = dataclasses.replace(cfg, remat=False, attn_impl="dot",
                                  fused_lm_ce=False)
        out[name] = (cfg, _np(params),
                     rng.integers(0, cfg.vocab_size, (4, T)).astype(np.int32))
    return out


def _jax_grads(cfg, mesh, params, tokens, targets):
    sharded = jtfm.shard_params(jax.tree.map(jnp.asarray, params), cfg, mesh)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, x, y: jtfm.loss_fn(p, x, y, cfg, mesh)))(
            sharded, jnp.asarray(tokens), jnp.asarray(targets))
    return float(loss), _np(g)


def _jax_losses(cfg, mesh, params, tokens, targets, steps):
    p = jtfm.shard_params(jax.tree.map(jnp.asarray, params), cfg, mesh)
    o = jtfm.init_opt_state(p)
    step = jtfm.make_train_step(cfg, mesh=mesh, lr=LR)
    losses = []
    for _ in range(steps):
        loss, p, o = step(p, o, jnp.asarray(tokens), jnp.asarray(targets))
        losses.append(float(loss))
    return np.asarray(losses)


def _jax_refs(ins):
    """The JAX package's runs on its virtual mesh, computed while the
    ranks run."""
    refs = {}
    dev = jax.devices()
    mesh = jmesh.make_mesh(dp=2, tp=2, sp=2, devices=dev)
    for name in ("lm", "gqa"):
        cfg, params, tok, tgt = ins[name]
        refs[name + "/grads"] = _jax_grads(cfg, mesh, params, tok, tgt)
        refs[name + "/losses"] = _jax_losses(cfg, mesh, params, tok, tgt,
                                             STEPS)
    cfg, params, tok, tgt = ins["lm"]
    p = jtfm.shard_params(jax.tree.map(jnp.asarray, params), cfg, mesh)
    o = jtfm.shard_opt_state(jtfm.init_opt_state(p), cfg, mesh, zero1=True)
    loss, wp, _ = jtfm.make_train_step(cfg, mesh=mesh, lr=LR, zero1=True)(
        p, o, jnp.asarray(tok), jnp.asarray(tgt))
    refs["z1"] = (float(loss), _np(wp))
    bcfg, bparams, batch = ins["bert"]
    for tag, kw in (("dp2tp2", dict(dp=2, tp=2)), ("sp2tp2", dict(sp=2, tp=2))):
        m = jmesh.make_mesh(**kw, devices=dev[:4])
        p = jax.tree.map(jnp.asarray, bparams)
        loss, (mlm, nsp), wp, _ = jbert.make_pretrain_step(bcfg, mesh=m,
                                                           lr=1e-3)(
            p, jbert.init_opt_state(p), jax.tree.map(jnp.asarray, batch))
        refs["bert/" + tag] = ([float(loss), float(mlm), float(nsp)],
                               _np(wp))
    m = jmesh.make_mesh(dp=2, tp=2, devices=dev[:4])
    vcfg, vparams, images, labels = ins["vit"]
    p = jax.tree.map(jnp.asarray, vparams)
    refs["vit/logits"] = np.asarray(jax.jit(
        lambda p, x: jvit.classify_logits(p, x, vcfg, m))(
            p, jnp.asarray(images)))
    loss, acc, wp, _ = jvit.make_train_step(vcfg, lr=1e-3, mesh=m)(
        p, jvit.init_opt_state(p), jnp.asarray(images), jnp.asarray(labels))
    refs["vit/step"] = ([float(loss), float(acc)], _np(wp))
    for name, (cfg, params, ids) in ins["hf"].items():
        sharded = jtfm.shard_params(jax.tree.map(jnp.asarray, params), cfg,
                                    m)
        refs[name + "/logits"] = np.asarray(jax.jit(
            lambda p, t: jtfm.forward(p, t, cfg, m)[0])(
                sharded, jnp.asarray(ids)))
    for name in ("decode", "decode_mqa"):
        cfg, params, prompt = ins[name]
        refs[name + "/tokens"] = np.asarray(jgen.generate(
            jax.tree.map(jnp.asarray, params), cfg, prompt, max_len=12))
    cfg, params, tok, tgt = ins["pipe"]
    m = jmesh.make_mesh(dp=2, pp=2, tp=2, devices=dev)
    gstep = jpl.make_pipeline_train_step(cfg, m, num_microbatches=PIPE_M,
                                         lr=LR)
    refs["pipe/grads"] = _np(jax.jit(jax.grad(gstep.fwd_loss))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tok),
        jnp.asarray(tgt)))
    return refs


def _lm_data(seed, shape=(8, 16), vocab=64):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, shape).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=-1).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inputs, ins, cfgs = {}, {}, {}
    for i, (name, kw) in enumerate((("lm", LM), ("gqa", LLAMA))):
        cfg = jtfm.TransformerConfig(**kw, dtype=jnp.float32)
        params = _np(jtfm.init_params(jax.random.PRNGKey(2 + i), cfg))
        tok, tgt = _lm_data(9 + i)
        _flat(name + "/params", params, inputs)
        inputs[name + "/tokens"], inputs[name + "/targets"] = tok, tgt
        ins[name], cfgs[name] = (cfg, params, tok, tgt), kw
    bcfg = jbert.BertConfig(**BERT, dtype=jnp.float32)
    bparams = _np(jbert.init_params(jax.random.PRNGKey(0), bcfg))
    batch = _rand_batch(np.random.RandomState(3))
    _flat("bert/params", bparams, inputs)
    _flat("bert/batch", batch, inputs)
    ins["bert"] = (bcfg, bparams, batch)
    vcfg = jvit.ViTConfig(**VIT, dtype=jnp.float32)
    vparams = _np(jvit.init_params(jax.random.PRNGKey(5), vcfg))
    rng = np.random.RandomState(6)
    images = rng.randn(4, 3, 16, 16).astype(np.float32)
    labels = rng.randint(0, 3, 4).astype(np.int32)
    _flat("vit/params", vparams, inputs)
    inputs["vit/images"], inputs["vit/labels"] = images, labels
    ins["vit"] = (vcfg, vparams, images, labels)
    hf, hf_cfgs = _hf_pairs(), {}
    for name, (cfg, params, ids) in hf.items():
        _flat(name + "/params", params, inputs)
        inputs[name + "/tokens"] = ids
        hf_cfgs[name] = _port_cfg(cfg)
    ins["hf"] = hf
    for name, kv in (("decode", 0), ("decode_mqa", 1)):
        cfg = jtfm.TransformerConfig(**DECODE, n_kv_heads=kv,
                                     dtype=jnp.float32)
        params = _np(jtfm.init_params(jax.random.PRNGKey(7 + kv), cfg))
        prompt = np.random.RandomState(4 + kv).randint(0, 64, (4, 4)).astype(
            np.int32)
        _flat(name + "/params", params, inputs)
        inputs[name + "/prompt"] = prompt
        ins[name], cfgs[name] = (cfg, params, prompt), dict(DECODE,
                                                            n_kv_heads=kv)
    cfg = jtfm.TransformerConfig(**LM, dtype=jnp.float32)
    pmesh = jmesh.make_mesh(dp=2, pp=2, tp=2, devices=jax.devices())
    pparams = _np(jpl.init_pipeline_params(jax.random.PRNGKey(3), cfg,
                                           pmesh))
    tok, tgt = _lm_data(5, (PIPE_M, PIPE_MB, 16))
    _flat("pipe/params", pparams, inputs)
    inputs["pipe/tokens"], inputs["pipe/targets"] = tok, tgt
    ins["pipe"], cfgs["pipe"] = (cfg, pparams, tok, tgt), LM
    np.savez(tmp / "in.npz", **inputs)
    with open(tmp / "spec.json", "w") as f:
        json.dump(dict(data=str(tmp / "in.npz"), lr=LR, steps=STEPS,
                       cfg=cfgs, bert=BERT, vit=VIT, hf=hf_cfgs,
                       pipe_m=PIPE_M), f)
    procs, outs = start_ranks(tmp, WORKER, tmp / "spec.json", 8)
    try:
        refs = _jax_refs(ins)
    finally:
        got = wait_ranks(procs, outs)
    return got, ins, refs


def _grads_close(got, want, what):
    for k, v in _flat("", want, {}).items():
        scale = max(float(np.max(np.abs(v))), 1e-30)
        np.testing.assert_allclose(got[what + k], v, rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=what + k)


def _one_process(name, ins):
    """The port's one-process step from the same params: the first step's
    loss and gradients, and the losses of STEPS steps."""
    cfg, params, tok, tgt = ins[name]
    tcfg = tt.TransformerConfig(**_port_cfg(cfg), dtype=torch.float32)
    p = tree_from_numpy(params, "cpu")
    x, y = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    loss, g = tt.value_and_grad(tt.loss_fn, p, x, y, tcfg)
    step, o, losses = tt.make_train_step(tcfg, lr=LR), tt.init_opt_state(p), []
    for _ in range(STEPS):
        l, p, o = step(p, o, x, y)
        losses.append(float(l))
    return float(loss), _np(tt.tree_map(lambda t: t.numpy(), g)), losses


@pytest.mark.parametrize("name", ["lm", "gqa"])
def test_trunk_on_dp_tp_sp_matches_jax_and_one_process(ranks, name):
    """tests/test_transformer.py:44 at dp 2 x tp 2 x sp 2; ``gqa``: one kv
    head under tp 2, its column held by both tp ranks."""
    outs, ins, refs = ranks
    jloss, jgrads = refs[name + "/grads"]
    loss1, grads1, losses1 = _one_process(name, ins)
    for out in outs:
        np.testing.assert_allclose(out[name + "/grad_loss"], jloss,
                                   **LOSS_TOL)
        _grads_close(out, jgrads, name + "/grads")
        _grads_close(out, grads1, name + "/grads")
        np.testing.assert_allclose(out[name + "/losses"],
                                   refs[name + "/losses"], **LOSS_TOL)
        np.testing.assert_allclose(out[name + "/losses"], losses1,
                                   **LOSS_TOL)
    cfg = ins[name][0]
    if name == "lm":
        # each rank's q, k and v columns of its two heads
        assert tuple(outs[0]["lm/wqkv_shape"]) == (
            cfg.n_layers, cfg.d_model, 3 * cfg.d_model // 2)
    else:
        assert all(tuple(o["gqa/kv_heads_held"]) == (0, 1) for o in outs)


def test_zero1_on_a_tp_mesh_matches_replicated_and_jax(ranks):
    outs, ins, refs = ranks
    jloss, jparams = refs["z1"]
    V, D = LM["vocab_size"], LM["d_model"]
    for out in outs:
        np.testing.assert_allclose(out["z1/loss"], jloss, **LOSS_TOL)
        np.testing.assert_allclose(out["z1/loss"], out["z1/rep_loss"],
                                   rtol=0, atol=1e-6)
        assert float(out["z1/param_diff"]) <= 1e-6
        # the embedding's slot: its tp slice (D/2 columns), over dp (V/2)
        assert tuple(out["z1/m_embed_shape"]) == (V // 2, D // 2)
        for k, v in _flat("", jparams, {}).items():
            _hold_adam(out["z1/params" + k], v, LR, k)


@pytest.mark.parametrize("tag", ["dp2tp2", "sp2tp2"])
def test_bert_step_on_tp_and_sp_meshes_matches_jax(ranks, tag):
    """tests/test_bert.py:135 (dp 2 x tp 2) and :184 (sp 2 x tp 2, the
    padded batch through the ring)."""
    outs, ins, refs = ranks
    want, wparams = refs["bert/" + tag]
    for out in (outs[:4] if tag == "dp2tp2" else outs[4:]):
        np.testing.assert_allclose(out[f"bert/{tag}/loss"], want, **LOSS_TOL)
        for k, v in _flat("", wparams, {}).items():
            _hold_adam(out[f"bert/{tag}/params" + k], v, 1e-3, k)


def test_vit_mesh_forward_and_step_match_jax(ranks):
    """tests/test_hf_vit.py:125 at dp 2 x tp 2: each dp rank's logits, and
    the step's loss and params."""
    outs, ins, refs = ranks
    want_loss, wparams = refs["vit/step"]
    for r, out in enumerate(outs[:4]):
        d = r // 2
        np.testing.assert_allclose(out["vit/logits"],
                                   refs["vit/logits"][2 * d:2 * d + 2],
                                   **LOSS_TOL)
        np.testing.assert_allclose(out["vit/loss"], want_loss, **LOSS_TOL)
        for k, v in _flat("", wparams, {}).items():
            _hold_adam(out["vit/params" + k], v, 1e-3, k)


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_hf_mesh_forwards_match_jax(ranks, name):
    """tests/test_hf_llama.py:140 and tests/test_hf_gpt2.py:66 at dp 2 x
    tp 2: each dp rank's rows of the logits."""
    outs, ins, refs = ranks
    if name not in ins["hf"]:
        pytest.skip("transformers is not installed")
    want = refs[name + "/logits"]
    for r, out in enumerate(outs[:4]):
        d = r // 2
        np.testing.assert_allclose(out[name + "/logits"],
                                   want[2 * d:2 * d + 2], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["decode", "decode_mqa"])
def test_mesh_decoding_gives_one_process_tokens(ranks, name):
    """tests/test_generate.py:216, :238 at dp 2 x tp 2: the tokens equal
    one process's and the JAX package's; the weights stay split (each rank
    holds half of wqkv's query columns); with one kv head the cache holds
    it on both tp ranks."""
    outs, ins, refs = ranks
    cfg, params, prompt = ins[name]
    tcfg = tt.TransformerConfig(**_port_cfg(cfg), dtype=torch.float32)
    one, logits = tg.make_generate_fn(tcfg, 12)(tree_from_numpy(params, "cpu"),
                                                prompt)
    np.testing.assert_array_equal(one.numpy(), refs[name + "/tokens"])
    hd, nkv = cfg.head_dim, cfg.kv_heads
    for out in outs[4:]:
        np.testing.assert_array_equal(out[name + "/tokens"], one.numpy())
        np.testing.assert_allclose(out[name + "/logits"], logits.numpy(),
                                   **LOSS_TOL)
        held = 1 if nkv < 2 else nkv // 2
        assert int(out[name + "/cache_heads"]) == held
        assert int(out[name + "/wqkv_cols"]) == (cfg.n_heads // 2
                                                 + 2 * held) * hd


def test_gpipe_and_1f1b_grads_match_jax_on_a_tp_mesh(ranks):
    """tests/test_transformer.py:360 at dp 2 x pp 2 x tp 2: each schedule's
    first-step gradients (gathered over tp, stages stacked) against
    ``jax.grad`` of the JAX GPipe loss."""
    outs, ins, refs = ranks
    want = refs["pipe/grads"]
    pp_rank = {0: 0, 1: 2}              # (dp 0, tp 0) rank of each stage
    for leg in ("gpipe", "1f1b"):
        first = outs[0]
        got = {k: v for k, v in first.items()
               if k.startswith(f"pipe/{leg}/grads/")
               and "/blocks/" not in k}
        for n in {k.split("/")[-1] for k in first
                  if k.startswith(f"pipe/{leg}/grads/blocks/")}:
            got[f"pipe/{leg}/grads/blocks/{n}"] = np.stack([
                outs[pp_rank[s]][f"pipe/{leg}/grads/blocks/{n}"]
                for s in range(2)])
        _grads_close(got, want, f"pipe/{leg}/grads")
        np.testing.assert_allclose(outs[0][f"pipe/{leg}/loss"],
                                   outs[0]["pipe/gpipe/loss"], **LOSS_TOL)
