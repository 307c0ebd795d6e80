"""hetu_tpu_torch's five-axis mesh (``parallel/mesh.py``), its transport
(``parallel/multihost.py``), and the transformer and BERT steps on a dp
mesh with ZeRO-1, against the JAX package, on the CPU.

Four worker processes (one group for the file) join a gloo group through
a file store, import only the port and run the cases below; this test
holds them against the JAX package on the 8-device virtual mesh (the same
dp over ``jax.devices()[:4]``), from the same parameters and data:

- the mesh constructors: each rank's coordinates and axis groups are the
  positions of ``np.asarray(devices).reshape(dp, pp, ep, sp, tp)``, also
  on meshes with tp, sp and ep axes; point-to-point messages (bf16 too),
  the all-gather and the bucketed all-reduce over the axis groups;
- ``tests/test_transformer.py:112`` at dp 4 (tp 1): ZeRO-1 equals the
  replicated step (atol 1e-6) and the JAX package's ZeRO-1 step, each
  rank's slots hold a quarter of the embedding's rows; and the dp step's
  losses over 3 steps against the JAX dp step's;
- ``tests/test_bert.py:135`` at dp 4 only: the pretraining step on a dp
  mesh against the JAX package's, with and without the padding mask, and
  ZeRO-1 against replicated; ``:87``: the port's tokenizer and data
  pipeline into the dp step, the batch bit-equal to the JAX package's;
- the MoE's step on dp 4 (its routing over the global batch) against one
  process;
- the refusals that stay, naming slice 8c (``ht.dispatch``, the sharded
  restore, a ZeRO-1 or pipeline state through the one-process
  checkpoint), and an object that is no ``DeviceMesh``.

Tolerances: losses rtol 1e-5 / atol 1e-6; parameters after one AdamW step
by ``_hold_adam``'s rule (each element within 2 · lr, all but one in a
thousand within 1e-5), ZeRO-1 against replicated within the port atol
1e-6.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import hetu_tpu_torch as ht
from hetu_tpu.models import bert as jbert
from hetu_tpu.models import transformer as jtfm
from hetu_tpu.parallel import mesh as jmesh
from hetu_tpu_torch import checkpoint
from hetu_tpu_torch.models import generate as tg
from hetu_tpu_torch.models import transformer as tt
from hetu_tpu_torch.models import vit as tv
from hetu_tpu_torch.parallel import mesh as tmesh
from test_torch_quant_comm import run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-2
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
          max_seq_len=32, remat=False)
BERT = dict(vocab_size=96, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq_len=32, remat=False)
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "fast", "##s", "a"]
SENTENCES = ["the cat sat on a mat", "a dog ran fast", "the dog sat",
             "a cat ran", "the mat ran fast", "the cats sat", "a dog sat on",
             "the dogs ran", "a mat sat", "the cat ran fast",
             "a dog on the mat", "the cat sat fast"]

WORKER = r'''
import json
import sys

import numpy as np
import torch

from hetu_tpu_torch import interop
from hetu_tpu_torch.examples import processBertData as pbd
from hetu_tpu_torch.models import bert, transformer as tfm
from hetu_tpu_torch.parallel import mesh as meshlib, multihost
from hetu_tpu_torch.tokenizers import BertTokenizer

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 4, rank, device="cpu")
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
    return interop.tree_from_numpy(t, "cpu")


def put(prefix, value):
    if isinstance(value, dict):
        for k, v in value.items():
            put(f"{prefix}/{k}", v)
    else:
        out[prefix] = value.detach().numpy().copy()


# -- the mesh constructors, their groups and the transport ------------------
for name, kw in (("dp2pp2", dict(dp=2, pp=2)), ("dp4", dict(dp=4)),
                 ("auto_pp2", None), ("dp2tp2", dict(dp=2, tp=2)),
                 ("sp2ep2", dict(sp=2, ep=2))):
    mesh = (meshlib.auto_mesh(pp=2) if kw is None
            else meshlib.make_mesh(**kw))
    for a in meshlib.AXES:
        out[f"axes/{name}/{a}/size"] = np.asarray(meshlib.axis_size(mesh, a))
        out[f"axes/{name}/{a}/rank"] = np.asarray(meshlib.axis_rank(mesh, a))
        out[f"axes/{name}/{a}/ranks"] = np.asarray(meshlib.axis_ranks(mesh, a))
mesh = meshlib.make_mesh(dp=2, pp=2)
pp_group, dp_group = meshlib.axis_group(mesh, "pp"), meshlib.axis_group(mesh, "dp")
peer = meshlib.axis_ranks(mesh, "pp")[1 - meshlib.axis_rank(mesh, "pp")]
for dtype in (torch.float32, torch.bfloat16):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(dtype) + rank
    sent = multihost.send(x, peer, pp_group)
    got = multihost.recv((2, 3), dtype, peer, pp_group)
    sent.wait()
    sent.wait()          # a second wait returns
    out[f"p2p/{dtype}"] = got.float().numpy()
out["gather"] = torch.stack(multihost.all_gather(
    torch.full((3,), float(rank)), dp_group)).numpy()
t = [torch.full((2,), float(rank)), torch.full((1, 3), 2.0 * rank)]
multihost.all_reduce_(t, dp_group, mean=True)
out["mean/0"], out["mean/1"] = t[0].numpy(), t[1].numpy()
# the MoE on dp 4: each token routed over the global batch
moe = tfm.TransformerConfig(**dict(spec["lm"], n_experts=2),
                            dtype=torch.float32)
p = tfm.init_params(0, moe, "cpu")
out["moe_dp/loss"] = np.asarray(float(tfm.make_train_step(
    moe, meshlib.make_mesh(dp=4))(
        p, tfm.init_opt_state(p), torch.from_numpy(data["lm/tokens"]).long(),
        torch.from_numpy(data["lm/targets"]).long())[0]))

# -- the trunk on dp 4: 3 steps; ZeRO-1 against replicated, 1 step -------
cfg = tfm.TransformerConfig(**spec["lm"], dtype=torch.float32)
mesh = meshlib.make_mesh(dp=4)
tok = torch.from_numpy(data["lm/tokens"]).long()
tgt = torch.from_numpy(data["lm/targets"]).long()
p, step = tree("lm/params"), tfm.make_train_step(cfg, mesh, lr=spec["lr"])
o, losses = tfm.init_opt_state(p), []
for _ in range(3):
    loss, p, o = step(p, o, tok, tgt)
    losses.append(float(loss))
out["lm/losses"] = np.asarray(losses)
res = {}
for z in (False, True):
    p = tree("lm/params")
    o = tfm.shard_opt_state(tfm.init_opt_state(p), cfg, mesh, zero1=z)
    step = tfm.make_train_step(cfg, mesh, lr=spec["lr"], zero1=z)
    loss, p, o = step(p, o, tok, tgt)
    res[z] = (float(loss), p, o)
out["lm/z1_loss"] = np.asarray(res[True][0])
out["lm/rep_loss"] = np.asarray(res[False][0])
put("lm/z1_params", res[True][1])
out["lm/z1_param_diff"] = np.asarray(max(
    float((a - b).abs().max()) for a, b in zip(
        tfm.tree_leaves(res[True][1]), tfm.tree_leaves(res[False][1]))))
specs, diff = tfm.zero1_opt_specs(cfg, mesh), 0.0
for sm, fm, sp in zip(tfm.tree_leaves(res[True][2]["m"]),
                      tfm.tree_leaves(res[False][2]["m"]),
                      tfm.tree_leaves(tfm.tree_map(
                          lambda _, x: x, res[True][2]["m"], specs))):
    if "dp" in sp:
        ax = sp.index("dp")
        k = fm.shape[ax] // 4
        fm = fm.narrow(ax, rank * k, k)
    diff = max(diff, float((sm - fm).abs().max()))
out["lm/z1_m_diff"] = np.asarray(diff)
out["lm/z1_m_embed_rows"] = np.asarray(res[True][2]["m"]["embed"].shape[0])
out["lm/z1_loss2"] = np.asarray(float(step(*res[True][1:], tok, tgt)[0]))

# -- BERT on dp 4 (tests/test_bert.py:135, :87) -------------------------
bcfg = bert.BertConfig(**spec["bert"], dtype=torch.float32)
batch = {k[len("bert/batch/"):]: torch.from_numpy(data[k])
         for k in data.files if k.startswith("bert/batch/")}
for z in (False, True):
    p = tree("bert/params")
    o = bert.shard_opt_state(bert.init_opt_state(p), bcfg, mesh, zero1=z)
    step = bert.make_pretrain_step(bcfg, mesh, lr=1e-3, zero1=z)
    loss, (mlm, nsp), p, _ = step(p, o, batch)
    tag = "z1" if z else "rep"
    out[f"bert/{tag}/loss"] = np.asarray([float(loss), float(mlm),
                                          float(nsp)])
    put(f"bert/{tag}/params", p)
p = tree("bert/params")
dense = {k: v for k, v in batch.items() if k != "input_mask"}
out["bert/dense_loss"] = np.asarray(float(bert.make_pretrain_step(
    bcfg, mesh, lr=1e-3)(p, bert.init_opt_state(p), dense)[0]))
vocab = {t: i for i, t in enumerate(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + spec["words"])}
inst = list(pbd.create_instances_from_document(
    spec["sentences"], BertTokenizer(vocab), max_seq_length=24,
    max_predictions_per_seq=4))
pcfg = bert.BertConfig(vocab_size=len(vocab), d_model=16, n_heads=2,
                       n_layers=2, d_ff=32, max_seq_len=24,
                       dtype=torch.float32, remat=False)
pbatch = bert.batch_from_instances(inst[:4 * (len(inst) // 4)], "cpu")
put("pipe/batch", pbatch)
p = tree("pipe/params")
loss, (mlm, nsp), _, _ = bert.make_pretrain_step(pcfg, mesh, lr=1e-3)(
    p, bert.init_opt_state(p), pbatch)
out["pipe/loss"] = np.asarray([float(loss), float(mlm), float(nsp)])
# the classifier's fine-tuning step on dp 4 (reference bert.py:277)
p = tree("cls/params")
cbatch = {k: batch[k] for k in ("input_ids", "segment_ids", "input_mask")}
cbatch["label"] = torch.from_numpy(data["cls/label"])
loss, acc, p, _ = bert.make_finetune_step(bcfg, lr=1e-3, mesh=mesh)(
    p, bert.init_opt_state(p), cbatch)
out["cls/loss"] = np.asarray([float(loss), float(acc)])
put("cls/params", p)
np.savez(sys.argv[4], **out)
multihost.shutdown()
'''


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _rand_batch(rng, B=8, T=16, P=4):
    """tests/test_bert.py:_rand_batch with a padding mask at 12."""
    ids = rng.randint(3, BERT["vocab_size"], (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[:, 12:] = 0
    pos = np.stack([rng.choice(np.arange(1, 12), P, replace=False)
                    for _ in range(B)]).astype(np.int32)
    return {"input_ids": ids, "input_mask": mask,
            "segment_ids": (np.arange(T)[None, :] >= T // 2)
            .astype(np.int32).repeat(B, 0),
            "mlm_positions": pos,
            "mlm_ids": rng.randint(3, BERT["vocab_size"], (B, P)).astype(
                np.int32),
            "mlm_weights": np.ones((B, P), np.float32),
            "nsp_label": rng.randint(0, 2, (B,)).astype(np.int32)}


def _jax_pipeline_batch():
    """tests/test_bert.py:87's data pipeline in the JAX package."""
    import importlib.util
    from hetu_tpu.tokenizers import BertTokenizer
    path = os.path.join(REPO, "examples", "nlp", "processBertData.py")
    spec = importlib.util.spec_from_file_location("_jax_pbd", path)
    pbd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pbd)
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)}
    inst = list(pbd.create_instances_from_document(
        SENTENCES, BertTokenizer(vocab), max_seq_length=24,
        max_predictions_per_seq=4))
    cfg = jbert.BertConfig(vocab_size=len(vocab), d_model=16, n_heads=2,
                           n_layers=2, d_ff=32, max_seq_len=24,
                           dtype=jnp.float32, remat=False)
    return cfg, jbert.batch_from_instances(inst[:4 * (len(inst) // 4)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = {}
    lm_cfg = jtfm.TransformerConfig(**LM, dtype=jnp.float32)
    lm_params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(2), lm_cfg))
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, LM["vocab_size"], (8, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1).astype(np.int32)
    _flat("lm/params", lm_params, inputs)
    inputs["lm/tokens"], inputs["lm/targets"] = tokens, targets
    bcfg = jbert.BertConfig(**BERT, dtype=jnp.float32)
    bparams = jax.tree.map(np.asarray, jbert.init_params(
        jax.random.PRNGKey(0), bcfg))
    batch = _rand_batch(np.random.RandomState(3))
    _flat("bert/params", bparams, inputs)
    _flat("bert/batch", batch, inputs)
    cparams = jax.tree.map(np.asarray, jbert.init_classifier_params(
        jax.random.PRNGKey(5), bcfg, 3))
    _flat("cls/params", cparams, inputs)
    inputs["cls/label"] = np.random.RandomState(6).randint(0, 3, 8).astype(
        np.int32)
    pcfg, pbatch = _jax_pipeline_batch()
    pparams = jax.tree.map(np.asarray, jbert.init_params(
        jax.random.PRNGKey(0), pcfg))
    _flat("pipe/params", pparams, inputs)
    np.savez(tmp / "in.npz", **inputs)
    with open(tmp / "spec.json", "w") as f:
        json.dump(dict(data=str(tmp / "in.npz"), lr=LR, lm=LM, bert=BERT,
                       words=WORDS, sentences=SENTENCES), f)
    outs = [dict(np.load(o)) for o in run_ranks(tmp, WORKER,
                                                 tmp / "spec.json", n=4)]
    ins = dict(lm=(lm_cfg, lm_params, tokens, targets),
               bert=(bcfg, bparams, batch), pipe=(pcfg, pparams, pbatch),
               cls=(cparams, inputs["cls/label"]))
    return outs, ins


def _hold_adam(got, want, lr, what):
    err = np.abs(got - want)
    assert err.max() <= 2 * lr + 1e-6, (what, err.max())
    assert np.mean(err > 1e-5) <= 1e-3, (what, err.max())


def test_mesh_axes_match_the_jax_device_grid(ranks):
    outs, _ = ranks
    for name, kw in (("dp2pp2", dict(dp=2, pp=2)), ("dp4", dict(dp=4)),
                     ("auto_pp2", dict(dp=2, pp=2)),
                     ("dp2tp2", dict(dp=2, tp=2)),
                     ("sp2ep2", dict(sp=2, ep=2))):
        jm = jmesh.make_mesh(**kw, devices=jax.devices()[:4])
        ids = np.vectorize(lambda d: d.id)(jm.devices)   # (dp, pp, 1, 1, 1)
        for r, out in enumerate(outs):
            coord = [int(c[0]) for c in np.nonzero(ids == r)]
            for i, a in enumerate(tmesh.AXES):
                assert int(out[f"axes/{name}/{a}/size"]) == jm.shape[a]
                assert int(out[f"axes/{name}/{a}/rank"]) == coord[i], (name, a)
                line = np.moveaxis(ids, i, -1)[tuple(
                    c for j, c in enumerate(coord) if j != i)]
                np.testing.assert_array_equal(out[f"axes/{name}/{a}/ranks"],
                                              line)


def test_transport_over_axis_groups(ranks):
    outs, _ = ranks
    for r, out in enumerate(outs):
        d, s = divmod(r, 2)                  # dp 2 x pp 2
        peer = d * 2 + (1 - s)
        want = np.arange(6, dtype=np.float32).reshape(2, 3) + peer
        np.testing.assert_array_equal(out["p2p/torch.float32"], want)
        np.testing.assert_array_equal(out["p2p/torch.bfloat16"], want)
        col = [s, 2 + s]                     # the dp group's ranks
        np.testing.assert_array_equal(out["gather"],
                                      np.repeat(np.asarray(col, np.float32)
                                                [:, None], 3, 1))
        np.testing.assert_allclose(out["mean/0"], np.mean(col))
        np.testing.assert_allclose(out["mean/1"], 2.0 * np.mean(col))


def test_moe_step_on_dp_matches_one_process(ranks):
    """The MoE on four dp ranks routes over the global batch: its loss is
    one process's on the whole batch."""
    outs, ins = ranks
    _, _, tokens, targets = ins["lm"]
    moe = tt.TransformerConfig(**dict(LM, n_experts=2), dtype=torch.float32)
    p = tt.init_params(0, moe, "cpu")
    want = float(tt.loss_fn(p, torch.from_numpy(tokens).long(),
                            torch.from_numpy(targets).long(), moe))
    for out in outs:
        np.testing.assert_allclose(out["moe_dp/loss"], want, **LOSS_TOL)


def test_trunk_dp_and_zero1_match_jax(ranks):
    """tests/test_transformer.py:112 at dp 4 (tp 1), and the dp step's
    losses over 3 steps."""
    outs, ins = ranks
    cfg, params, tokens, targets = ins["lm"]
    mesh = jmesh.make_mesh(dp=4, devices=jax.devices()[:4])
    p = jax.tree.map(jnp.asarray, params)
    step = jtfm.make_train_step(cfg, mesh=mesh, lr=LR)
    o, losses = jtfm.init_opt_state(p), []
    for _ in range(3):
        loss, p, o = step(p, o, jnp.asarray(tokens), jnp.asarray(targets))
        losses.append(float(loss))
    p = jax.tree.map(jnp.asarray, params)
    z1 = jtfm.make_train_step(cfg, mesh=mesh, lr=LR, zero1=True)
    oz = jtfm.shard_opt_state(jtfm.init_opt_state(p), cfg, mesh, zero1=True)
    lz, pz, _ = z1(p, oz, jnp.asarray(tokens), jnp.asarray(targets))
    pz = jax.tree.map(np.asarray, pz)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["lm/losses"], losses, **LOSS_TOL)
        np.testing.assert_allclose(out["lm/z1_loss"], float(lz), **LOSS_TOL)
        np.testing.assert_allclose(out["lm/z1_loss"], out["lm/rep_loss"],
                                   rtol=0, atol=1e-6)
        assert float(out["lm/z1_param_diff"]) <= 1e-6
        assert float(out["lm/z1_m_diff"]) <= 1e-6
        assert int(out["lm/z1_m_embed_rows"]) * 4 == LM["vocab_size"]
        assert np.isfinite(out["lm/z1_loss2"])
        for k, v in _flat("", pz, {}).items():
            _hold_adam(out["lm/z1_params" + k], v, LR, k)


def test_bert_dp_step_matches_jax(ranks):
    """tests/test_bert.py:135 at dp 4 only: the padded batch's loss and
    parts, the params after one step; ZeRO-1 equals replicated; the
    dense batch (no mask) runs."""
    outs, ins = ranks
    cfg, params, batch = ins["bert"]
    mesh = jmesh.make_mesh(dp=4, devices=jax.devices()[:4])
    p = jax.tree.map(jnp.asarray, params)
    step = jbert.make_pretrain_step(cfg, mesh=mesh, lr=1e-3)
    loss, (mlm, nsp), wp, _ = step(p, jbert.init_opt_state(p),
                                   jax.tree.map(jnp.asarray, batch))
    want = [float(loss), float(mlm), float(nsp)]
    wp = _flat("", jax.tree.map(np.asarray, wp), {})
    for out in outs:
        np.testing.assert_allclose(out["bert/rep/loss"], want, **LOSS_TOL)
        np.testing.assert_allclose(out["bert/z1/loss"], out["bert/rep/loss"],
                                   rtol=0, atol=1e-6)
        for k, v in wp.items():
            _hold_adam(out["bert/rep/params" + k], v, 1e-3, k)
            np.testing.assert_allclose(out["bert/z1/params" + k],
                                       out["bert/rep/params" + k], rtol=0,
                                       atol=1e-6, err_msg=k)
        assert np.isfinite(out["bert/dense_loss"])


def test_bert_finetune_dp_step_matches_jax(ranks):
    """bert.make_finetune_step(..., mesh=) at dp 4 against the JAX
    package's step on the whole batch: loss, accuracy, params."""
    outs, ins = ranks
    cfg, _, batch = ins["bert"]
    params, label = ins["cls"]
    cbatch = {k: jnp.asarray(batch[k]) for k in
              ("input_ids", "segment_ids", "input_mask")}
    cbatch["label"] = jnp.asarray(label)
    p = jax.tree.map(jnp.asarray, params)
    loss, acc, wp, _ = jbert.make_finetune_step(cfg, lr=1e-3)(
        p, jbert.init_opt_state(p), cbatch)
    wp = _flat("", jax.tree.map(np.asarray, wp), {})
    for out in outs:
        np.testing.assert_allclose(out["cls/loss"], [float(loss), float(acc)],
                                   **LOSS_TOL)
        for k, v in wp.items():
            _hold_adam(out["cls/params" + k], v, 1e-3, k)


def test_bert_data_pipeline_into_the_dp_step(ranks):
    """tests/test_bert.py:87 at dp 4: the port's WordPiece tokenizer and
    instances give the JAX pipeline's batch bit for bit, and the dp step's
    loss is the JAX package's one-device loss on it."""
    outs, ins = ranks
    cfg, params, batch = ins["pipe"]
    loss, (mlm, nsp), _, _ = jbert.make_pretrain_step(cfg, lr=1e-3)(
        jax.tree.map(jnp.asarray, params), jbert.init_opt_state(
            jax.tree.map(jnp.asarray, params)),
        jax.tree.map(jnp.asarray, batch))
    assert batch["input_ids"].shape[0] >= 4
    for out in outs:
        for k, v in batch.items():
            np.testing.assert_array_equal(out[f"pipe/batch/{k}"], v)
        np.testing.assert_allclose(out["pipe/loss"],
                                   [float(loss), float(mlm), float(nsp)],
                                   **LOSS_TOL)


def test_model_axes_and_unported_paths_name_slice_8b(tmp_path):
    """Since slice 8b a mesh splits tensors inside a layer
    (tests/test_torch_tp.py, test_torch_ring.py, test_torch_moe_ep.py hold
    those paths): without a world a mesh asks for one, ring attention on
    one rank is the unfused attention, mesh decoding and ViT's mesh step
    take a ``DeviceMesh`` and refuse anything else. What stays refused
    names slice 8c."""
    for kw in (dict(tp=2), dict(sp=2), dict(ep=2)):
        with pytest.raises(RuntimeError, match="initialize"):
            tmesh.make_mesh(**kw)
    with pytest.raises(NotImplementedError, match="DeviceMesh"):
        tmesh.check_mesh(object())
    with pytest.raises(NotImplementedError, match="slice 8c"):
        ht.dispatch(ht.Variable(name="x", trainable=False), (1, 2))
    cfg = tt.TransformerConfig(dtype=torch.float32, **LM)
    assert callable(tg.make_generate_fn(cfg, 8, mesh=None))
    ring = tt.TransformerConfig(dtype=torch.float32, attn_impl="ring", **LM)
    p, tok = tt.init_params(0, ring, "cpu"), torch.zeros((1, 8),
                                                         dtype=torch.long)
    torch.testing.assert_close(tt.forward(p, tok, ring)[0],
                               tt.forward(p, tok, cfg)[0], rtol=1e-5,
                               atol=1e-6)
    vcfg = tv.ViTConfig(image_size=8, patch_size=4, n_classes=3, d_model=16,
                        n_heads=2, n_layers=1, d_ff=32, dtype=torch.float32)
    vp = tv.init_params(0, vcfg, "cpu")
    assert set(tv.param_specs(vcfg)) == set(vp)
    assert callable(tv.make_train_step(vcfg, mesh=None))
    state = {"w": torch.zeros(3)}
    checkpoint.save(str(tmp_path / "whole"), state)
    with pytest.raises(NotImplementedError, match="slice 8c"):
        checkpoint.restore(str(tmp_path / "whole"), like=state, mesh=object())
    # a ZeRO-1 or pipeline state is refused before anything is written
    for what in ("zero1", "pipeline stage"):
        shard = {"opt": {"m": tmesh.mark_shard(torch.zeros(2), what)}}
        with pytest.raises(NotImplementedError, match="slice 8c"):
            checkpoint.save(str(tmp_path / what), shard)
        assert not os.path.exists(tmp_path / what)
    assert sorted(os.listdir(tmp_path)) == ["whole"]
    with pytest.raises(ValueError, match="zero1"):
        tt.make_train_step(cfg, zero1=True)


def test_the_runner_maps_ranks_to_devices(tmp_path):
    """--devices gives each rank its device and prints the map; --backend
    reaches the ranks' environment (each rank writes what it sees to a
    file of its own)."""
    import subprocess
    probe = ("import os, sys; e = os.environ; open(os.path.join(sys.argv[1], "
             "'rank' + e['RANK']), 'w').write(' '.join(('R', e['RANK'], "
             "e['HETU_DEVICE'], e['HETU_BACKEND'])))")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-w", "2",
         "--devices", "cpu,cpu", "--backend", "gloo", sys.executable, "-c",
         probe, str(tmp_path)], capture_output=True, text=True, timeout=60,
        env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "rank 0 -> cpu, rank 1 -> cpu" in p.stdout, (p.stdout, p.stderr)
    seen = sorted((tmp_path / f).read_text() for f in os.listdir(tmp_path))
    assert seen == ["R 0 cpu gloo", "R 1 cpu gloo"], (p.stdout, p.stderr)
