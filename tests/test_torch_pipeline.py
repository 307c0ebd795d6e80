"""hetu_tpu_torch's transformer pipeline (``parallel/pipeline.py``) against
the JAX package's, on the CPU.

Four worker processes (one group, started once for the file) join a gloo
group through a file store, import only the port, run every case below on
a mesh over all four ranks and write their results; this test holds them
against ``hetu_tpu.parallel.pipeline`` on the 8-device virtual mesh (the
same dp x pp over ``jax.devices()[:4]``), from the same parameters (the
JAX package's, carried over by ``interop.stage_tree``) and data. Ports of
``tests/test_transformer.py``'s pipeline tests:

- ``:81`` GPipe at dp 2 x pp 2 against the one-device loss and the JAX
  GPipe step's losses, 3 steps;
- ``:215`` the 1F1B table: the port's equals the JAX package's (here, in
  process);
- ``:268`` (and ``:330``'s predication) 1F1B against GPipe and dense at
  pp 4: losses over 3 steps, and the first step's gradients against
  ``jax.grad`` of the JAX GPipe loss;
- ``:391`` ZeRO-1 on both schedules at dp 2 x pp 2: equal to the
  replicated step within the port (atol 1e-6), the slots shard over dp;
- ``:174``, ``:428`` dropout: the pipeline equals the trunk's accumulation
  and 1F1B equals GPipe, within the port (the masks come from the port's
  own generators);
- ``:460`` the MoE with remat, at pp 4 (the MoE over several dp ranks
  routes over the global batch: tests/test_torch_mesh.py and
  tests/test_torch_moe_ep.py).

Tolerances: losses rtol 1e-5 / atol 1e-6; gradients rtol 1e-5 and atol
1e-6 times the tensor's largest magnitude (f32 sums in another order);
the parameters after one AdamW step by ``_hold_adam``'s rule
(tests/test_torch_cnn.py: each element within 2 · steps · lr, all but one
in a thousand within 1e-5); after more steps the rule's one in a thousand
does not hold (an element whose gradient is a near cancellation moves by
~1e-5 of lr either way in either package), so longer runs are held by
their losses and the gradients are held at the first step.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from hetu_tpu.models import transformer as jtfm
from hetu_tpu.parallel import mesh as jmesh
from hetu_tpu.parallel import pipeline as jpl
from hetu_tpu_torch.parallel import pipeline as tpl
from test_torch_quant_comm import REPO, port_env
from test_torch_threads import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
            max_seq_len=32, remat=False)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STEPS, LR = 3, 1e-2
# name: (dp, pp, config overrides, microbatches, microbatch rows)
CASES = {"gpipe": (2, 2, {}, 4, 4),
         "pp4": (1, 4, {}, 4, 4),
         "zero1": (2, 2, {}, 2, 4),
         "dropout": (2, 2, {"dropout_rate": 0.25}, 2, 4),
         "moe": (1, 4, {"n_experts": 2, "d_ff": 32, "remat": True}, 4, 4)}

WORKER = r'''
import json
import sys

import numpy as np
import torch

from hetu_tpu_torch import interop
from hetu_tpu_torch.models import transformer as tfm
from hetu_tpu_torch.parallel import mesh as meshlib, multihost
from hetu_tpu_torch.parallel import pipeline as pl

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
    return t


def put(prefix, value):
    if isinstance(value, dict):
        for k, v in value.items():
            put(f"{prefix}/{k}", v)
    else:
        out[prefix] = value.detach().numpy().copy() if torch.is_tensor(
            value) else np.asarray(value)


def fresh(name, cfg, mesh):
    s = meshlib.axis_rank(mesh, "pp")
    return interop.stage_tree(tree(name + "/params"), s, "cpu")


for name, c in spec["cases"].items():
    cfg = tfm.TransformerConfig(**c["cfg"], dtype=torch.float32)
    mesh = meshlib.make_mesh(dp=c["dp"], pp=c["pp"])
    tok = torch.from_numpy(data[name + "/tokens"]).long()
    tgt = torch.from_numpy(data[name + "/targets"]).long()
    M, lr = tok.shape[0], spec["lr"]
    makers = {"gpipe": pl.make_pipeline_train_step,
              "1f1b": pl.make_pipeline_train_step_1f1b}
    if name in ("gpipe", "pp4", "moe"):
        if name == "pp4":
            p = fresh(name, cfg, mesh)
            for leg, make in makers.items():
                _, g = make(cfg, mesh, M, lr=lr).fwd_bwd(p, tok, tgt)
                put(f"{name}/grads_{leg}", g)
            cond = pl.make_pipeline_train_step_1f1b(
                cfg, mesh, M, lr=lr, predication="cond")
            out[f"{name}/cond_loss"] = cond.fwd_bwd(p, tok, tgt)[0].numpy()
        for leg in (["gpipe", "1f1b"] if name == "pp4" else ["gpipe"]):
            p = fresh(name, cfg, mesh)
            o = tfm.init_opt_state(p)
            step = makers[leg](cfg, mesh, M, lr=lr)
            losses = []
            for _ in range(spec["steps"][name]):
                loss, p, o = step(p, o, tok, tgt)
                losses.append(float(loss))
            out[f"{name}/losses_{leg}"] = np.asarray(losses)
            put(f"{name}/params_{leg}", p)
    elif name == "zero1":
        for leg, make in makers.items():
            res = {}
            for z in (False, True):
                p = fresh(name, cfg, mesh)
                o = pl.shard_pipeline_opt_state(tfm.init_opt_state(p), cfg,
                                                mesh, zero1=z)
                step = make(cfg, mesh, M, lr=lr, zero1=z)
                loss, p, o = step(p, o, tok, tgt)
                loss2, _, _ = step(tfm.tree_map(torch.clone, p),
                                   tfm.tree_map(torch.clone, o), tok, tgt)
                res[z] = (float(loss), p, o, float(loss2))
            put(f"{name}/{leg}/params", res[True][1])
            out[f"{name}/{leg}/loss"] = np.asarray(res[True][0])
            out[f"{name}/{leg}/loss_replicated"] = np.asarray(res[False][0])
            out[f"{name}/{leg}/loss2"] = np.asarray(res[True][3])
            out[f"{name}/{leg}/param_diff"] = np.asarray(max(
                float((a - b).abs().max()) for a, b in zip(
                    tfm.tree_leaves(res[True][1]),
                    tfm.tree_leaves(res[False][1]))))
            # each rank's m shard against the replicated m's same rows
            specs = pl._local_specs(pl.zero1_pipeline_opt_specs(cfg, mesh))
            dp, r = meshlib.axis_size(mesh, "dp"), meshlib.axis_rank(mesh, "dp")
            diff = 0.0
            for sm, fm, sp in zip(tfm.tree_leaves(res[True][2]["m"]),
                                  tfm.tree_leaves(res[False][2]["m"]),
                                  tfm.tree_leaves(tfm.tree_map(
                                      lambda _, x: x, res[True][2]["m"],
                                      specs))):
                if "dp" in sp:
                    ax = sp.index("dp")
                    k = fm.shape[ax] // dp
                    fm = fm.narrow(ax, r * k, k)
                diff = max(diff, float((sm - fm).abs().max()))
            out[f"{name}/{leg}/m_diff"] = np.asarray(diff)
            out[f"{name}/{leg}/m_embed_rows"] = np.asarray(
                res[True][2]["m"]["embed"].shape[0])
    elif name == "dropout":
        trunk = tfm.make_train_step(cfg, lr=lr, accum_steps=M)
        runs = {}
        for leg in ("trunk", "gpipe", "1f1b"):
            if leg == "trunk":
                p = interop.tree_from_numpy(
                    {**tree(name + "/params"), "blocks": {
                        k: v.reshape(-1, *v.shape[2:]) for k, v in
                        tree(name + "/params")["blocks"].items()}}, "cpu")
                step = trunk
            else:
                p = fresh(name, cfg, mesh)
                step = makers[leg](cfg, mesh, M, lr=lr)
            o = tfm.init_opt_state(p)
            losses = []
            for i in range(spec["steps"][name]):
                loss, p, o = step(p, o, tok, tgt, 42 + i)
                losses.append(float(loss))
            out[f"{name}/losses_{leg}"] = np.asarray(losses)
            runs[leg] = p
        s, pp = meshlib.axis_rank(mesh, "pp"), meshlib.axis_size(mesh, "pp")
        L = cfg.n_layers // pp
        for leg in ("gpipe", "1f1b"):
            put(f"{name}/blocks_{leg}", runs[leg]["blocks"])
        put(f"{name}/blocks_trunk", {k: v[s * L:(s + 1) * L] for k, v in
                                     runs["trunk"]["blocks"].items()})
        try:
            step(p, o, tok, tgt)
            out[f"{name}/no_key_raises"] = np.asarray(False)
        except ValueError:
            out[f"{name}/no_key_raises"] = np.asarray(True)
out["stage"] = np.asarray(rank)
np.savez(sys.argv[4], **out)
multihost.shutdown()
'''


def _cfg(**kw):
    return jtfm.TransformerConfig(**{**TINY, **kw}, dtype=jnp.float32)


def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _data(M, mb, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, TINY["vocab_size"], (M, mb, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=2).astype(np.int32)


def _start_ranks(tmp, spec, n=4):
    outs = [str(tmp / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(spec), str(r), str(tmp / "store"),
         outs[r]], env=port_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return procs, outs


def _jax_refs(ins):
    """The JAX package's runs the tests hold the ranks against, computed
    while the ranks run."""
    refs = {}
    cfg, mesh, params, tokens, targets = ins["gpipe"]
    flat = {**params, "blocks": {k: v.reshape(-1, *v.shape[2:])
                                 for k, v in params["blocks"].items()}}
    refs["gpipe/oracle"] = float(jtfm.loss_fn(
        jax.tree.map(jnp.asarray, flat), jnp.asarray(tokens.reshape(-1, 16)),
        jnp.asarray(targets.reshape(-1, 16)), cfg, None))
    refs["gpipe/losses"] = _jax_run(jpl.make_pipeline_train_step, cfg, mesh,
                                    params, tokens, targets, STEPS)
    cfg, mesh, params, tokens, targets = ins["pp4"]
    refs["pp4/losses"] = _jax_run(jpl.make_pipeline_train_step, cfg, mesh,
                                  params, tokens, targets, STEPS)
    gstep = jpl.make_pipeline_train_step(cfg, mesh, num_microbatches=4,
                                         lr=LR)
    refs["pp4/grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(
        gstep.fwd_loss))(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(tokens), jnp.asarray(targets)))
    cfg, mesh, params, tokens, targets = ins["zero1"]
    for leg, make in (("gpipe", jpl.make_pipeline_train_step),
                      ("1f1b", jpl.make_pipeline_train_step_1f1b)):
        p = jax.tree.map(jnp.asarray, params)
        o = jpl.shard_pipeline_opt_state(jtfm.init_opt_state(p), cfg, mesh,
                                         zero1=True)
        step = make(cfg, mesh, num_microbatches=2, lr=LR, zero1=True)
        loss, wp, _ = step(p, o, jnp.asarray(tokens), jnp.asarray(targets))
        refs[f"zero1/{leg}"] = (float(loss), jax.tree.map(np.asarray, wp))
    cfg, mesh, params, tokens, targets = ins["moe"]
    refs["moe/losses"] = _jax_run(jpl.make_pipeline_train_step, cfg, mesh,
                                  params, tokens, targets, STEPS + 1)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results of every case, the inputs they got and the
    JAX package's runs."""
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs, cases, ins = {}, {}, {}
    for i, (name, (dp, pp, kw, M, mb)) in enumerate(CASES.items()):
        cfg = _cfg(**kw)
        mesh = jmesh.make_mesh(dp=dp, pp=pp, devices=jax.devices()[:dp * pp])
        params = jax.tree.map(np.asarray, jpl.init_pipeline_params(
            jax.random.PRNGKey(3 + i), cfg, mesh))
        tokens, targets = _data(M, mb, seed=2 + i)
        _flat(f"{name}/params", params, inputs)
        inputs[f"{name}/tokens"], inputs[f"{name}/targets"] = tokens, targets
        cases[name] = dict(dp=dp, pp=pp, cfg={**TINY, **kw})
        ins[name] = (cfg, mesh, params, tokens, targets)
    np.savez(tmp / "in.npz", **inputs)
    spec = dict(data=str(tmp / "in.npz"), cases=cases, lr=LR,
                steps={n: STEPS + (n == "moe") for n in CASES})
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    procs, outs = _start_ranks(tmp, tmp / "spec.json")
    try:
        refs = _jax_refs(ins)
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs], ins, refs


def _jax_run(make, cfg, mesh, params, tokens, targets, steps):
    p = jax.tree.map(jnp.asarray, params)
    o = jtfm.init_opt_state(p)
    step = make(cfg, mesh, num_microbatches=tokens.shape[0], lr=LR)
    losses = []
    for _ in range(steps):
        loss, p, o = step(p, o, jnp.asarray(tokens), jnp.asarray(targets))
        losses.append(float(loss))
    return np.asarray(losses)


def _stages(rank_outs, prefix, dp, pp):
    """The JAX layout of a pipeline tree the ranks wrote (dp index 0's
    stages): blocks stacked over pp, the rest from stage 0."""
    first = rank_outs[0]
    out = {k[len(prefix) + 1:]: v for k, v in first.items()
           if k.startswith(prefix + "/") and "/blocks/" not in k}
    names = {k.split("/")[-1] for k in first
             if k.startswith(prefix + "/blocks/")}
    blocks = {n: np.stack([rank_outs[s][f"{prefix}/blocks/{n}"]
                           for s in range(pp)]) for n in names}
    return out, blocks


def _hold_adam(got, want, steps, lr, what):
    err = np.abs(got - want)
    assert err.max() <= 2 * steps * lr + 1e-6, (what, err.max())
    assert np.mean(err > 1e-5) <= 1e-3, (what, err.max())


def _hold_params(rank_outs, prefix, want, dp, pp, steps):
    other, blocks = _stages(rank_outs, prefix, dp, pp)
    for k, v in other.items():
        _hold_adam(v, want[k], steps, LR, k)
    for k, v in blocks.items():
        _hold_adam(v, want["blocks"][k], steps, LR, k)


def test_gpipe_matches_dense_and_jax(ranks):
    """tests/test_transformer.py:81 at dp 2 x pp 2."""
    outs, _, refs = ranks
    for r in outs:
        np.testing.assert_allclose(r["gpipe/losses_gpipe"],
                                   refs["gpipe/losses"], **LOSS_TOL)
    np.testing.assert_allclose(outs[0]["gpipe/losses_gpipe"][0],
                               refs["gpipe/oracle"], **LOSS_TOL)
    assert outs[0]["gpipe/losses_gpipe"][-1] < outs[0]["gpipe/losses_gpipe"][0]


@pytest.mark.parametrize("pp,M,window", [(2, 1, None), (2, 4, None),
                                         (2, 6, 2), (4, 3, None),
                                         (4, 8, None), (4, 8, 4),
                                         (4, 16, 5)])
def test_1f1b_table_equals_jax(pp, M, window):
    """tests/test_transformer.py:215: the port's schedule table and its
    stats are the JAX package's, tick for tick."""
    assert tpl.simulate_1f1b_schedule(pp, M, window) == \
        jpl.simulate_1f1b_schedule(pp, M, window)
    assert tpl.schedule_stats(pp, M, window) == \
        jpl.schedule_stats(pp, M, window)
    assert tpl.resolve_inflight_window(pp, window) == \
        jpl.resolve_inflight_window(pp, window)


def test_1f1b_matches_gpipe_dense_and_jax_grads(ranks):
    """tests/test_transformer.py:268 at pp 4: both schedules' losses over
    3 steps against the JAX package's GPipe run (its 1F1B equals it within
    rtol 2e-5 there), their first gradients against jax.grad of its GPipe
    loss; the cond predication gives the masked loss."""
    outs, _, refs = ranks
    want, g_ref = refs["pp4/losses"], refs["pp4/grads"]
    for r in outs:
        np.testing.assert_allclose(r["pp4/losses_gpipe"], want, **LOSS_TOL)
        np.testing.assert_allclose(r["pp4/losses_1f1b"], want, **LOSS_TOL)
        np.testing.assert_allclose(r["pp4/cond_loss"], want[0], **LOSS_TOL)
    for leg in ("gpipe", "1f1b"):
        other, blocks = _stages(outs, f"pp4/grads_{leg}", 1, 4)
        for k, v in list(other.items()) + [
                ("blocks/" + k, v) for k, v in blocks.items()]:
            ref = (g_ref["blocks"][k[7:]] if k.startswith("blocks/")
                   else g_ref[k])
            scale = max(float(np.abs(ref).max()), 1.0)
            np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=f"{leg} {k}")


def test_stage_trees_carry_the_jax_layout_both_ways(ranks):
    """interop.stage_tree gives stage s the JAX layout's blocks[s] (marked
    as a stage's, refused by the one-process checkpoint), and
    stages_to_numpy stacks the stages back bit for bit."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.parallel import mesh as tmesh
    _, ins, _ = ranks
    params = ins["gpipe"][2]
    stages = [interop.stage_tree(params, s, "cpu") for s in range(2)]
    for st in stages:
        assert all(tmesh.shard_of(v) == "pipeline stage"
                   for v in st["blocks"].values())
        assert st["blocks"]["wqkv"].shape[0] == TINY["n_layers"] // 2
    back = interop.stages_to_numpy(stages)
    assert set(back) == set(params)
    for k, v in params.items():
        if k == "blocks":
            for n, b in v.items():
                np.testing.assert_array_equal(back["blocks"][n], b)
        else:
            np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("leg", ["gpipe", "1f1b"])
def test_pipeline_zero1_matches_replicated_and_shards_state(ranks, leg):
    """tests/test_transformer.py:391 at dp 2 x pp 2: ZeRO-1's step equals
    the replicated one (atol 1e-6) and the JAX package's ZeRO-1 step; each
    rank's embedding slot holds half the rows; a second step runs."""
    outs, _, refs = ranks
    want, wp = refs[f"zero1/{leg}"]
    for r in outs:
        np.testing.assert_allclose(r[f"zero1/{leg}/loss"], want, **LOSS_TOL)
        np.testing.assert_allclose(r[f"zero1/{leg}/loss"],
                                   r[f"zero1/{leg}/loss_replicated"],
                                   rtol=0, atol=1e-6)
        assert float(r[f"zero1/{leg}/param_diff"]) <= 1e-6
        assert float(r[f"zero1/{leg}/m_diff"]) <= 1e-6
        assert int(r[f"zero1/{leg}/m_embed_rows"]) * 2 == TINY["vocab_size"]
        assert np.isfinite(r[f"zero1/{leg}/loss2"])
    _hold_params(outs, f"zero1/{leg}/params", wp, 2, 2, steps=1)


def test_pipeline_dropout_matches_trunk_and_1f1b_matches_gpipe(ranks):
    """tests/test_transformer.py:174 and :428, within the port: at dp 2 x
    pp 2 with dropout 0.25 the GPipe step equals the trunk's accumulation
    over the same microbatches with the same key (each dp rank keeps its
    rows of the whole microbatch's masks), and 1F1B equals GPipe, losses
    and blocks over 3 steps; a missing key raises."""
    outs = ranks[0]
    for r in outs:
        np.testing.assert_allclose(r["dropout/losses_gpipe"],
                                   r["dropout/losses_trunk"], rtol=2e-5)
        np.testing.assert_allclose(r["dropout/losses_1f1b"],
                                   r["dropout/losses_gpipe"], rtol=2e-5)
        assert bool(r["dropout/no_key_raises"])
        names = {k.split("/")[-1] for k in r
                 if k.startswith("dropout/blocks_trunk/")}
        for n in names:
            t = r[f"dropout/blocks_trunk/{n}"]
            np.testing.assert_allclose(r[f"dropout/blocks_gpipe/{n}"], t,
                                       atol=2e-4, err_msg=n)
            np.testing.assert_allclose(r[f"dropout/blocks_1f1b/{n}"],
                                       r[f"dropout/blocks_gpipe/{n}"],
                                       atol=1e-5, err_msg=n)


def test_pipeline_with_moe_and_remat(ranks):
    """tests/test_transformer.py:460 at pp 4 (dp 1): the MoE with remat,
    4 GPipe steps, against the JAX package's losses."""
    outs, _, refs = ranks
    for r in outs:
        np.testing.assert_allclose(r["moe/losses_gpipe"], refs["moe/losses"],
                                   **LOSS_TOL)
    losses = outs[0]["moe/losses_gpipe"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
