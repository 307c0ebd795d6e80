"""hetu_tpu_torch's graph-API pipeline (``Executor(..., gpipe=True)``,
``graph/gpipe.py``) against the JAX package, on the CPU: ports of
``tests/test_gpipe.py``'s eleven tests.

Four worker processes (one group for the file) join a gloo group through
a file store, import only the port and run the multi-stage cases, one
stage a rank (a context's device id is the rank that runs it); this test
holds them against the JAX package's executors (one device, or GPipe on
the virtual mesh) from the same parameters (each ``Variable``'s value)
and data. The cases that raise run here, in one process.

Tolerances: losses and SGD-trained parameters within rtol 1e-5 / atol
1e-6 (``tests/test_gpipe.py:76-79``); Adam-trained parameters by
``_hold_adam``'s rule (tests/test_torch_cnn.py).
"""
import json

import numpy as np
import pytest

import hetu_tpu as jt
import hetu_tpu_torch as pt
from test_torch_quant_comm import run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)

# The graphs, one source for both packages (``ht`` is hetu_tpu or
# hetu_tpu_torch): the workers exec it too, since they may not import this
# module (it imports JAX). ``cpu``: the context of stage i.
GRAPHS = r'''
import numpy as np


def build_mlp(ht, stage_ctxs, opt="sgd"):
    """tests/test_gpipe.py:_build_mlp: a 4-layer MLP, one layer a stage
    context (None: one device)."""
    rng = np.random.RandomState(0)
    dims = [20, 32, 32, 16, 10]
    ws = [(rng.randn(dims[i], dims[i + 1]) * 0.2).astype(np.float32)
          for i in range(4)]
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y", trainable=False)
    h = x
    for i in range(4):
        ctx = stage_ctxs[i] if stage_ctxs else None
        w = ht.Variable(f"w{i}", value=ws[i].copy(), ctx=ctx)
        h = ht.matmul_op(h, w, ctx=ctx)
        if i < 3:
            h = ht.relu_op(h, ctx=ctx)
    last = stage_ctxs[-1] if stage_ctxs else None
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(h, y_, ctx=last), [0],
                             ctx=last)
    optimizer = (ht.optim.SGDOptimizer(0.1) if opt == "sgd"
                 else ht.optim.AdamOptimizer(0.01))
    return x, y_, loss, optimizer.minimize(loss)


def build_mlp_loaders(ht, stage_ctxs, xv, yv, mb):
    """The same MLP fed by dataloaders (tests/test_gpipe.py:93)."""
    rng = np.random.RandomState(0)
    dims = [20, 32, 32, 16, 10]
    ws = [(rng.randn(dims[i], dims[i + 1]) * 0.2).astype(np.float32)
          for i in range(4)]
    x = ht.dataloader_op([ht.Dataloader(xv, mb, "train")])
    y_ = ht.dataloader_op([ht.Dataloader(yv, mb, "train")])
    h = x
    for i in range(4):
        w = ht.Variable(f"w{i}", value=ws[i].copy(), ctx=stage_ctxs[i])
        h = ht.matmul_op(h, w, ctx=stage_ctxs[i])
        if i < 3:
            h = ht.relu_op(h, ctx=stage_ctxs[i])
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(h, y_, ctx=stage_ctxs[-1]), [0],
        ctx=stage_ctxs[-1])
    return loss, ht.optim.SGDOptimizer(0.1).minimize(loss)


def build_cnn_bn(ht, ctx0, ctx1):
    """tests/test_gpipe.py:_build_cnn_bn: conv + BatchNorm + pool, two
    stages."""
    rng = np.random.RandomState(2)
    w1 = (rng.randn(8, 3, 3, 3) * 0.2).astype(np.float32)
    w2 = (rng.randn(8 * 4 * 4, 10) * 0.2).astype(np.float32)
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y", trainable=False)
    c = ht.Variable("c", value=w1.copy(), ctx=ctx0)
    scale = ht.Variable("scale", value=np.ones(8, np.float32), ctx=ctx0)
    bias = ht.Variable("bias", value=np.zeros(8, np.float32), ctx=ctx0)
    h = ht.conv2d_op(x, c, padding=1, stride=1, ctx=ctx0)
    h = ht.batch_normalization_op(h, scale, bias, ctx=ctx0)
    h = ht.relu_op(h, ctx=ctx0)
    h = ht.max_pool2d_op(h, 2, 2, 0, 2, ctx=ctx0)
    w = ht.Variable("w", value=w2.copy(), ctx=ctx1)
    flat = ht.array_reshape_op(h, [-1, 8 * 4 * 4], ctx=ctx1)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(ht.matmul_op(flat, w, ctx=ctx1), y_,
                                  ctx=ctx1), [0], ctx=ctx1)
    return x, y_, loss, ht.optim.SGDOptimizer(0.1).minimize(loss)


def build_marked(ht, c0, c1):
    """tests/test_gpipe.py:327: two stages cut by explicit send/receive
    markers."""
    rng = np.random.RandomState(0)
    dims = [20, 32, 32, 16, 10]
    ws = [(rng.randn(dims[i], dims[i + 1]) * 0.2).astype(np.float32)
          for i in range(4)]
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y", trainable=False)
    h = x
    for i in range(2):
        w = ht.Variable(f"w{i}", value=ws[i].copy(), ctx=c0)
        h = ht.relu_op(ht.matmul_op(h, w, ctx=c0), ctx=c0)
    sent = ht.pipeline_send_op(h, destination=1, ctx=c0)
    h = ht.pipeline_receive_op(source=sent, ctx=c1)
    for i in range(2, 4):
        w = ht.Variable(f"w{i}", value=ws[i].copy(), ctx=c1)
        h = ht.matmul_op(h, w, ctx=c1)
        if i < 3:
            h = ht.relu_op(h, ctx=c1)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(h, y_, ctx=c1), [0],
                             ctx=c1)
    return x, y_, loss, ht.optim.SGDOptimizer(0.1).minimize(loss)


def feeds(x, y_, xv, yv, M, mb):
    return [{x: xv[m * mb:(m + 1) * mb], y_: yv[m * mb:(m + 1) * mb]}
            for m in range(M)]


def mean_loss(ret):
    return float(np.mean([np.mean(v) for v in ret[0]]))
'''
exec(GRAPHS)

WORKER = GRAPHS + r'''
import json
import sys

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.kernels import registry
from hetu_tpu_torch.parallel import multihost

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 4, rank, device="cpu")
data = np.load(spec["data"])
out = {}
cpu = ht.cpu


def params(ex, prefix):
    """The parameters of this rank's stages, by name."""
    for sub in ex.subexecutors.values():
        for st in sub.stages:
            if st.index in sub.local:
                for n in st.param_nodes:
                    out[f"{prefix}/param/{n.name}"] = ex.state["params"][
                        id(n)].numpy().copy()


def train(ex, x, y_, xv, yv, M, mb, steps, prefix):
    losses = []
    for _ in range(steps):
        losses.append(mean_loss(ex.run("train", feed_dict=feeds(
            x, y_, xv, yv, M, mb), convert_to_numpy_ret_vals=True)))
    out[f"{prefix}/losses"] = np.asarray(losses)
    params(ex, prefix)


# tests/test_gpipe.py:49, SGD and Adam: 4 stages on 4 ranks, plus the
# optimizer applies a step on this rank (one per stage)
xv, yv = data["mlp_x"], data["mlp_y"]
for opt in ("sgd", "adam"):
    x, y_, loss, op = build_mlp(ht, [cpu(i) for i in range(4)], opt)
    ex = ht.Executor({"train": [loss, op]}, gpipe=True, seed=5,
                     ctx=ht.cpu(0))
    registry.reset_stats()
    train(ex, x, y_, xv, yv, 4, 8, 3, f"mlp_{opt}")
    out[f"mlp_{opt}/applies"] = np.asarray(sum(
        v for (k, _), v in registry.dispatch_stats().items()
        if k in ("fused_sgd", "fused_adam")))
    sub = ex.subexecutors["train"]
    out[f"mlp_{opt}/local"] = np.asarray(sorted(sub.local))
    out[f"mlp_{opt}/stage_ranks"] = np.asarray([st.ranks for st in sub.stages])
# :105 dataloader feeds against the explicit list; epoch accounting
x, y_, loss, op = build_mlp(ht, [cpu(i) for i in range(4)])
ref = ht.Executor({"train": [loss, op]}, gpipe=True, seed=5, ctx=ht.cpu(0))
train(ref, x, y_, xv, yv, 4, 8, 3, "dl_ref")
loss, op = build_mlp_loaders(ht, [cpu(i) for i in range(4)], xv, yv, 8)
exd = ht.Executor({"train": [loss, op]}, gpipe=True, seed=5, ctx=ht.cpu(0),
                  gpipe_microbatches=4)
out["dl/losses"] = np.asarray([mean_loss(exd.run(
    "train", convert_to_numpy_ret_vals=True)) for _ in range(3)])
out["dl/batch_num"] = np.asarray(exd.get_batch_num("train"))
# :157 dropout (stages on ranks 0, 1; ranks 2, 3 run none) and eval
rng = np.random.RandomState(4)
w_true = rng.randn(20, 10).astype(np.float32)
dx = rng.randn(2 * 16 * 4, 20).astype(np.float32)
dy = np.eye(10, dtype=np.float32)[(dx @ w_true).argmax(1)]
x = ht.Variable(name="x", trainable=False)
y_ = ht.Variable(name="y", trainable=False)
w1 = ht.Variable("w1", value=(rng.randn(20, 64) * 0.2).astype(np.float32),
                 ctx=cpu(0))
h = ht.dropout_op(ht.relu_op(ht.matmul_op(x, w1, ctx=cpu(0)), ctx=cpu(0)),
                  0.8, ctx=cpu(0))
w2 = ht.Variable("w2", value=(rng.randn(64, 10) * 0.2).astype(np.float32),
                 ctx=cpu(1))
logits = ht.matmul_op(h, w2, ctx=cpu(1))
dloss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_, ctx=cpu(1)),
                          [0], ctx=cpu(1))
exp = ht.Executor({"train": [dloss, ht.optim.SGDOptimizer(0.1).minimize(
    dloss)], "validate": [logits]}, gpipe=True, seed=5, ctx=ht.cpu(0))
losses = []
for step in range(30):
    lo = (step * 32) % len(dx)
    losses.append(mean_loss(exp.run("train", feed_dict=feeds(
        x, y_, dx[lo:], dy[lo:], 2, 16), convert_to_numpy_ret_vals=True)))
out["dropout/losses"] = np.asarray(losses)
a = exp.run("validate", feed_dict=[{x: dx[:16]}],
            convert_to_numpy_ret_vals=True)
b = exp.run("validate", feed_dict=[{x: dx[:16]}],
            convert_to_numpy_ret_vals=True)
out["dropout/eval_a"], out["dropout/eval_b"] = a[0][0], b[0][0]
# :203 a validate entry pipelines, and does not advance the step
x, y_, loss, op = build_mlp(ht, [cpu(i) for i in range(4)])
exv = ht.Executor({"train": [loss, op], "validate": [loss]}, gpipe=True,
                  seed=5, ctx=ht.cpu(0))
exv.run("train", feed_dict=feeds(x, y_, xv, yv, 2, 8))
ret = exv.run("validate", feed_dict=feeds(x, y_, xv, yv, 2, 8),
              convert_to_numpy_ret_vals=True)
out["validate/losses"] = np.asarray([float(np.mean(v)) for v in ret[0]])
out["validate/step"] = np.asarray(exv.state["step"])
# :220 pp x dp: stages [cpu0, cpu1] and [cpu2, cpu3]
px, py = data["ppdp_x"], data["ppdp_y"]
g0, g1 = [cpu(0), cpu(1)], [cpu(2), cpu(3)]
x, y_, loss, op = build_mlp(ht, [g0, g0, g1, g1])
exp = ht.Executor({"train": [loss, op]}, gpipe=True, seed=5, ctx=ht.cpu(0),
                  comm_mode="AllReduce")
sub = exp.subexecutors["train"]
out["ppdp/stage_dp"] = np.asarray([st.dp for st in sub.stages])
train(exp, x, y_, px, py, 4, 8, 3, "ppdp")
# :283 BatchNorm: one stage (rank 0) against two (ranks 0, 1)
bx, by = data["bn_x"], data["bn_y"]
for name, ctxs in (("bn1", (cpu(0), cpu(0))), ("bn2", (cpu(0), cpu(1)))):
    x, y_, loss, op = build_cnn_bn(ht, *ctxs)
    ex = ht.Executor({"train": [loss, op]}, gpipe=True, seed=5,
                     ctx=ht.cpu(0))
    out[f"{name}/stages"] = np.asarray(len(ex.subexecutors["train"].stages))
    train(ex, x, y_, bx, by, 3, 8, 3, name)
    for i, (k, v) in enumerate(ex.state["op_state"].items()):
        if ex.subexecutors["train"].local:
            for leaf, t in sorted(v.items()):
                out[f"{name}/state/{leaf}"] = t.numpy().copy()
# :327 explicit send/receive markers
mx, my = data["mark_x"], data["mark_y"]
x, y_, loss, op = build_marked(ht, cpu(0), cpu(1))
exm = ht.Executor({"train": [loss, op]}, gpipe=True, seed=5, ctx=ht.cpu(0))
out["marked/stages"] = np.asarray(len(exm.subexecutors["train"].stages))
out["marked/loss"] = np.asarray(mean_loss(exm.run(
    "train", feed_dict=feeds(x, y_, mx, my, 2, 8),
    convert_to_numpy_ret_vals=True)))
# the group all-reduce over new_group_comm's sub-groups (every rank makes
# both groups, in one order), outside a pipeline
groups = [ht.new_group_comm([cpu(0), cpu(1)]),
          ht.new_group_comm([cpu(2), cpu(3)])]
v = ht.Variable(name="v", trainable=False)
red = ht.groupallreduceCommunicate_op(v, groups[rank // 2])
out["group/mean"] = ht.Executor([red], ctx=ht.cpu(0)).run(
    feed_dict={v: np.full((3,), float(rank), np.float32)},
    convert_to_numpy_ret_vals=True)[0]
out["group/ranks"] = np.asarray(groups[rank // 2].ranks)
np.savez(sys.argv[4], **out)
multihost.shutdown()
'''


def _data(n, seed):
    rng = np.random.RandomState(seed)
    xv = rng.randn(n, 20).astype(np.float32)
    return xv, np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]


def _bn_data():
    rng = np.random.RandomState(4)
    xv = rng.randn(24, 3, 8, 8).astype(np.float32)
    return xv, np.eye(10, dtype=np.float32)[rng.randint(0, 10, 24)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    mx, my = _data(32, 3)
    px, py = _data(32, 11)
    bx, by = _bn_data()
    kx, ky = _data(16, 7)
    np.savez(tmp / "in.npz", mlp_x=mx, mlp_y=my, ppdp_x=px, ppdp_y=py,
             bn_x=bx, bn_y=by, mark_x=kx, mark_y=ky)
    with open(tmp / "spec.json", "w") as f:
        json.dump(dict(data=str(tmp / "in.npz")), f)
    outs = [dict(np.load(o)) for o in run_ranks(tmp, WORKER,
                                                 tmp / "spec.json", n=4)]
    return outs, dict(mlp=(mx, my), ppdp=(px, py), bn=(bx, by),
                      mark=(kx, ky))


def _merged(outs, prefix):
    """Every rank's stage parameters under ``prefix``, by name."""
    got = {}
    for out in outs:
        got.update({k[len(prefix) + 7:]: v for k, v in out.items()
                    if k.startswith(prefix + "/param/")})
    return got


def _one_device(build, data, M, mb, steps, opt="sgd", **kw):
    x, y_, loss, op = build(jt, None, opt) if opt else build(jt, None)
    ex = jt.Executor({"train": [loss, op]}, ctx=jt.cpu(0), seed=5, **kw)
    xv, yv = data
    losses = [float(np.mean(ex.run("train", feed_dict={x: xv[:M * mb],
                                                        y_: yv[:M * mb]},
                                   convert_to_numpy_ret_vals=True)[0]))
              for _ in range(steps)]
    params = {n.name: np.asarray(ex.state["params"][id(n)])
              for n in ex.param_nodes}
    return np.asarray(losses), params


def _hold_adam(got, want, steps, lr, what):
    err = np.abs(got - want)
    assert err.max() <= 2 * steps * lr + 1e-6, (what, err.max())
    assert np.mean(err > 1e-5) <= 1e-3, (what, err.max())


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_gpipe_matches_single_device(ranks, opt):
    """tests/test_gpipe.py:49 on four ranks (and Adam): the pipeline step
    equals one device's on the concatenated batch; the optimizer applies
    once a step on each stage's rank (the plain path's calls counted)."""
    outs, data = ranks
    want, wp = _one_device(build_mlp, data["mlp"], 4, 8, 3, opt)
    got = _merged(outs, f"mlp_{opt}")
    assert sorted(got) == sorted(wp)
    for out in outs:
        np.testing.assert_allclose(out[f"mlp_{opt}/losses"], want, **TOL)
        assert int(out[f"mlp_{opt}/applies"]) == 3      # one a step
    for k, v in wp.items():
        if opt == "sgd":
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
        else:
            _hold_adam(got[k], v, 3, 0.01, k)


def test_gpipe_dataloader_feeds_match_explicit_feed_list(ranks):
    """tests/test_gpipe.py:105: dataloader-fed steps (gpipe_microbatches)
    equal the explicit feed list's; one epoch is one step."""
    outs, _ = ranks
    for out in outs:
        np.testing.assert_allclose(out["dl/losses"], out["dl_ref/losses"],
                                   **TOL)
        assert int(out["dl/batch_num"]) == 1


def test_gpipe_dataloader_needs_gpipe_microbatches():
    """tests/test_gpipe.py:105's last case: a dataloader step without M
    raises."""
    xv, yv = _data(32, 3)
    loss, op = build_mlp_loaders(pt, [pt.cpu(i) for i in range(4)], xv, yv,
                                 8)
    ex = pt.Executor({"train": [loss, op]}, gpipe=True, seed=5,
                     ctx=pt.cpu(0))
    with pytest.raises(ValueError, match="gpipe_microbatches"):
        ex.run("train")


def test_gpipe_stages_run_on_distinct_ranks(ranks):
    """tests/test_gpipe.py:142: each stage on its own rank, and each rank
    holds its stage's parameters."""
    outs, _ = ranks
    for r, out in enumerate(outs):
        assert list(out["mlp_sgd/local"]) == [r]
        np.testing.assert_array_equal(out["mlp_sgd/stage_ranks"],
                                      [[0], [1], [2], [3]])
        assert sorted(k.split("/")[-1] for k in out
                      if k.startswith("mlp_sgd/param/")) == [f"w{r}"]


def test_gpipe_dropout_trains_and_eval_is_deterministic(ranks):
    """tests/test_gpipe.py:157: dropout on stage 0 (its own masks a
    microbatch), training converges, the validate entry is mask-free."""
    outs, _ = ranks
    for out in outs:
        losses = out["dropout/losses"]
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
        np.testing.assert_array_equal(out["dropout/eval_a"],
                                      out["dropout/eval_b"])


def test_gpipe_validate_entry_pipelines(ranks):
    """tests/test_gpipe.py:203."""
    outs, _ = ranks
    for out in outs:
        vals = out["validate/losses"]
        assert len(vals) == 2 and np.all(np.isfinite(vals))
        assert int(out["validate/step"]) == 1


def test_gpipe_pp_dp_matches_single_device(ranks):
    """tests/test_gpipe.py:220: two stages of two dp ranks each."""
    outs, data = ranks
    want, wp = _one_device(build_mlp, data["ppdp"], 4, 8, 3)
    got = _merged(outs, "ppdp")
    for out in outs:
        np.testing.assert_array_equal(out["ppdp/stage_dp"], [2, 2])
        np.testing.assert_allclose(out["ppdp/losses"], want, **TOL)
    for k, v in wp.items():
        np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)


def test_gpipe_batchnorm_pipeline(ranks):
    """tests/test_gpipe.py:283: a one-stage pipeline equals a two-stage
    one (losses, params, running stats), and both equal the JAX package's
    one-stage GPipe run."""
    outs, data = ranks
    x, y_, loss, op = build_cnn_bn(jt, jt.cpu(0), jt.cpu(0))
    ex = jt.Executor({"train": [loss, op]}, gpipe=True, seed=5)
    bx, by = data["bn"]
    want = [mean_loss(ex.run("train", feed_dict=feeds(x, y_, bx, by, 3, 8),
                             convert_to_numpy_ret_vals=True))
            for _ in range(3)]
    wp = {n.name: np.asarray(ex.state["params"][id(n)])
          for n in ex.param_nodes}
    (state,) = ex.state["op_state"].values()
    for out in outs:
        assert int(out["bn1/stages"]) == 1 and int(out["bn2/stages"]) == 2
        np.testing.assert_allclose(out["bn1/losses"], want, **TOL)
        np.testing.assert_allclose(out["bn2/losses"], out["bn1/losses"],
                                   **TOL)
    for name in ("bn1", "bn2"):
        got = _merged(outs, name)
        for k, v in wp.items():
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=(name, k))
    # rank 0 holds stage 0's BatchNorm in both runs
    for leaf, v in state.items():
        for name in ("bn1", "bn2"):
            np.testing.assert_allclose(outs[0][f"{name}/state/{leaf}"],
                                       np.asarray(v), **TOL)
    assert np.abs(outs[0]["bn2/state/" + sorted(state)[0]]).max() > 1e-3


def test_gpipe_explicit_send_recv_markers(ranks):
    """tests/test_gpipe.py:327: markers cut the graph into two stages; the
    marked pipeline equals the one-device run."""
    outs, data = ranks
    want, _ = _one_device(build_mlp, data["mark"], 2, 8, 1)
    for out in outs:
        assert int(out["marked/stages"]) == 2
        np.testing.assert_allclose(out["marked/loss"], want[0], **TOL)


def test_group_allreduce_over_new_group_comm(ranks):
    """groupallreduceCommunicate_op over the sub-groups new_group_comm
    makes (reference executor.py:248-256): each pair of ranks averages its
    own values."""
    outs, _ = ranks
    for r, out in enumerate(outs):
        pair = [r // 2 * 2, r // 2 * 2 + 1]
        np.testing.assert_array_equal(out["group/ranks"], pair)
        np.testing.assert_allclose(out["group/mean"],
                                   np.full(3, np.mean(pair), np.float32))


def test_pipeline_recv_requires_paired_send():
    """tests/test_gpipe.py:375."""
    with pytest.raises(TypeError, match="paired"):
        pt.pipeline_receive_op(source=3)


def test_gpipe_without_stage_contexts_raises():
    """tests/test_gpipe.py:380."""
    x, y_, loss, op = build_mlp(pt, None)
    with pytest.raises(ValueError, match="context"):
        pt.Executor({"train": [loss, op]}, gpipe=True, ctx=pt.cpu(0))


def test_gpipe_microbatch_list_required():
    """tests/test_gpipe.py:386; and comm_quant, which the pipeline's own
    transfers exclude, is refused with gpipe (reference executor.py:204)."""
    x, y_, loss, op = build_mlp(pt, [pt.cpu(i) for i in range(4)])
    ex = pt.Executor({"train": [loss, op]}, gpipe=True, ctx=pt.cpu(0))
    with pytest.raises(ValueError, match="microbatch"):
        ex.run("train", feed_dict=None)
    with pytest.raises(ValueError, match="comm_quant"):
        pt.Executor({"train": [loss, op]}, gpipe=True, ctx=pt.cpu(0),
                    comm_quant="int8")


def test_gpipe_in_one_process_runs_every_stage():
    """Alone in its world a process runs all four stages, and equals one
    device (the same step as test_gpipe_matches_single_device's)."""
    data = _data(32, 3)
    want, wp = _one_device(build_mlp, data, 4, 8, 2)
    x, y_, loss, op = build_mlp(pt, [pt.cpu(i) for i in range(4)])
    ex = pt.Executor({"train": [loss, op]}, gpipe=True, seed=5,
                     ctx=pt.cpu(0))
    got = [mean_loss(ex.run("train", feed_dict=feeds(x, y_, *data, 4, 8),
                            convert_to_numpy_ret_vals=True))
           for _ in range(2)]
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted(ex.subexecutors["train"].local) == [0, 1, 2, 3]
