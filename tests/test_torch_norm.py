"""The executor's op state and random bits: BatchNorm's running stats and
dropout's masks in hetu_tpu_torch, against hetu_tpu on the CPU.

- **BatchNorm.** A conv + BatchNorm + ReLU graph (the ResNet block's
  pattern) trains three SGD steps in both packages from the same initial
  values, then runs a ``validate`` target: losses, the normalized output,
  the gradients and the running mean/var agree within rtol 1e-5 / atol
  1e-6 (``test_torch_graph.py``'s). The running stats move between the
  packages through each one's checkpoint, bit for bit.
- **BatchNorm under data parallelism.** Two gloo worker processes (port
  imports only, a file store in ``tmp_path``, ``.npz`` results) train the
  graph three steps at ``comm_mode="AllReduce"``, each on its half of the
  batch. Their losses, output, parameters and running stats must equal
  each other bit for bit, and equal the port on one device on the global
  batch and the JAX executor on its 8-device mesh within the tolerance
  above: the statistics are the global batch's. The same under bf16
  compute: finite, float32 parameters, losses within 2 % of float32's.
- **Dropout.** Its bits differ from ``jax.random``'s, so it is held by its
  statistics: the share kept within 4σ of ``keep_prob``, kept values
  scaled by 1/keep, whole channels dropped by ``dropout2d``; the gradient
  uses the forward's mask and ``dropout_gradient_op`` redraws it in the
  same step; masks change with the step and repeat with the seed. At
  ``keep_prob=1`` and in ``validate`` it is the identity, as in JAX.
"""
import numpy as np
import pytest
import jax
import torch

import hetu_tpu as jt
import hetu_tpu_torch as pt
from test_torch_quant_comm import run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 3

# One source for both packages and the worker processes (which may not
# import this module: it imports JAX).
GRAPH = r'''
import numpy as np


def bn_inputs(n=16):
    rng = np.random.RandomState(5)
    return {"x": rng.randn(n, 3, 6, 6).astype(np.float32),
            "y": np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)],
            "w0": (rng.randn(4, 3, 3, 3) * 0.3).astype(np.float32),
            "s0": (1.0 + 0.1 * rng.randn(4)).astype(np.float32),
            "b0": (0.1 * rng.randn(4)).astype(np.float32)}


def bn_graph(ht, d):
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y_", trainable=False)
    w = ht.Variable(name="conv_w", value=d["w0"].copy())
    scale = ht.Variable(name="bn_scale", value=d["s0"].copy())
    bias = ht.Variable(name="bn_bias", value=d["b0"].copy())
    bn = ht.batch_normalization_op(ht.conv2d_op(x, w, padding=1, stride=1),
                                   scale, bias)
    h = ht.relu_op(bn)
    logits = ht.reduce_mean_op(h, [2, 3])
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    op = ht.optim.SGDOptimizer(0.1).minimize(loss)
    return x, y_, bn, h, loss, op, [w, scale, bias]


def bn_train(ht, ex, x, y_, h, loss, d, steps):
    feed = {x: d["x"], y_: d["y"]}
    out = {"losses": [], "h": None}
    for _ in range(steps):
        lv, hv, _ = ex.run("train", feed_dict=feed,
                           convert_to_numpy_ret_vals=True)
        out["losses"].append(float(lv))
    out["h"] = hv
    return out
'''
exec(GRAPH)

WORKER = GRAPH + r'''
import sys
import numpy as np
import torch
import hetu_tpu_torch as ht
from hetu_tpu_torch.parallel import multihost

rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 2, rank, device="cpu")
d = bn_inputs()
x, y_, bn, h, loss, op, params = bn_graph(ht, d)
ex = ht.Executor({"train": [loss, h, op]}, ctx=ht.cpu(0), seed=0,
                 comm_mode="AllReduce")
out = bn_train(ht, ex, x, y_, h, loss, d, 3)
res = {"losses": np.array(out["losses"]), "h": out["h"],
       "mean": ex.state["op_state"][id(bn)]["mean"].numpy(),
       "var": ex.state["op_state"][id(bn)]["var"].numpy()}
for n in params:
    res["p_" + n.name] = ex.state["params"][id(n)].numpy()
# bf16 compute under data parallelism: gradients summed in float32
x, y_, bn, h, loss, op, params = bn_graph(ht, d)
ex = ht.Executor({"train": [loss, h, op]}, ctx=ht.cpu(0), seed=0,
                 comm_mode="AllReduce", dtype="bfloat16")
res["bf16_losses"] = np.array(bn_train(ht, ex, x, y_, h, loss, d, 2)["losses"])
for n in params:
    assert ex.state["params"][id(n)].dtype == torch.float32
    res["bf16_p_" + n.name] = ex.state["params"][id(n)].numpy()
multihost.shutdown()
np.savez(sys.argv[4], **res)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "hetu_tpu")]
'''


def _np(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _bn_run(ht, steps=STEPS, **ex_kw):
    """The graph trained ``steps`` steps (fetching the loss, BN's output and
    the gradients of the loss), then one ``validate`` run."""
    d = bn_inputs()
    x, y_, bn, h, loss, op, params = bn_graph(ht, d)
    grads = ht.gradients(loss, params)
    ex = ht.Executor({"train": [loss, bn] + grads + [op],
                      "validate": [loss, bn]}, ctx=ht.cpu(0), seed=0, **ex_kw)
    feed = {x: d["x"], y_: d["y"]}
    train = [ex.run("train", feed_dict=feed, convert_to_numpy_ret_vals=True)
             for _ in range(steps)]
    stats = {k: _np(v) for k, v in ex.state["op_state"][id(bn)].items()}
    val = ex.run("validate", feed_dict=feed, convert_to_numpy_ret_vals=True)
    after = {k: _np(v) for k, v in ex.state["op_state"][id(bn)].items()}
    return train, stats, val, after, ex, bn


def test_batchnorm_trains_and_validates_as_jax():
    jtrain, jstats, jval, _, _, _ = _bn_run(jt)
    ptrain, pstats, pval, pafter, _, _ = _bn_run(pt)
    for step, (g, w) in enumerate(zip(ptrain, jtrain)):
        for k, (a, b) in enumerate(zip(g[:-1], w[:-1])):
            np.testing.assert_allclose(a, b, **TOL,
                                       err_msg=f"step {step} output {k}")
    for k in ("mean", "var"):
        assert pstats[k].dtype == np.float32
        np.testing.assert_allclose(pstats[k], jstats[k], **TOL, err_msg=k)
        # a validate run reads the stats and leaves them
        np.testing.assert_array_equal(pafter[k], pstats[k])
    # moved from (0, 1) by three updates of weight 0.01
    assert not np.allclose(pstats["mean"], 0)
    for a, b in zip(pval, jval):
        np.testing.assert_allclose(a, b, **TOL)


def test_batchnorm_running_stats_use_the_biased_variance_and_momentum():
    """One step from (0, 1): mean = 0.01 · batch mean, var = 0.99 + 0.01 ·
    the biased batch variance (F.batch_norm would store the unbiased one
    and weight the momentum the other way)."""
    d = bn_inputs()
    x, y_, bn, h, loss, op, params = bn_graph(pt, d)
    ex = pt.Executor({"train": [loss, op]}, ctx=pt.cpu(0), seed=0)
    w0 = d["w0"]
    ex.run("train", feed_dict={x: d["x"], y_: d["y"]})
    conv = torch.nn.functional.conv2d(torch.from_numpy(d["x"]),
                                      torch.from_numpy(w0), padding=1)
    mean = conv.mean(dim=(0, 2, 3))
    var = conv.var(dim=(0, 2, 3), unbiased=False)
    st = ex.state["op_state"][id(bn)]
    np.testing.assert_allclose(st["mean"], 0.01 * mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(st["var"], 0.99 + 0.01 * var, rtol=1e-6)


def test_batchnorm_op_state_checkpoints_move_both_ways(tmp_path):
    # JAX -> port
    _, jstats, _, _, jex, _ = _bn_run(jt)
    jex.save(str(tmp_path / "jax"))
    pex, pbn = _bn_run(pt, steps=0)[4:]
    pex.load(str(tmp_path / "jax"))
    for k in ("mean", "var"):
        got = pex.state["op_state"][id(pbn)][k]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), jstats[k])
    assert pex.state["step"] == STEPS
    # port -> JAX
    _, pstats, _, _, pex2, _ = _bn_run(pt, steps=2)
    pex2.save(str(tmp_path / "port"))
    jex2, jbn = _bn_run(jt, steps=0)[4:]
    jex2.load(str(tmp_path / "port"))
    for k in ("mean", "var"):
        np.testing.assert_array_equal(
            np.asarray(jex2.state["op_state"][id(jbn)][k]), pstats[k])


def test_op_state_stays_float32_under_bfloat16():
    train, stats, _, _, ex, bn = _bn_run(pt, dtype="bfloat16")
    assert np.isfinite(train[-1][0]).all()
    for k, v in ex.state["op_state"][id(bn)].items():
        assert v.dtype == torch.float32, k
    for n in ex.param_nodes:
        assert ex.state["params"][id(n)].dtype == \
            torch.float32
    # the stats differ from the float32 run's by bf16 rounding only
    f32 = _bn_run(pt)[1]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], f32[k], rtol=2e-2, atol=2e-3)


def test_batchnorm_under_data_parallelism(tmp_path):
    """Two gloo ranks, each on half of the batch, against one device on
    the whole batch (the port) and the JAX executor on its 8-device mesh."""
    assert jax.device_count() == 8
    ranks = [dict(np.load(o)) for o in run_ranks(tmp_path, WORKER,
                                                 tmp_path / "unused")]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    got = ranks[0]
    assert np.isfinite(got["bf16_losses"]).all()
    np.testing.assert_allclose(got["bf16_losses"], got["losses"][:2],
                               rtol=2e-2)
    d = bn_inputs()
    for ht, kw in ((pt, {}), (jt, {"comm_mode": "AllReduce"})):
        x, y_, bn, h, loss, op, params = bn_graph(ht, d)
        ex = ht.Executor({"train": [loss, h, op]}, ctx=ht.cpu(0), seed=0,
                         **kw)
        want = bn_train(ht, ex, x, y_, h, loss, d, STEPS)
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        assert got["h"].shape == want["h"].shape == (16, 4, 6, 6)
        np.testing.assert_allclose(got["h"], want["h"], **TOL)
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                got[k], _np(ex.state["op_state"][id(bn)][k]), **TOL,
                err_msg=k)
        for n in params:
            np.testing.assert_allclose(got["p_" + n.name],
                                       _np(ex.state["params"][id(n)]),
                                       **TOL, err_msg=n.name)


# -- dropout ---------------------------------------------------------------

def _dropout_step(keep, shape, channelwise=False, seed=0, steps=1):
    """A training step over ones of ``shape`` through dropout (SGD at lr 0,
    so the step runs as training and changes nothing): the output, the
    gradient of sum(out · w) in x, and dropout_gradient_op's redraw of the
    mask on ones, for each step."""
    x = pt.Variable(name="x", value=np.ones(shape, np.float32))
    g1 = pt.Variable(name="g1", value=np.ones(shape, np.float32),
                     trainable=False)
    wv = np.random.RandomState(1).rand(*shape).astype(np.float32) + 0.5
    w = pt.Variable(name="w", value=wv, trainable=False)
    fwd = (pt.dropout2d_op if channelwise else pt.dropout_op)(x, keep)
    regrad = (pt.dropout2d_gradient_op if channelwise
              else pt.dropout_gradient_op)(g1, keep, fwd)
    loss = pt.reduce_sum_op(fwd * w, list(range(len(shape))))
    op = pt.optim.SGDOptimizer(0.0).minimize(loss)
    (gx,) = pt.gradients(loss, [x])
    ex = pt.Executor({"train": [fwd, gx, regrad, op]}, ctx=pt.cpu(0),
                     seed=seed)
    return [ex.run("train", convert_to_numpy_ret_vals=True)[:3]
            for _ in range(steps)], wv


def test_dropout_keeps_its_share_and_scales_by_one_over_keep():
    keep = 0.7
    [(out, gx, regrad)], w = _dropout_step(keep, (200, 150))
    kept = out != 0
    n = out.size
    share = kept.mean()
    assert abs(share - keep) < 4 * np.sqrt(keep * (1 - keep) / n), share
    np.testing.assert_array_equal(out[kept], np.float32(1.0) / np.float32(keep))
    # the gradient takes the forward's mask; the gradient op redraws it
    np.testing.assert_array_equal(gx != 0, kept)
    np.testing.assert_allclose(gx[kept], w[kept] / keep, rtol=1e-6)
    np.testing.assert_array_equal(regrad, out)


def test_dropout2d_drops_whole_channels():
    keep = 0.6
    [(out, gx, regrad)], _ = _dropout_step(keep, (64, 32, 3, 4),
                                           channelwise=True)
    per_channel = out.reshape(64, 32, -1)
    kept = per_channel[:, :, 0] != 0
    # every element of a channel shares its channel's fate
    assert ((per_channel != 0) == kept[:, :, None]).all()
    n = kept.size
    assert abs(kept.mean() - keep) < 4 * np.sqrt(keep * (1 - keep) / n)
    np.testing.assert_array_equal(regrad, out)
    np.testing.assert_array_equal(gx.reshape(64, 32, -1) != 0,
                                  (per_channel != 0))


def test_dropout_masks_change_with_the_step_and_repeat_with_the_seed():
    a, _ = _dropout_step(0.5, (50, 40), seed=3, steps=2)
    b, _ = _dropout_step(0.5, (50, 40), seed=3, steps=2)
    c, _ = _dropout_step(0.5, (50, 40), seed=4, steps=1)
    np.testing.assert_array_equal(a[0][0], b[0][0])
    np.testing.assert_array_equal(a[1][0], b[1][0])
    assert (a[0][0] != a[1][0]).any()
    assert (a[0][0] != c[0][0]).any()


def _dropout_mlp(ht, keep):
    rng = np.random.RandomState(2)
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y_", trainable=False)
    w1 = ht.Variable(name="w1", value=(rng.randn(12, 16) * 0.3).astype(
        np.float32))
    w2 = ht.Variable(name="w2", value=(rng.randn(16, 5) * 0.3).astype(
        np.float32))
    h = ht.dropout_op(ht.relu_op(ht.matmul_op(x, w1)), keep)
    logits = ht.matmul_op(h, w2)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    op = ht.optim.SGDOptimizer(0.5).minimize(loss)
    ex = ht.Executor({"train": [loss, op], "validate": [loss, logits]},
                     ctx=ht.cpu(0), seed=0)
    feed = {x: rng.randn(32, 12).astype(np.float32),
            y_: np.eye(5, dtype=np.float32)[rng.randint(0, 5, 32)]}
    return ex, feed


@pytest.mark.parametrize("keep", [1.0, 0.5])
def test_dropout_matches_jax_where_it_draws_nothing(keep):
    """At keep_prob 1 training matches JAX; in ``validate`` dropout is the
    identity at any keep_prob."""
    (jex, jfeed), (pex, pfeed) = _dropout_mlp(jt, keep), _dropout_mlp(pt, keep)
    jfeed = dict(zip(jfeed, pfeed.values()))
    if keep == 1.0:
        want = [float(jex.run("train", feed_dict=jfeed)[0].asnumpy())
                for _ in range(STEPS)]
        got = [float(pex.run("train", feed_dict=pfeed)[0].asnumpy())
               for _ in range(STEPS)]
        np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(pex.run("validate", feed_dict=pfeed,
                            convert_to_numpy_ret_vals=True),
                    jex.run("validate", feed_dict=jfeed,
                            convert_to_numpy_ret_vals=True)):
        np.testing.assert_allclose(a, b, **TOL)


def test_stateful_infer_shape_on_meta_tensors():
    shapes = [(16, 4, 6, 6), (4,), (4,)]
    for training in (False, True):
        got = pt.batch_normalization_op(
            *[pt.Variable(name=f"v{i}", value=np.zeros(s, np.float32))
              for i, s in enumerate(shapes)]).infer_meta(shapes, training)
        assert tuple(got.shape) == shapes[0] and got.device.type == "meta"
