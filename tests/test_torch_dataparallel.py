"""hetu_tpu_torch's data parallelism (``comm_mode="AllReduce"``) against the
JAX package, on the CPU.

The port runs one process per device; here two worker processes join a
gloo group through a file store (no TCP port), import only the port, run
every case below and write their results, which this test holds against
the JAX package's executor on the 8-device virtual mesh (one process,
GSPMD), or on one device where that is the oracle:

- ``tests/test_dataparallel.py``'s oracle: data parallelism equals one
  device on the global batch (5 SGD steps), and a batch of 13 rows, which
  two ranks cannot split, warns "not divisible by dp" and replicates.
- ``tests/test_comm_quant.py``'s MLP (width 64, ``min_size`` 1024, batch
  64) for 3 steps under ``comm_quant`` off, int8 and fp8, with error
  feedback on and off, SGD and Adam; and the CNN example's MLP
  (3072-256-256-10, batch 128) for 3 SGD steps, off, int8 and fp8. Both
  packages start from the JAX executor's parameters (``Executor.save``,
  then the port's ``load``).
- The off mode's bit identity with the default, the re-assert of the exact
  path on a graph an int8 executor marked before, and the exemption of
  small parameters (ports of ``test_comm_quant.py:136``, ``:175``,
  ``:216``).
- A checkpoint's error-feedback residuals (``qresid``) written by each
  package and read by the other.
- ``python -m hetu_tpu_torch.runner -w 2`` of the port's CNN example,
  end to end.

Tolerances. Unquantized: losses and parameters within rtol 1e-5 / atol
1e-6 (test_dataparallel.py's), since the two packages sum the batch's
gradient in another order. Quantized: the two packages reduce the
gradient in float32 in another order, so an element's quotient by its
block's scale can land on the other side of a rounding boundary and
dequantize one quantization step (the block's scale) away. Such a flip is
rare (the quotients differ by an ulp or so), and moves an SGD parameter
by lr times that scale: the parameters are held within ``steps · lr ·
S`` plus the unquantized tolerance, where S is the largest block scale of
the run (the largest gradient element over Q, read off the JAX run's
unquantized gradient with a margin of 2). Adam divides the gradient by
its running RMS, so a flip moves a parameter by at most about lr a step:
``steps · lr`` plus the unquantized tolerance. Losses within rtol 1e-4.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax

import hetu_tpu as jt
from test_torch_quant_comm import port_env, run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL_Q = dict(rtol=1e-4)
Q = {"int8": 127.0, "fp8": 448.0}

# The graphs, one source for both packages (``ht`` is hetu_tpu or
# hetu_tpu_torch): the worker processes exec it too, since they may not
# import this module (it imports JAX).
GRAPHS = r'''
def build(ht, kind, opt, lr, w0=None):
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y_", trainable=False)
    if kind == "oracle":
        # tests/test_dataparallel.py:build
        logits = ht.matmul_op(x, ht.Variable(name="w", value=w0.copy()))
    elif kind in ("mlp", "mlp32"):
        # tests/test_comm_quant.py:_mlp
        width = 64 if kind == "mlp" else 32
        h = x
        for i in range(3):
            w = ht.init.random_normal((width, width), stddev=0.05,
                                      name=f"w{i}")
            h = ht.relu_op(ht.matmul_op(h, w))
        wo = ht.init.random_normal((width, 8), stddev=0.05, name="wo")
        logits = ht.matmul_op(h, wo)
    else:
        # examples/cnn/models/MLP.py
        h = x
        for name, shape, relu in (("mlp_fc1", (3072, 256), True),
                                  ("mlp_fc2", (256, 256), True),
                                  ("mlp_fc3", (256, 10), False)):
            w = ht.init.random_normal(shape=shape, stddev=0.1,
                                      name=name + "_weight")
            b = ht.init.random_normal(shape=shape[-1:], stddev=0.1,
                                      name=name + "_bias")
            h = ht.matmul_op(h, w)
            h = h + ht.broadcastto_op(b, h)
            if relu:
                h = ht.relu_op(h)
        logits = h
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(logits, y_), [0])
    make = (ht.optim.SGDOptimizer if opt == "sgd"
            else ht.optim.AdamOptimizer)
    return x, y_, logits, loss, make(lr).minimize(loss)


def quant_kw(c):
    if c.get("quant") is None:
        return {}
    return dict(comm_quant=c["quant"], comm_quant_min_size=c["min_size"],
                comm_quant_error_feedback=c["ef"])
'''
exec(GRAPHS)

WORKER = GRAPHS + r'''
import json
import sys
import warnings

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.parallel import multihost

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 2, rank, device="cpu")
data = np.load(spec["data"])
out, meta = {}, {}


def run(c, x, y_, y, loss, op):
    ex = ht.Executor({"train": [loss, y, op]}, ctx=ht.cpu(0), seed=0,
                     comm_mode="AllReduce", **quant_kw(c))
    if c.get("init"):
        ex.load(c["init"])
    if c.get("per_op"):
        # the per-op path: each marked op alone, in the walk
        # (quantized_allreduce per tensor), no group
        for sub in ex.subexecutors.values():
            sub.qar_groups, sub.qar_deferred = {}, set()
    feed = {x: data[c["feed"] + "_x"], y_: data[c["feed"] + "_y"]}
    steps = c["steps"]
    if c.get("resume"):
        # two steps on other data, then the checkpoint of another run's
        # first step, read mid-run (its residuals into the live entries)
        other = {x: data[c["feed"] + "_x"][::-1].copy(),
                 y_: data[c["feed"] + "_y"]}
        for _ in range(2):
            ex.run("train", feed_dict=other)
        ex.load(c["resume"])
        steps -= 1
    losses = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(steps):
            lv, yv, _ = ex.run("train", feed_dict=feed,
                               convert_to_numpy_ret_vals=True)
            losses.append(lv)
    name = c["name"]
    out[name + "/losses"] = np.array(losses)
    out[name + "/y"] = yv
    for n in ex.param_nodes:
        out[f"{name}/p/{n.name}"] = ex.state["params"][id(n)].numpy()
    meta[name] = {
        "warnings": [str(w.message) for w in caught],
        "qar": [n.param_node.name for n in ex.qar_ops],
        "qresid": len(ex.state["qresid"]), "report": ex.comm_quant_report,
        "marks": sum(bool(getattr(n, "comm_quant", False))
                     for n in op.inputs),
        "grouped": sorted(len(ops) for sub in ex.subexecutors.values()
                          for ops, _ in sub.qar_groups.values())}
    if c.get("save"):
        ex.save(c["save"])
    return ex


for c in spec["cases"]:
    w0 = data["oracle_w"] if c["kind"] == "oracle" else None
    graph = build(ht, c["kind"], c["opt"], c["lr"], w0)
    if c.get("shared"):   # an int8 executor marks the graph first
        run(dict(c, name=c["name"] + "_marker", quant="int8",
                 min_size=1024, ef=True), *graph)
    ex = run(c, *graph)
    if c.get("resave"):   # load a checkpoint and write it back unchanged
        ex.load(c["resave"][0])
        ex.save(c["resave"][1])
# the host-side helpers of the world
multihost.barrier()
meta["world"] = {
    "index": multihost.process_index(), "count": multihost.process_count(),
    "gathered": multihost.process_allgather(
        np.array([rank, 10 + rank], np.int64)).tolist(),
    "chief": multihost.broadcast_from_chief({"rank": rank, "seed": 7 + rank})}

# a fetch the placement rule cannot place: a parameter's gradient computed
# from this rank's share of the batch, before its all-reduce
x, y_, y, loss, op = build(ht, "oracle", "sgd", 0.1, data["oracle_w"])
grad = ht.gradients(loss, [op.vars[0]])[0]
ex = ht.Executor({"g": [grad]}, ctx=ht.cpu(0), comm_mode="AllReduce")
try:
    ex.run("g", feed_dict={x: data["o64_x"], y_: data["o64_y"]})
    meta["bad_fetch"] = None
except ValueError as e:
    meta["bad_fetch"] = str(e)
# a fed placeholder with batch=False is never cut: a (4,) logit offset
x, y_, y, loss, op = build(ht, "oracle", "sgd", 0.1, data["oracle_w"])
off = ht.Variable(name="offset", trainable=False, batch=False)
shifted = ht.reduce_mean_op(ht.softmaxcrossentropy_op(
    y + ht.broadcastto_op(off, y), y_), [0])
ex = ht.Executor({"f": [shifted, off * 2.0]}, ctx=ht.cpu(0),
                 comm_mode="AllReduce")
out["batch_false/loss"], out["batch_false/offset"] = ex.run(
    "f", feed_dict={x: data["o64_x"], y_: data["o64_y"],
                    off: data["offset"]}, convert_to_numpy_ret_vals=True)
multihost.shutdown()
np.savez(sys.argv[4], **out)
with open(sys.argv[4] + ".json", "w") as f:
    json.dump(meta, f)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "hetu_tpu")]
'''


def _run_ranks(tmp_path, spec):
    """Both ranks of the worker over ``spec``: each rank's (arrays, meta)."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    return [(dict(np.load(o)), json.load(open(o + ".json")))
            for o in run_ranks(tmp_path, WORKER, spec_path)]


def _data():
    rng = np.random.RandomState(3)   # tests/test_dataparallel.py:make_data
    d = {"oracle_w": np.random.RandomState(0).randn(16, 4).astype(np.float32),
         "offset": np.array([0.5, -1.0, 2.0, 0.25], np.float32)}
    for n in (64, 13):
        rng = np.random.RandomState(3)
        d[f"o{n}_x"] = rng.randn(n, 16).astype(np.float32)
        d[f"o{n}_y"] = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]
    rng = np.random.RandomState(0)   # tests/test_comm_quant.py:_run_mlp
    d["mlp_x"] = rng.randn(64, 64).astype(np.float32)
    d["mlp_y"] = np.eye(8, dtype=np.float32)[rng.randint(0, 8, 64)]
    d["mlp32_x"] = d["mlp_x"][:, :32].copy()
    d["mlp32_y"] = d["mlp_y"]
    rng = np.random.RandomState(1)
    d["cnn_x"] = (rng.randn(128, 3072) * 0.5).astype(np.float32)
    d["cnn_y"] = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 128)]
    return d


def _cases(tmp):
    mlp = dict(kind="mlp", feed="mlp", steps=3, min_size=1024,
               init=f"{tmp}/mlp_init")
    cnn = dict(kind="cnn", feed="cnn", steps=3, opt="sgd", lr=0.01,
               min_size=2048, ef=True, init=f"{tmp}/cnn_init")
    cases = [dict(name="oracle64", kind="oracle", feed="o64", steps=5,
                  opt="sgd", lr=0.1),
             dict(name="oracle13", kind="oracle", feed="o13", steps=1,
                  opt="sgd", lr=0.1),
             dict(mlp, name="sgd_default", opt="sgd", lr=0.05),
             dict(mlp, name="sgd_off", opt="sgd", lr=0.05, quant="off",
                  ef=True),
             dict(mlp, name="sgd_int8", opt="sgd", lr=0.05, quant="int8",
                  ef=True, save=f"{tmp}/port_ckpt",
                  resave=(f"{tmp}/jax_ckpt", f"{tmp}/port_resave")),
             dict(mlp, name="sgd_int8_noef", opt="sgd", lr=0.05,
                  quant="int8", ef=False),
             dict(mlp, name="sgd_fp8", opt="sgd", lr=0.05, quant="fp8",
                  ef=True),
             dict(mlp, name="sgd_int8_per_op", opt="sgd", lr=0.05,
                  quant="int8", ef=True, per_op=True),
             dict(mlp, name="sgd_fp8_per_op", opt="sgd", lr=0.05,
                  quant="fp8", ef=True, per_op=True),
             dict(mlp, name="adam_fp8_noef_per_op", opt="adam", lr=1e-3,
                  quant="fp8", ef=False, per_op=True),
             dict(mlp, name="sgd_int8_step1", opt="sgd", lr=0.05,
                  quant="int8", ef=True, steps=1, save=f"{tmp}/step1_ckpt"),
             dict(mlp, name="sgd_int8_resumed", opt="sgd", lr=0.05,
                  quant="int8", ef=True, resume=f"{tmp}/step1_ckpt"),
             dict(mlp, name="adam_off", opt="adam", lr=1e-3, quant="off",
                  ef=True),
             dict(mlp, name="adam_int8", opt="adam", lr=1e-3, quant="int8",
                  ef=True),
             dict(mlp, name="adam_fp8_noef", opt="adam", lr=1e-3,
                  quant="fp8", ef=False),
             dict(cnn, name="cnn_off", quant="off"),
             dict(cnn, name="cnn_int8", quant="int8"),
             dict(cnn, name="cnn_fp8", quant="fp8"),
             dict(mlp, name="shared_off", opt="sgd", lr=0.05, quant="off",
                  ef=True, shared=True),
             dict(name="small", kind="mlp32", feed="mlp32", steps=1,
                  opt="sgd", lr=0.05, quant="int8", min_size=2048, ef=True)]
    return {c["name"]: c for c in cases}


def _jax_run(c, data, **kw):
    """The case on the JAX executor: the 8-device mesh, or ``kw``."""
    w0 = data["oracle_w"] if c["kind"] == "oracle" else None
    x, y_, y, loss, op = build(jt, c["kind"], c["opt"], c["lr"], w0)
    kw = kw or dict(comm_mode="AllReduce")
    ex = jt.Executor({"train": [loss, y, op]}, ctx=jt.cpu(0), seed=0,
                     **quant_kw(c), **kw)
    if c.get("init"):
        ex.load(c["init"])
    feed = {x: data[c["feed"] + "_x"], y_: data[c["feed"] + "_y"]}
    losses, grads, yv = [], [], None
    prev = {n.name: np.asarray(ex.state["params"][id(n)])
            for n in ex.param_nodes}
    for _ in range(c["steps"]):
        lv, yv, _ = ex.run("train", feed_dict=feed,
                           convert_to_numpy_ret_vals=True)
        losses.append(float(lv))
        now = {n.name: np.asarray(ex.state["params"][id(n)])
               for n in ex.param_nodes}
        grads.append({k: (prev[k] - now[k]) / c["lr"] for k in now})
        prev = now
    return np.array(losses), prev, yv, grads, ex


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the port's two ranks, once for the module, and
    the JAX package's initial states and checkpoint that they read."""
    assert jax.device_count() == 8
    tmp = tmp_path_factory.mktemp("dp")
    data = _data()
    np.savez(tmp / "data.npz", **data)
    cases = _cases(tmp)
    # the JAX executor's initial parameters (no optimizer state: the cases
    # take one initial state with either optimizer)
    for kind, name in (("mlp", "mlp_init"), ("cnn", "cnn_init")):
        _, _, _, loss, op = build(jt, kind, "sgd", 0.1)
        jt.Executor({"train": [loss, op]}, ctx=jt.cpu(0), seed=0,
                    comm_mode="AllReduce").save(str(tmp / name))
        os.remove(tmp / name / "executor_state.pkl")
    # a JAX checkpoint with residuals, for the port to read
    _, _, _, _, jex = _jax_run(cases["sgd_int8"], data)
    jex.save(str(tmp / "jax_ckpt"))
    ranks = _run_ranks(tmp, {"data": str(tmp / "data.npz"),
                             "cases": list(cases.values())})
    return data, cases, ranks, tmp


def _port(ranks, name):
    """One case's results; both ranks must return the same values."""
    (a, ma), (b, mb) = ranks
    keys = [k for k in a if k.startswith(name + "/")]
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    params = {k.split("/p/")[1]: a[k] for k in keys if "/p/" in k}
    return a[name + "/losses"], params, a[name + "/y"], ma[name]


def test_dp_equals_one_device_on_the_global_batch(runs):
    data, cases, ranks, _ = runs
    c = cases["oracle64"]
    want_l, want_p, want_y, _, _ = _jax_run(c, data, comm_mode=None)
    losses, params, y, meta = _port(ranks, "oracle64")
    np.testing.assert_allclose(losses, want_l, **TOL)
    np.testing.assert_allclose(params["w"], want_p["w"], **TOL)
    assert y.shape == (64, 4)            # the global batch's rows, gathered
    np.testing.assert_allclose(y, want_y, **TOL)
    assert meta["warnings"] == []


def test_nondivisible_batch_warns_and_replicates(runs):
    data, cases, ranks, _ = runs
    want_l, _, _, _, _ = _jax_run(cases["oracle13"], data, comm_mode=None)
    for r in (0, 1):
        losses = ranks[r][0]["oracle13/losses"]
        meta = ranks[r][1]["oracle13"]
        assert any("not divisible by dp" in w for w in meta["warnings"])
        np.testing.assert_allclose(losses, want_l, rtol=1e-5)


def _hold(runs, name, quantized):
    data, cases, ranks, _ = runs
    c = cases[name]
    want_l, want_p, want_y, _, jex = _jax_run(c, data)
    losses, params, y, meta = _port(ranks, name)
    assert sorted(params) == sorted(want_p)
    assert y.shape == want_y.shape
    if not quantized:
        np.testing.assert_allclose(losses, want_l, **TOL)
        for k in want_p:
            np.testing.assert_allclose(params[k], want_p[k], **TOL,
                                       err_msg=k)
        return meta, jex
    np.testing.assert_allclose(losses, want_l, **LOSS_TOL_Q)
    # the flip bound (module docstring), from the unquantized gradient
    _, _, _, grads, _ = _jax_run(dict(c, quant="off"), data)
    for k in want_p:
        if c["opt"] == "sgd":
            scale = 2 * max(np.abs(g[k]).max() for g in grads) / Q[c["quant"]]
            bound = c["steps"] * c["lr"] * scale
        else:
            bound = c["steps"] * c["lr"]
        err = np.abs(params[k] - want_p[k])
        assert np.all(err <= bound + TOL["atol"] + TOL["rtol"]
                      * np.abs(want_p[k])), (k, err.max(), bound)
    return meta, jex


@pytest.mark.parametrize("name", ["sgd_off", "adam_off", "cnn_off"])
def test_unquantized_matches_jax_on_eight_devices(runs, name):
    meta, jex = _hold(runs, name, quantized=False)
    assert meta["qar"] == [] and meta["qresid"] == 0
    assert meta["report"] is None and jex.comm_quant_report is None


@pytest.mark.parametrize("name", ["sgd_int8", "sgd_int8_noef", "sgd_fp8",
                                  "adam_int8", "adam_fp8_noef", "cnn_int8",
                                  "cnn_fp8"])
def test_quantized_matches_jax_on_eight_devices(runs, name):
    meta, jex = _hold(runs, name, quantized=True)
    want_q = [n.param_node.name for n in jex.qar_ops]
    assert meta["qar"] == want_q and len(want_q) == 3
    assert meta["qresid"] == len(jex.state["qresid"])
    report = dict(jex.comm_quant_report, dp=2)   # two ranks, eight devices
    assert meta["report"] == report


@pytest.mark.parametrize("name", ["sgd_int8", "sgd_fp8", "adam_fp8_noef"])
def test_grouped_all_reduce_equals_the_per_op_path(runs, name):
    """The executor's one group per optimizer node (the three quantized
    weights) against each marked op alone through quantized_allreduce,
    a group of one each: bit for bit at two gloo ranks."""
    _, _, ranks, _ = runs
    l_g, p_g, y_g, m_g = _port(ranks, name)
    l_o, p_o, y_o, m_o = _port(ranks, name + "_per_op")
    assert m_g["grouped"] == [3] and m_o["grouped"] == []
    np.testing.assert_array_equal(l_g, l_o)
    np.testing.assert_array_equal(y_g, y_o)
    assert sorted(p_g) == sorted(p_o)
    for k in p_g:
        np.testing.assert_array_equal(p_g[k], p_o[k], err_msg=k)


def test_a_node_whose_marked_op_another_node_reads_is_not_grouped(tmp_path):
    """At a gloo world of one: the optimizer node's three marked inputs run
    as one group; where another node of the target also reads one of them
    (a norm of an all-reduced gradient), that node's marked ops are
    computed one by one in the walk, with the same values."""
    import hetu_tpu_torch as pt
    from hetu_tpu_torch.parallel import multihost
    data = _data()
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        kw = dict(ctx=pt.cpu(0), seed=0, comm_mode="AllReduce",
                  mesh=multihost.global_mesh(1), comm_quant="int8",
                  comm_quant_min_size=1024)
        x, y_, _, loss, op = build(pt, "mlp", "sgd", 0.05)
        feed = {x: data["mlp_x"], y_: data["mlp_y"]}
        grouped = pt.Executor({"train": [loss, op]}, **kw)
        sub = grouped.subexecutors["train"]
        assert [len(ops) for ops, _ in sub.qar_groups.values()] == [3]
        norm = pt.reduce_sum_op(op.inputs[0] * op.inputs[0], [0, 1])
        alone = pt.Executor({"train": [loss, op, norm]}, **kw)
        sub = alone.subexecutors["train"]
        assert sub.qar_groups == {} and sub.qar_deferred == set()
        for _ in range(2):
            want = grouped.run("train", feed_dict=feed,
                               convert_to_numpy_ret_vals=True)
            got = alone.run("train", feed_dict=feed,
                            convert_to_numpy_ret_vals=True)
            np.testing.assert_array_equal(got[0], want[0])
        for n in grouped.param_nodes:
            np.testing.assert_array_equal(
                alone.state["params"][id(n)].numpy(),
                grouped.state["params"][id(n)].numpy())
    finally:
        multihost.shutdown()


def test_load_mid_run_continues_as_an_uninterrupted_run(runs):
    """An int8 executor with error feedback that took two steps of its own
    loads the checkpoint of another run's first step (parameters and the
    residuals, copied into its live residual views) and takes two more:
    bit for bit the uninterrupted run's last two steps."""
    _, _, ranks, _ = runs
    l_u, p_u, y_u, _ = _port(ranks, "sgd_int8")
    l_r, p_r, y_r, m_r = _port(ranks, "sgd_int8_resumed")
    assert m_r["qresid"] == 3
    np.testing.assert_array_equal(l_r, l_u[1:])
    np.testing.assert_array_equal(y_r, y_u)
    for k in p_u:
        np.testing.assert_array_equal(p_r[k], p_u[k], err_msg=k)


def test_off_mode_is_the_default_bit_for_bit_and_int8_engages(runs):
    """Port of test_comm_quant.py:136."""
    _, _, ranks, _ = runs
    l_def, p_def, _, m_def = _port(ranks, "sgd_default")
    l_off, p_off, _, m_off = _port(ranks, "sgd_off")
    np.testing.assert_array_equal(l_def, l_off)
    for k in p_def:
        np.testing.assert_array_equal(p_def[k], p_off[k])
    assert m_off["qar"] == [] and m_off["qresid"] == 0
    assert m_off["report"] is None
    _, p_q, _, m_q = _port(ranks, "sgd_int8")
    assert m_q["qar"] and m_q["qresid"]
    assert any(not np.array_equal(p_def[k], p_q[k]) for k in p_def)


def test_shared_graph_off_after_int8_stays_exact(runs):
    """Port of test_comm_quant.py:175: an off executor over a graph that an
    int8 executor marked runs the exact path, equal to a fresh graph's."""
    _, _, ranks, _ = runs
    l_shared, p_shared, _, m_shared = _port(ranks, "shared_off")
    assert ranks[0][1]["shared_off_marker"]["marks"] == 3
    assert m_shared["marks"] == 0 and m_shared["qar"] == []
    l_ref, p_ref, _, _ = _port(ranks, "sgd_off")
    np.testing.assert_array_equal(l_shared, l_ref)
    for k in p_ref:
        np.testing.assert_array_equal(p_shared[k], p_ref[k])


def test_a_batch_false_feed_is_never_cut(runs):
    data, _, ranks, _ = runs
    x, y_, y, _, _ = build(jt, "oracle", "sgd", 0.1, data["oracle_w"])
    off = jt.Variable(name="offset", trainable=False, batch=False)
    shifted = jt.reduce_mean_op(jt.softmaxcrossentropy_op(
        y + jt.broadcastto_op(off, y), y_), [0])
    ex = jt.Executor({"f": [shifted]}, ctx=jt.cpu(0))
    (want,) = ex.run("f", feed_dict={x: data["o64_x"], y_: data["o64_y"],
                                     off: data["offset"]},
                     convert_to_numpy_ret_vals=True)
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["batch_false/offset"],
                                      2 * data["offset"])
        np.testing.assert_allclose(arrays["batch_false/loss"], want, **TOL)


def test_the_worlds_host_helpers(runs):
    _, _, ranks, _ = runs
    for r, (_, meta) in enumerate(ranks):
        assert meta["world"] == {"index": r, "count": 2,
                                 "gathered": [[0, 10], [1, 11]],
                                 "chief": {"rank": 0, "seed": 7}}


def test_transfer_markers_are_identities():
    import hetu_tpu_torch as pt
    x = pt.Variable(name="x", trainable=False)
    out = pt.relu_op(pt.datad2h_op(pt.datah2d_op(x)))
    v = np.array([[-1.0, 2.0]], np.float32)
    (got,) = pt.Executor([out], ctx=pt.cpu(0)).run(
        feed_dict={x: v}, convert_to_numpy_ret_vals=True)
    np.testing.assert_array_equal(got, np.maximum(v, 0))


def test_a_fetch_the_rule_cannot_place_raises_naming_it(runs):
    _, _, ranks, _ = runs
    for _, meta in ranks:
        assert "Gradient(w)" in meta["bad_fetch"]
        assert "batch-major" in meta["bad_fetch"]


def test_small_params_exempt_by_threshold(runs):
    """Port of test_comm_quant.py:216: every parameter of the width-32 MLP
    is below the 2048 threshold, so int8 quantizes nothing."""
    _, _, ranks, _ = runs
    meta = ranks[0][1]["small"]
    assert meta["qar"] == [] and meta["qresid"] == 0


def _qresid(path):
    import pickle
    with open(os.path.join(path, "executor_state.pkl"), "rb") as f:
        return pickle.load(f)["qresid"]


def test_qresid_checkpoint_moves_between_the_packages(runs):
    data, cases, ranks, tmp = runs
    # the port's residuals, in the reference's layout, read by hetu_tpu
    port = _qresid(tmp / "port_ckpt")
    c = cases["sgd_int8"]
    _, _, _, _, jex = _jax_run(dict(c, init=None, steps=0), data)
    jex.load(str(tmp / "port_ckpt"))
    shapes = [np.asarray(jex.state["params"][id(n.param_node)]).shape
              for n in jex._qresid_ordered()]
    assert len(port) == 3 and shapes
    for i, n in enumerate(jex._qresid_ordered()):
        assert port[str(i)].shape == shapes[i]
        assert port[str(i)].dtype == np.float32
        np.testing.assert_array_equal(np.asarray(jex.state["qresid"][id(n)]),
                                      port[str(i)])
    assert any(np.abs(v).max() > 0 for v in port.values())
    # hetu_tpu's residuals read by the port's two ranks (each its shard)
    # and written back: the same values
    want, back = _qresid(tmp / "jax_ckpt"), _qresid(tmp / "port_resave")
    assert sorted(want) == sorted(back) and want
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]))


def test_runner_trains_the_cnn_example_on_two_cpu_ranks():
    """The port's CNN example under the port's runner, two gloo ranks, 3
    steps: rank 0 alone logs, and its loss is local mode's from the same
    seed."""
    args = ["-m", "hetu_tpu_torch.examples.cnn_main", "--model", "mlp",
            "--dataset", "CIFAR10", "--gpu", "-1", "--num-epochs", "0",
            "--steps", "3", "--seed", "0"]
    dp = subprocess.Popen(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-w", "2",
         sys.executable, *args, "--comm-mode", "AllReduce"],
        env=port_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    local = subprocess.run([sys.executable, *args], env=port_env(),
                           cwd=REPO, capture_output=True, text=True,
                           timeout=300)
    out = dp.communicate(timeout=300)[0]
    assert dp.returncode == 0 and local.returncode == 0, out + local.stderr

    def values(text, what):
        return [float(ln.split(" = ")[1]) for ln in text.splitlines()
                if what in ln]
    got = [values(out, w) for w in ("Train loss", "Train accuracy")]
    want = [values(local.stderr, w) for w in ("Train loss",
                                               "Train accuracy")]
    assert len(got[0]) == len(got[1]) == 1, out          # rank 0 only
    # the mean of the two ranks' batch means against the batch mean: f32
    # rounding; the accuracy within one of the 3 x 128 predictions
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=out)
    np.testing.assert_allclose(got[1], want[1], atol=1 / 384 + 1e-6,
                               err_msg=out)


def test_runner_exits_with_a_failing_workers_code(tmp_path):
    cfg = tmp_path / "w2.yml"
    cfg.write_text("nodes:\n  - host: localhost\n    workers: 2\n"
                   "    chief: true\n")
    script = ("import os, sys, time\n"
              "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(60)")
    p = subprocess.run([sys.executable, "-m", "hetu_tpu_torch.runner", "-c",
                        str(cfg), sys.executable, "-c", script],
                       env=port_env(), cwd=REPO, capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 3, p.stderr
    p = subprocess.run([sys.executable, "-m", "hetu_tpu_torch.runner", "-w",
                        "2", sys.executable, "-c",
                        "import os; assert os.environ['WORLD_SIZE'] == '2'"
                        "; assert os.environ['HETU_INIT_METHOD']"],
                       env=port_env(), cwd=REPO, capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 0, p.stderr


def test_unported_modes_raise_naming_their_slice(tmp_path):
    import hetu_tpu_torch as pt
    from hetu_tpu_torch import runner
    for mode, slice_ in (("PS", "4b"), ("Hybrid", "4b")):
        _, _, _, loss, op = build(pt, "mlp32", "sgd", 0.1)
        with pytest.raises(NotImplementedError, match=f"slice {slice_}"):
            pt.Executor({"train": [loss, op]}, ctx=pt.cpu(0), comm_mode=mode)
    _, _, _, loss, op = build(pt, "mlp32", "sgd", 0.1)
    with pytest.raises(NotImplementedError, match="slice 8"):
        pt.Executor({"train": [loss, op]}, ctx=pt.cpu(0), gpipe=True)
    with pytest.raises(NotImplementedError, match="slice 8"):
        pt.dispatch(loss, (2, 1))
    with pytest.raises(NotImplementedError, match="slice 8"):
        pt.groupallreduceCommunicate_op(loss, group=[0, 1])
    with pytest.raises(NotImplementedError, match="slice 9"):
        runner.main(["-w", "2", "--elastic", "true"])
    with pytest.raises(NotImplementedError, match="slice 10"):
        runner.main(["-w", "2", "--telemetry-dir", str(tmp_path), "true"])
    cfg = tmp_path / "ps.yml"
    cfg.write_text("nodes:\n  - host: localhost\n    servers: 1\n"
                   "    workers: 1\n")
    with pytest.raises(NotImplementedError, match="slice 4b"):
        runner.main(["-c", str(cfg), "true"])
    # without a process group, AllReduce is local mode (no mesh deduced)
    ex = pt.Executor({"train": [loss, op]}, ctx=pt.cpu(0),
                     comm_mode="AllReduce", comm_quant="int8",
                     comm_quant_min_size=1)
    assert ex.config.mesh is None and ex.config.dp_size == 1
    assert ex.qar_ops == [] and ex.comm_quant_report is None
