"""The parameter server and the PS/Hybrid comm modes of hetu_tpu_torch
against hetu_tpu, on the CPU, over live local clusters.

- The PS wire: a port worker against a server built from the JAX
  package's sources, a JAX-package worker against a port server, each
  bit-equal to a port worker against a port server; and the two
  ``wire_constants`` modules, value for value.
- The runtime's host pieces: ``_dedup_sum_rows`` bit-equal to the JAX
  package's on a duplicate-heavy push; the learning-rate schedulers bit
  for bit at steps 0-50.
- Training: a narrow WDL-Criteo (vocabulary 1,000, embedding 16, MLP
  13-32-32, batch 16, SGD lr 0.01) 10 steps under Hybrid and under PS in
  each package, with prefetch off and with BSP + prefetch, and with the
  ``LFUOpt`` cache. Each package runs against its own cluster; the tables
  are initialized on the servers from the same seed and ps ids, and are
  held bit-equal by pulling all their rows; the dense parameters of
  Hybrid cross with ``Executor.save``/``load``. Losses agree within rtol
  1e-5, the final table rows (pulled) and dense parameters within rtol
  1e-4 / atol 1e-5, as ``test_torch_ctr.py``'s AllReduce parity: the
  products sum in another order (ATen against Eigen) and the difference
  compounds over the steps.
- The rows route: an explicit ``embedding_lookup_gradient_op`` pushed to
  the PS takes ``fused_embed_grad``'s compact form (the mirror of
  ``tests/test_kernels.py::test_ps_push_rows_route``).
"""
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import hetu_tpu as jt
from hetu_tpu.graph import ps_runtime as jps_runtime
from hetu_tpu.ps import local_cluster as jlc
from hetu_tpu.ps import wire_constants as jwire
import hetu_tpu_torch as pt
from hetu_tpu_torch.graph import ps_runtime as tps_runtime
from hetu_tpu_torch.kernels import registry as treg
from hetu_tpu_torch.ps import local_cluster as tlc
from hetu_tpu_torch.ps import wire_constants as twire
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
VOCAB, EMB, BATCH, STEPS, LR, SLOTS = 1000, 16, 16, 10, 0.01, 26
SEED = 42


def port_env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


PS_ENV = ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
          "DMLC_NUM_SERVER", "DMLC_ROLE", "WORKER_ID")


@pytest.fixture
def clean_ps_env(monkeypatch):
    """No cluster in the environment, and none left behind: the JAX
    package's ``local_cluster`` leaves its ``DMLC_*`` variables set."""
    for k in PS_ENV:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)


@pytest.fixture(scope="module")
def reference_lib(tmp_path_factory):
    """The JAX package's PS library, built from its own sources
    (``hetu_tpu/csrc``, with its build's flags) into a directory of this
    module's, while the port builds its own: ``hetu_tpu/csrc/build/`` is
    for the JAX package's tests to build, and two builders of one file
    would race."""
    from hetu_tpu.csrc import build as jbuild
    from hetu_tpu_torch.ps import _build as tbuild
    out = str(tmp_path_factory.mktemp("reference_ps") / "libhetu_ps.so")
    srcs = [os.path.join(jbuild._CSRC, s)
            for s in jbuild._TARGETS["libhetu_ps.so"]["srcs"]]
    proc = subprocess.Popen(["g++", "-std=c++17", "-O2", "-fPIC", "-shared",
                             "-pthread", "-I", jbuild._CSRC, "-o", out,
                             *srcs], stderr=subprocess.PIPE, text=True)
    tbuild.build()
    _, err = proc.communicate()
    assert proc.returncode == 0, err
    return out


@pytest.fixture
def reference_ps(reference_lib, monkeypatch):
    """The JAX package's PS modules load ``reference_lib``."""
    import hetu_tpu.cstable as jcstable
    import hetu_tpu.csrc.build as jbuild
    import hetu_tpu.ps.client as jclient
    import hetu_tpu.ps.server as jserver
    for mod in (jbuild, jclient, jcstable, jserver):
        monkeypatch.setattr(mod, "build", lambda name: reference_lib)
    monkeypatch.setattr(jcstable, "_lib", None)
    monkeypatch.setattr(jserver, "_lib", None)
    return reference_lib


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _constants(mod) -> dict:
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and not callable(v)
            and not isinstance(v, type(os))}


def test_wire_constants_equal_the_reference():
    """Value for value, the kQI8 quantized wire's flag and block
    included; a header struct by its format."""
    want, got = _constants(jwire), _constants(twire)
    assert sorted(got) == sorted(want)
    assert {"FLAG_QUANT_RSP", "QUANT_WIRE_BLOCK", "MSG_HDR"} <= set(got)
    for n, v in want.items():
        if isinstance(v, struct.Struct):
            assert (got[n].format, got[n].size) == (v.format, v.size), n
        else:
            assert got[n] == v, n
    assert twire.unpack_fields(("a", "b"), [3, 4]) == \
        jwire.unpack_fields(("a", "b"), [3, 4])


# the same requests through either package's client; ``PSClient`` is the
# client class, ``out`` the .npz to write
OPS = """
import numpy as np
c = PSClient()
c.InitTensor(0, 1, 64, 8, "normal", 0.0, 0.1, seed=7)
c.InitTensor(1, 0, 20, 1, "uniform", -0.5, 0.5, seed=9)
rows0 = c.SparsePull(0, np.arange(64), np.zeros((64, 8), np.float32))
c.Wait(0)
vals = np.linspace(-1, 1, 4 * 8, dtype=np.float32).reshape(4, 8)
c.SparsePush(0, np.array([3, 5, 3, 60]), vals)
c.Wait(0)
rows1 = c.SparsePull(0, np.arange(64), np.zeros((64, 8), np.float32))
c.Wait(0)
dense = c.DDPushPull(1, np.full(20, 0.25, np.float32),
                     np.zeros(20, np.float32))
c.Wait(1)
c.BarrierWorker()
np.savez(out, rows0=rows0, rows1=rows1, dense=dense)
c.close()
"""


def _roles(lc, stopdir):
    """A scheduler and one server of ``lc``'s package (the port's or the
    JAX package's ``local_cluster`` module), for one worker."""
    base = tlc.ps_env(tlc.free_port(), 1, 1)
    procs = [lc.spawn_light_role("scheduler", base),
             lc.spawn_light_server(0, base, os.path.join(stopdir, "stop"))]
    return base, procs


def _port_worker(base, out):
    script = ("from hetu_tpu_torch.ps.client import PSClient\n"
              f"out = {str(out)!r}\n" + OPS
              + "import sys\nassert not [m for m in sys.modules if "
              "m.split('.')[0] in ('jax', 'hetu_tpu')]\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=port_env(**base, DMLC_ROLE="worker",
                                    WORKER_ID="0"),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    return dict(np.load(out))


def _cluster_run(lc, worker, tmp_path, name):
    stopdir = tmp_path / f"stop_{name}"
    stopdir.mkdir()
    base, procs = _roles(lc, str(stopdir))
    try:
        return worker(base, str(tmp_path / f"{name}.npz"))
    finally:
        with open(stopdir / "stop", "w") as f:
            f.write("stop")
        tlc.reap_light_procs(procs)


def _reference_worker(base, out, monkeypatch):
    """The JAX package's client in this process, against ``base``."""
    from hetu_tpu import ps as jps
    from hetu_tpu.ps.client import PSClient
    for k, v in {**base, "DMLC_ROLE": "worker", "WORKER_ID": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        exec(OPS, {"PSClient": PSClient, "out": out})
    finally:
        jps._worker = None
    return dict(np.load(out))


def test_reference_sources_are_the_ports(reference_ps):
    """The port's C++ is the JAX package's, file for file: the two speak
    one protocol by construction, which the interop test checks live."""
    from hetu_tpu.csrc import build as jbuild
    from hetu_tpu_torch.ps import _build as tbuild
    spec = jbuild._TARGETS["libhetu_ps.so"]
    assert sorted(spec["srcs"] + spec["deps"]) == sorted(
        tbuild.SOURCES + tbuild.HEADERS)
    for rel in tbuild.SOURCES + tbuild.HEADERS:
        with open(os.path.join(jbuild._CSRC, rel), "rb") as a, \
                open(os.path.join(tbuild.CSRC, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_ps_wire_interop_both_ways(tmp_path, monkeypatch, reference_ps,
                                   clean_ps_env):
    port_port = _cluster_run(tlc, _port_worker, tmp_path, "port_port")
    port_ref = _cluster_run(jlc, _port_worker, tmp_path, "port_ref")
    ref_port = _cluster_run(
        tlc, lambda b, o: _reference_worker(b, o, monkeypatch), tmp_path,
        "ref_port")
    for got in (port_ref, ref_port):
        for k in ("rows0", "rows1", "dense"):
            assert np.array_equal(got[k], port_port[k]), k
    # the push reached the server: rows 3 (twice), 5 and 60 moved
    moved = np.flatnonzero((port_port["rows1"] != port_port["rows0"]).any(1))
    assert moved.tolist() == [3, 5, 60]


# ---------------------------------------------------------------------------
# host pieces of the runtime
# ---------------------------------------------------------------------------

def test_dedup_sum_rows_is_the_references_bit_for_bit():
    rng = np.random.RandomState(0)
    # duplicate-heavy (tests/test_kernels.py's case): 5000 rows, ~40 ids
    flat_idx = (rng.zipf(1.2, 5000) % 40).astype(np.int64)
    g = rng.randn(5000, 16).astype(np.float32)
    want_idx, want = jps_runtime._dedup_sum_rows(flat_idx, g)
    got_idx, got = tps_runtime._dedup_sum_rows(flat_idx, g)
    assert got.dtype == np.float32
    assert np.array_equal(got_idx, want_idx)
    assert np.array_equal(got, want)
    # no duplicates: the inputs pass through
    ni = np.arange(8, dtype=np.int64)
    ng = rng.randn(8, 16).astype(np.float32)
    oi, og = tps_runtime._dedup_sum_rows(ni, ng)
    assert oi is ni and og is ng


SCHEDULERS = [
    ("FixedScheduler", (0.1,), {}),
    ("StepScheduler", (0.1, 7), dict(gamma=0.5)),
    ("MultiStepScheduler", (0.1, [5, 12, 30]), dict(gamma=0.3)),
    ("ExponentialScheduler", (0.05,), dict(gamma=0.93)),
    ("CosineScheduler", (0.1, 40), dict(ending=0.001, warmup_steps=5)),
    ("ReduceOnPlateauScheduler", (0.1,), dict(patience=2, cooldown=1)),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULERS,
                         ids=[s[0] for s in SCHEDULERS])
def test_lr_scheduler_matches_the_reference(name, args, kw):
    import jax.numpy as jnp
    from hetu_tpu import lr_scheduler as jlr
    from hetu_tpu_torch import lr_scheduler as tlr
    js, ts = getattr(jlr, name)(*args, **kw), getattr(tlr, name)(*args, **kw)
    jopt = jt.optim.SGDOptimizer(learning_rate=js)
    topt = pt.optim.SGDOptimizer(learning_rate=ts)
    for step in range(51):
        want = float(js.get_traced(jnp.asarray(step, jnp.int32)))
        assert ts.get_traced(step) == want, step
        assert topt.lr_value(step) == float(jopt.lr_value(
            jnp.asarray(step, jnp.int32))), step
        if name == "ReduceOnPlateauScheduler":
            v = 1.0 / (1 + step % 4)
            assert ts.step(v) == js.step(v), step
        else:
            assert ts.get() == js.get(), step
            assert ts.step() == js.step(), step


def test_scheduled_sgd_reads_the_rate_of_each_step():
    """A scheduler drives the fused SGD group through the rate tensor,
    written only when the rate changes."""
    sched = pt.lr.StepScheduler(0.1, 2, gamma=0.5)
    opt = pt.optim.SGDOptimizer(learning_rate=sched)
    import torch
    p = torch.ones(4)
    g = torch.ones(4)
    for step in range(5):
        want = p - torch.tensor(sched.get_traced(step)) * g
        opt.apply_group([p], [g], [()], step)
        assert torch.equal(p, want), step
    assert float(opt.lr_tensor(p.device, 4)) == sched.get_traced(4)
    with pytest.raises(TypeError, match="scheduler"):
        pt.optim.SGDOptimizer(learning_rate="0.1")


# ---------------------------------------------------------------------------
# training parity: a narrow WDL-Criteo through both packages
# ---------------------------------------------------------------------------

def narrow_wdl(ht, dense, sparse, y_):
    """WDL-Criteo at narrow widths, built alike in either package: one
    table of VOCAB x EMB over 26 slots, an MLP 13-32-32 over the dense
    fields, a final linear layer, BCE loss, SGD."""
    table = ht.init.random_normal([VOCAB, EMB], stddev=0.05,
                                  name="snd_order_embedding", is_embed=True,
                                  ctx=ht.cpu(0))
    emb = ht.array_reshape_op(ht.embedding_lookup_op(table, sparse),
                              (-1, SLOTS * EMB))
    x = dense
    for i, (a, b) in enumerate(((13, 32), (32, 32))):
        w = ht.init.random_normal([a, b], stddev=0.1, name=f"W{i + 1}")
        x = ht.relu_op(ht.matmul_op(x, w))
    w_out = ht.init.random_normal([SLOTS * EMB + 32, 1], stddev=0.05,
                                  name="W_out")
    y = ht.sigmoid_op(ht.matmul_op(ht.concat_op(emb, x, axis=1), w_out))
    loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y_), [0])
    return loss, ht.optim.SGDOptimizer(learning_rate=LR).minimize(loss), \
        table


def _criteo():
    from hetu_tpu_torch.examples import ctr_models
    return ctr_models.load_criteo_data(feature_dimension=VOCAB,
                                       n_train=STEPS * BATCH, n_test=16)[0]


def _train(ht, mode, opts, state_dir, load):
    """Build and train the narrow WDL in package ``ht`` against the live
    cluster; returns (initial table rows, losses, final rows, final dense
    params by name)."""
    dense, sparse, y = _criteo()
    loaders = [ht.dataloader_op([ht.Dataloader(x, BATCH, "train")])
               for x in (dense, sparse, y)]
    loss, train_op, table = narrow_wdl(ht, *loaders)
    ex = ht.Executor({"train": [loss, train_op]}, ctx=ht.cpu(0), seed=SEED,
                     comm_mode=mode, **opts)
    try:
        rt = ex.ps_runtime
        p = rt.params[id(table)]
        all_rows = np.arange(VOCAB, dtype=np.int64)
        if load:
            ex.load(state_dir)
        else:
            ex.save(state_dir)
        rows0 = rt.pull_sparse_rows(p, all_rows)
        losses = [float(np.mean(ex.run(
            "train", convert_to_numpy_ret_vals=True)[0]))
            for _ in range(STEPS)]
        ex.close()
        rows1 = rt.pull_sparse_rows(p, all_rows)
        dense_params = {}
        for node in ex.param_nodes:
            dense_params[node.name] = np.asarray(
                ex.fetch_dense_parameter_value([node])[0].asnumpy())
        for q in rt.params.values():
            if not q.sparse:
                dense_params[q.node.name] = rt.pull_dense_value(q)
        return rows0, np.array(losses), rows1, dense_params
    finally:
        ex.close()


CONFIGS = {
    "hybrid-sync": ("Hybrid", dict(prefetch=False)),
    "hybrid-bsp-prefetch": ("Hybrid", dict(bsp=True, prefetch=True)),
    "ps-sync": ("PS", dict(prefetch=False)),
    "ps-bsp-prefetch": ("PS", dict(bsp=True, prefetch=True)),
    "hybrid-lfuopt": ("Hybrid", dict(prefetch=False,
                                     cstable_policy="LFUOpt")),
    "ps-lfuopt": ("PS", dict(prefetch=False, cstable_policy="LFUOpt")),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_narrow_wdl_trains_as_the_reference(config, tmp_path, reference_ps,
                                            clean_ps_env):
    mode, opts = CONFIGS[config]
    state = str(tmp_path / "state")
    with jlc.local_cluster(n_servers=1):
        try:
            want = _train(jt, mode, opts, state, load=False)
        finally:
            jt.worker_finish()
    treg.reset_stats()
    with tlc.local_cluster(n_servers=1):
        got = _train(pt, mode, opts, state, load=True)
    rows0_w, losses_w, rows1_w, dense_w = want
    rows0_g, losses_g, rows1_g, dense_g = got
    assert np.array_equal(rows0_g, rows0_w)           # the same table
    assert np.isfinite(losses_g).all()
    np.testing.assert_allclose(losses_g, losses_w, **LOSS_TOL)
    np.testing.assert_allclose(rows1_g, rows1_w, **STATE_TOL)
    # the table's update itself, which is small beside the rows: within
    # 1e-3 of its largest entry
    delta_w, delta_g = rows1_w - rows0_w, rows1_g - rows0_g
    assert np.abs(delta_w).max() > 0
    np.testing.assert_allclose(delta_g, delta_w, rtol=0,
                               atol=1e-3 * np.abs(delta_w).max())
    assert sorted(dense_g) == sorted(dense_w) == ["W1", "W2", "W_out"]
    for name in dense_w:
        np.testing.assert_allclose(dense_g[name], dense_w[name], **STATE_TOL,
                                   err_msg=name)
    # no table gradient on the device: the lookups' row gradients were
    # pushed, so the segment sum never ran; under Hybrid the dense SGD
    # ran as one group a step
    stats = treg.dispatch_stats()
    assert ("fused_embed_grad", "plain") not in stats
    assert stats.get(("fused_sgd", "plain"), 0) == (
        STEPS if mode == "Hybrid" else 0)


# ---------------------------------------------------------------------------
# the rows route
# ---------------------------------------------------------------------------

def test_ps_push_rows_route(monkeypatch, clean_ps_env):
    vocab, dim = 50, 8
    with tlc.local_cluster(n_servers=1):
        table = pt.init.zeros((vocab, dim), name="emb_rows_route",
                              is_embed=True)
        idx = pt.Variable(name="idx", dtype=np.int64, trainable=False)
        vec = pt.Variable(name="vec", trainable=False)
        look = pt.embedding_lookup_op(table, idx)
        loss = pt.reduce_mean_op(look, [0, 1])
        g = pt.embedding_lookup_gradient_op(vec, idx, (vocab, dim))
        push = pt.parameterServerCommunicate_op(g, ps_id=table.name)
        ex = pt.Executor({"train": [loss, push]}, ctx=pt.cpu(0),
                         comm_mode="PS", seed=0, prefetch=False)
        try:
            assert g.rows_mode is True          # the rewire flipped it
            assert push.ps_param_node is table
            bi = np.array([3, 7, 3, 9], np.int64)     # row 3 twice
            bv = np.arange(4 * dim, dtype=np.float32).reshape(4, dim)
            treg.reset_stats()
            ex.run("train", feed_dict={idx: bi, vec: bv})
            # the compact form: one segment sum keyed by ranks
            assert treg.dispatch_stats() == {("fused_embed_grad", "plain"): 1}
            assert len(ex.subexecutors["train"].ps_comm_ops) == 1
            p = ex.ps_runtime.params[id(table)]
            got = ex.ps_runtime.pull_sparse_rows(
                p, np.array([3, 7, 9, 0], np.int64))
            # the server's prescaled SGD: w += -lr * (the rows' sum)
            lr = ex.ps_runtime._prescale_lr(0)
            np.testing.assert_allclose(got[0], -(bv[0] + bv[2]) * lr,
                                       rtol=1e-6)
            np.testing.assert_allclose(got[1], -bv[1] * lr, rtol=1e-6)
            np.testing.assert_allclose(got[2], -bv[3] * lr, rtol=1e-6)
            assert np.array_equal(got[3], np.zeros(dim, np.float32))

            # a gradient op with another consumer (an eval target that
            # needs the table shape) stays dense and is not pushed
            monkeypatch.setenv("HETU_PS_ID_BASE", "1000")
            table2 = pt.init.zeros((vocab, dim), name="emb_dense_kept",
                                   is_embed=True)
            idx2 = pt.Variable(name="idx2", dtype=np.int64, trainable=False)
            vec2 = pt.Variable(name="vec2", trainable=False)
            loss2 = pt.reduce_mean_op(pt.embedding_lookup_op(table2, idx2),
                                      [0, 1])
            g2 = pt.embedding_lookup_gradient_op(vec2, idx2, (vocab, dim))
            push2 = pt.parameterServerCommunicate_op(g2, ps_id=table2.name)
            ex2 = pt.Executor({"train": [loss2, g2, push2]}, ctx=pt.cpu(0),
                              comm_mode="PS", seed=0, prefetch=False)
            try:
                assert g2.rows_mode is False and push2.ps_param_node is None
                out2 = ex2.run("train", feed_dict={idx2: bi, vec2: bv})
                assert out2[1].asnumpy().shape == (vocab, dim)
                assert ex2.subexecutors["train"].ps_comm_ops == []
            finally:
                ex2.close()
            # a local executor of the same graph: the op the PS wiring
            # flipped comes back dense; one the caller flips stays in rows
            # mode
            pt.Executor([g], ctx=pt.cpu(0))
            assert g.rows_mode is False
            g.to_rows()
            pt.Executor([g], ctx=pt.cpu(0))
            assert g.rows_mode is True
        finally:
            ex.close()
