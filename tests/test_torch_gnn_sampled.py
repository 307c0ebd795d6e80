"""hetu_tpu_torch's sampled-subgraph GCN over the parameter server and the
embedding cache (``examples/gnn_sampled.py``) and its ``GNNDataLoaderOp``,
against the JAX package, on the CPU.

- ``GNNDataLoaderOp``'s double buffering rotates as the JAX class does
  (``_cur``/``_next``, ``get_batch``, ``get_cur_shape``, ``close``), and
  the executor feeds its current batch, on the executor's device, each
  step.
- ``make_graph`` and ``SubgraphSampler``'s batches are bit-equal to
  ``examples/gnn/run_sampled.py``'s for one seed (the script loaded by
  its path, under a name of its own).
- One worker against one server: the port's ``train`` from the JAX run's
  initial weights, on a table the server draws from the same seed, gives
  the JAX ``run_sampled.train``'s first 3 step losses within rel 1e-5,
  and its epoch means within rel 1e-5 (both runs pull, step and push in
  the same order, so the cache's staleness is the same).
- Two port workers under the port's runner share one table and both
  learn, as ``tests/test_gnn_sampled.py`` asserts of the JAX package.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu.dataloader import GNNDataLoaderOp as JaxGNNLoader
from hetu_tpu_torch.dataloader import GNNDataLoaderOp
from hetu_tpu_torch.examples import gnn_sampled
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_gnn_sampled.py's arguments
SMALL = ["--nodes", "256", "--nseed", "16", "--nmax", "64", "--hidden", "16",
         "--cpu", "--learning-rate", "0.08"]
ARGS = SMALL + ["--num-epoch", "6"]


def _run_sampled():
    """``examples/gnn/run_sampled.py`` as a module of its own name."""
    name = "reference_run_sampled"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, "examples", "gnn", "run_sampled.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


# ---------------------------------------------------------------------------
# GNNDataLoaderOp
# ---------------------------------------------------------------------------

def _counter():
    n = [0]

    def handler(graph):
        n[0] += 1
        return np.full((2, 3), n[0], np.float32)
    return handler


def test_gnn_loader_rotates_as_the_jax_class():
    ops = [cls(_counter()) for cls in (GNNDataLoaderOp, JaxGNNLoader)]
    try:
        for op in ops:
            assert op.is_dataloader and op.get_batch("train") is None
            assert op.get_cur_shape("train") is None
            assert op.get_batch_num("train") is None
        GNNDataLoaderOp.step(None)      # the first batch into _next
        JaxGNNLoader.step(None)
        port, ref = ops
        assert port._cur is None and port.get_cur_shape("x") is None
        for _ in range(3):
            GNNDataLoaderOp.step(None)
            JaxGNNLoader.step(None)
            np.testing.assert_array_equal(port.get_batch("train"),
                                          ref.get_batch("train"))
            np.testing.assert_array_equal(port._next, ref._next)
            assert port.get_cur_shape("x") == ref.get_cur_shape("x") == (2, 3)
        assert float(ops[0].get_batch("t")[0, 0]) == 3.0
    finally:
        for op in ops:
            op.close()
            op.close()                  # closing twice is harmless
    assert ops[0] not in GNNDataLoaderOp._ops
    before = ops[0]._cur
    GNNDataLoaderOp.step(None)          # a closed op no longer rotates
    assert ops[0]._cur is before


def test_the_executor_feeds_the_current_batch_each_step():
    adj = GNNDataLoaderOp(_counter())
    try:
        x = pt.placeholder_op(name="x")
        y = pt.matmul_op(adj, x)
        ex = pt.Executor([y], ctx=pt.cpu(0))
        ones = np.ones((3, 1), np.float32)
        GNNDataLoaderOp.step(None)
        GNNDataLoaderOp.step(None)
        for want in (1.0, 2.0, 3.0):
            (out,) = ex.run("default", feed_dict={x: ones})
            assert out.handle.device.type == "cpu"
            np.testing.assert_array_equal(out.asnumpy(),
                                          np.full((2, 1), 3 * want))
            GNNDataLoaderOp.step(None)
        assert ex.get_batch_num("default") is None
    finally:
        adj.close()


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def test_graph_and_sampler_batches_are_the_references():
    ref = _run_sampled()
    args = gnn_sampled.parse_args(ARGS)
    adj, labels = gnn_sampled.make_graph(args.nodes, args.classes,
                                         args.degree)
    radj, rlabels = ref.make_graph(args.nodes, args.classes, args.degree)
    np.testing.assert_array_equal(labels, rlabels)
    assert len(adj) == len(radj)
    for a, b in zip(adj, radj):
        np.testing.assert_array_equal(a, b)
    s = gnn_sampled.SubgraphSampler(adj, labels, args.nseed, args.nmax,
                                    args.fanout, seed=100)
    r = ref.SubgraphSampler(radj, rlabels, args.nseed, args.nmax,
                            args.fanout, seed=100)
    for _ in range(20):                 # past one pass over the graph
        got, want = s.next(), r.next()
        assert sorted(got) == sorted(want) == ["adj", "ids", "y"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# one worker against the JAX run
# ---------------------------------------------------------------------------

def _jax_run(args, monkeypatch):
    """``run_sampled.train`` on a local cluster of one server: (initial
    weights, step losses, history)."""
    from hetu_tpu.ps.client import PSClient
    from hetu_tpu.ps.local_cluster import local_cluster
    ref = _run_sampled()
    seen = {}

    class Recording(jt.Executor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["init"] = {k: np.array(self.state["params"][id(n)])
                            for k, n in zip(self._param_file_names(),
                                            self.param_nodes)}
            seen["losses"] = []

        def run(self, *a, **kw):
            out = super().run(*a, **kw)
            seen["losses"].append(float(np.mean(out[0].asnumpy())))
            return out

    monkeypatch.setattr(jt, "Executor", Recording)
    with local_cluster(n_servers=1, n_workers=1):
        client = PSClient.from_env()
        try:
            history = ref.train(client, 0, args)
        finally:
            client.close()
    return seen["init"], np.array(seen["losses"]), np.array(history)


def test_one_worker_matches_the_jax_run(monkeypatch):
    args = gnn_sampled.parse_args(SMALL + ["--num-epoch", "2"])
    init, want, want_hist = _jax_run(args, monkeypatch)
    assert sorted(init) == ["w1", "w2"]
    from hetu_tpu_torch.ps.local_cluster import local_cluster
    from hetu_tpu_torch.ps import get_worker_communicate
    stats = {}
    with local_cluster(n_servers=1, n_workers=1):
        history = gnn_sampled.train(get_worker_communicate(), 0, args,
                                    init=init, stats=stats)
    got = np.array(stats["losses"])
    assert len(got) == len(want) == 2 * 256 // 16
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-5)
    np.testing.assert_allclose(np.array(history)[:, 0], want_hist[:, 0],
                               rtol=1e-5)
    assert stats["launches"] == [{}] * len(got)      # the CPU: no kernel
    assert not GNNDataLoaderOp._ops                  # the loader closed


# ---------------------------------------------------------------------------
# two workers on one table
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import json
    import sys
    from hetu_tpu_torch.examples import gnn_sampled
    from hetu_tpu_torch.ps.client import PSClient

    args = gnn_sampled.parse_args(json.loads(sys.argv[1]))
    client = PSClient.from_env()
    rank, nrank = client.rank, client.nrank
    try:
        history = gnn_sampled.train(client, rank, args)
    finally:
        client.close()
    with open(sys.argv[2] + "." + str(rank), "w") as f:
        json.dump({"history": history, "nrank": nrank}, f)
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "hetu_tpu")]
""")


def test_two_workers_on_a_shared_table_both_learn(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    cfg = tmp_path / "cluster.yml"
    cfg.write_text("nodes:\n  - host: localhost\n    servers: 1\n"
                   "    workers: 2\n    chief: true\n")
    out = str(tmp_path / "res")
    args = ARGS + ["--workers", "2", "--cache-perf"]
    p = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-c", str(cfg),
         sys.executable, str(script), json.dumps(args), out],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "cache miss rate" in p.stdout
    for rank in (0, 1):
        res = json.load(open(f"{out}.{rank}"))
        assert res["nrank"] == 2
        (first_loss, first_acc), (last_loss, last_acc) = (
            res["history"][0], res["history"][-1])
        assert len(res["history"]) == 6
        assert last_loss < first_loss * 0.8, (first_loss, last_loss)
        assert last_acc > max(0.5, first_acc), (first_acc, last_acc)
