"""hetu_tpu_torch's DistGCN (``parallel/distgcn.py``, ``examples/gnn_dist.py``)
and GCN's ``sparse_model`` against the JAX package, on the CPU.

- ``partition_adjacency`` equals the JAX function's, array for array.
- Eight gloo ranks (``python -c``, meeting at a ``file://`` store in
  ``tmp_path``, importing only the port) lay the grids ``(2, 2)``,
  ``(4, 2)`` and ``(8, 1)`` over their first ``gr * gc`` ranks, as
  ``tests/test_distgcn.py`` lays its meshes over the first devices, and
  run ``spmm_15d``, ``gcn_forward`` and the loss with both weights'
  gradients on ``tests/test_distgcn.py``'s 64-node graph (F = 8). Each
  rank's tensors are held against its device's shard of
  ``hetu_tpu.parallel.distgcn`` on the 8-device virtual mesh: its feature
  block equal, Z and the logits (row shard ``i``) within rtol 1e-5, the
  loss within rtol 1e-5 and the gradients within rtol 1e-4 / atol 1e-5
  (``tests/test_distgcn.py``'s): the local products sum in CSR chunk
  order, the JAX ones by ``segment_sum``.
- ``gnn_dist`` under the port's runner on two ranks (grid (1, 2)): 30
  epochs of ``run_dist.py``'s training, each epoch's loss against the
  same loop on the JAX mesh (1, 2) within rtol 1e-5.
- ``sparse_model`` (an embedding table before the GCN stack) 3 SGD steps
  against the JAX ``sparse_model`` of ``examples/gnn/gnn_model``, from the JAX
  executor's initial weights (``interop.params_from_numpy``): losses
  within rtol 1e-5, parameters within rtol 1e-4 / atol 1e-5.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import hetu_tpu as jt
from hetu_tpu.parallel import distgcn as jdist
import hetu_tpu_torch as pt
from hetu_tpu_torch import interop
from hetu_tpu_torch.examples import gnn_model
from hetu_tpu_torch.parallel import distgcn as tdist
from test_torch_gnn import _reference_gnn_model
from test_torch_quant_comm import port_env, run_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NODES, FDIM, HIDDEN, CLASSES = 64, 8, 16, 4
GRIDS = [(2, 2), (4, 2), (8, 1)]
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs():
    """``tests/test_distgcn.py``'s graph (seed 7) and inputs (seed 6)."""
    rng = np.random.RandomState(7)
    nnz = N_NODES * 4
    rows = rng.randint(0, N_NODES, nnz)
    cols = rng.randint(0, N_NODES, nnz)
    vals = rng.rand(nnz).astype(np.float32)
    rng = np.random.RandomState(6)
    h = rng.randn(N_NODES, FDIM).astype(np.float32)
    w1 = (rng.randn(FDIM, HIDDEN) * 0.3).astype(np.float32)
    w2 = (rng.randn(HIDDEN, CLASSES) * 0.3).astype(np.float32)
    labels = np.eye(CLASSES, dtype=np.float32)[
        rng.randint(0, CLASSES, N_NODES)]
    return dict(rows=rows, cols=cols, vals=vals, h=h, w1=w1, w2=w2,
                labels=labels)


WORKER = r'''
import sys
import numpy as np
import torch
from hetu_tpu_torch.parallel import distgcn, multihost

GRIDS = %r
d = np.load(sys.argv[1])
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 8, rank, device="cpu")
n = d["h"].shape[0]
out = {}
for gr, gc in GRIDS:
    grid = multihost.process_grid(gr, gc)
    if grid is None:
        continue
    key = "g%%dx%%d_" %% (gr, gc)
    adj, h = distgcn.shard_gcn_inputs(grid, d["rows"], d["cols"], d["vals"],
                                      d["h"], n)
    out[key + "h"] = h.numpy()
    out[key + "nnz"] = np.array(adj.csr.nnz)
    out[key + "z"] = distgcn.spmm_15d(grid, adj, h, n).numpy()
    ws = [torch.from_numpy(d[k]).requires_grad_() for k in ("w1", "w2")]
    logits = distgcn.gcn_forward(grid, adj, h, ws, n)
    nr = n // gr
    onehot = torch.from_numpy(d["labels"][grid.i * nr:(grid.i + 1) * nr])
    share = -(onehot * torch.log_softmax(logits, 1)).sum() / n
    g1, g2 = torch.autograd.grad(share, ws)
    loss = share.detach().clone()
    torch.distributed.all_reduce(loss, group=grid.col_group)
    out.update({key + "logits": logits.detach().numpy(),
                key + "loss": loss.numpy(), key + "g1": g1.numpy(),
                key + "g2": g2.numpy()})
multihost.shutdown()
np.savez(sys.argv[4], **out)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "hetu_tpu")]
''' % (GRIDS,)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distgcn")
    d = _inputs()
    np.savez(tmp / "in.npz", **d)
    return d, [dict(np.load(o))
               for o in run_ranks(tmp, WORKER, tmp / "in.npz", n=8)]


def _mesh(gr, gc):
    assert jax.device_count() == 8
    return Mesh(np.array(jax.devices()[:gr * gc]).reshape(gr, gc),
                ("gr", "gc"))


_JAX = {}


def _jax(d, gr, gc):
    """The JAX package's global Z, logits, loss and gradients on the
    (gr, gc) mesh."""
    if (gr, gc) not in _JAX:
        mesh = _mesh(gr, gc)
        adj, h = jdist.shard_gcn_inputs(mesh, d["rows"], d["cols"],
                                        d["vals"], d["h"], N_NODES)
        labels = jnp.asarray(d["labels"])

        def loss_fn(ws):
            logits = jdist.gcn_forward(mesh, adj, h, ws, N_NODES)
            logp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.sum(labels * logp, axis=1)), logits

        @jax.jit     # one compilation, not one per eager op
        def run(ws):
            return (jdist.spmm_15d(mesh, adj, h, N_NODES),
                    jax.value_and_grad(loss_fn, has_aux=True)(ws))

        z, ((loss, logits), grads) = run([jnp.asarray(d["w1"]),
                                          jnp.asarray(d["w2"])])
        _JAX[gr, gc] = dict(z=np.asarray(z), logits=np.asarray(logits),
                            loss=float(loss),
                            g1=np.asarray(grads[0]), g2=np.asarray(grads[1]))
    return _JAX[gr, gc]


def _points(gr, gc):
    """(rank, i, j) of every grid point."""
    return [(i * gc + j, i, j) for i in range(gr) for j in range(gc)]


@pytest.mark.parametrize("gr,gc", GRIDS)
def test_partition_adjacency_equals_the_jax_function(gr, gc):
    d = _inputs()
    want = jdist.partition_adjacency(d["rows"], d["cols"], d["vals"],
                                     N_NODES, gr, gc)
    got = tdist.partition_adjacency(d["rows"], d["cols"], d["vals"],
                                    N_NODES, gr, gc)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gr,gc", GRIDS)
def test_each_rank_holds_its_block_of_the_inputs(ranks, gr, gc):
    """The feature block gc-major over the grid (block j * gr + i); the
    adjacency block without padding: its entries are partition_adjacency's
    nonzero slots of (i, j)."""
    d, res = ranks
    nb = N_NODES // (gr * gc)
    vals, _, _ = jdist.partition_adjacency(d["rows"], d["cols"], d["vals"],
                                           N_NODES, gr, gc)
    for r, i, j in _points(gr, gc):
        b = j * gr + i
        np.testing.assert_array_equal(res[r][f"g{gr}x{gc}_h"],
                                      d["h"][b * nb:(b + 1) * nb])
        assert int(res[r][f"g{gr}x{gc}_nnz"]) == int((vals[i, j] != 0).sum())
    for r in range(gr * gc, 8):        # ranks outside the grid ran nothing
        assert f"g{gr}x{gc}_z" not in res[r]


@pytest.mark.parametrize("gr,gc", GRIDS)
def test_spmm_15d_matches_jax(ranks, gr, gc):
    d, res = ranks
    z = _jax(d, gr, gc)["z"]
    nr = N_NODES // gr
    for r, i, _ in _points(gr, gc):
        np.testing.assert_allclose(res[r][f"g{gr}x{gc}_z"],
                                   z[i * nr:(i + 1) * nr], **FWD_TOL)


@pytest.mark.parametrize("gr,gc", GRIDS)
def test_gcn_forward_matches_jax(ranks, gr, gc):
    d, res = ranks
    logits = _jax(d, gr, gc)["logits"]
    nr = N_NODES // gr
    for r, i, _ in _points(gr, gc):
        np.testing.assert_allclose(res[r][f"g{gr}x{gc}_logits"],
                                   logits[i * nr:(i + 1) * nr], **FWD_TOL)


@pytest.mark.parametrize("gr,gc", GRIDS)
def test_loss_and_weight_gradients_match_jax_grad(ranks, gr, gc):
    """Every rank holds the whole loss and both weights' whole gradients:
    summed once over the grid's row shards, not gc times."""
    d, res = ranks
    want = _jax(d, gr, gc)
    for r, _, _ in _points(gr, gc):
        np.testing.assert_allclose(float(res[r][f"g{gr}x{gc}_loss"]),
                                   want["loss"], rtol=1e-5)
        for k in ("g1", "g2"):
            np.testing.assert_allclose(res[r][f"g{gr}x{gc}_{k}"], want[k],
                                       **GRAD_TOL)


def _jax_run_dist(gr, gc, epochs, nodes=256, classes=4, hidden=32, lr=0.5):
    """``examples/gnn/run_dist.py``'s training loop on the JAX mesh
    (gr, gc) at its defaults: each epoch's loss."""
    ref = _reference_gnn_model()
    mesh = _mesh(gr, gc)
    n = nodes - nodes % (gr * gc)
    rows, cols, feats, labels = ref.synthetic_graph(n, classes)
    vals = ref.normalize_adj(rows, cols, n)
    onehot = jnp.asarray(ref.convert_to_one_hot(labels, classes))
    mask = jnp.asarray(
        (np.random.RandomState(1).rand(n) < 0.7).astype(np.float32))
    adj, h = jdist.shard_gcn_inputs(mesh, rows, cols, vals, feats, n)
    rng = np.random.RandomState(0)
    ws = [jnp.asarray(rng.randn(feats.shape[1], hidden) * 0.2, jnp.float32),
          jnp.asarray(rng.randn(hidden, classes) * 0.2, jnp.float32)]

    def loss_fn(ws):
        logits = jdist.gcn_forward(mesh, adj, h, ws, n)
        logp = jax.nn.log_softmax(logits)
        return jnp.mean(-jnp.sum(onehot * logp, axis=1) * mask)

    step = jax.jit(lambda ws: (lambda lg: (lg[0], [
        w - lr * g for w, g in zip(ws, lg[1])]))(
        jax.value_and_grad(loss_fn)(ws)))
    losses = []
    for _ in range(epochs):
        loss, ws = step(ws)
        losses.append(float(loss))
    return np.array(losses)


def test_gnn_dist_under_the_runner_on_two_ranks():
    p = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-w", "2",
         sys.executable, "-m", "hetu_tpu_torch.examples.gnn_dist",
         "--replication", "2", "--gpu", "-1"],
        cwd=REPO, env=port_env(), capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()
             if ln.startswith("{")]
    assert lines[0]["grid"] == {"gr": 1, "gc": 2}
    epochs, summary = lines[1:-1], lines[-1]
    assert len(epochs) == 30 and summary["grid"] == [1, 2]
    assert summary["launches_per_epoch"] == {}      # the CPU: no kernel
    got = np.array([e["loss"] for e in epochs])
    np.testing.assert_allclose(got, _jax_run_dist(1, 2, 30), rtol=1e-5)
    assert got[-1] < 0.5 * got[0] and epochs[-1]["test_acc"] > 0.9


# ---------------------------------------------------------------------------
# sparse_model: an embedding table before the GCN stack
# ---------------------------------------------------------------------------

SPARSE = dict(num_int_feature=3, hidden_layer_size=16, embedding_idx_max=40,
              embedding_width=4, num_classes=4, lr=0.5)


def _sparse_feeds(ref):
    rows, cols, _, labels = ref.synthetic_graph(N_NODES, 4)
    vals = ref.normalize_adj(rows, cols, N_NODES)
    rng = np.random.RandomState(3)
    index = rng.randint(0, SPARSE["embedding_idx_max"],
                        (N_NODES, SPARSE["num_int_feature"]))
    mask = (np.random.RandomState(1).rand(N_NODES) < 0.7).astype(np.float32)
    return rows, cols, vals, index.astype(np.float32), \
        ref.convert_to_one_hot(labels, 4), mask


def _sparse_run(ht, model, ctx, feeds, init=None):
    (loss, y, train_op), nodes = model.sparse_model(**SPARSE)
    ex = ht.Executor([loss, y, train_op], ctx=ctx, seed=0)
    if init is not None:
        interop.params_from_numpy(ex, init)
    start = {k: np.array(ex.state["params"][id(n)])
             for k, n in zip(ex._param_file_names(), ex.param_nodes)}
    rows, cols, vals, index, onehot, mask = feeds
    adj = ht.sparse_array(vals, (rows, cols), (N_NODES, N_NODES), ctx=ctx)
    feed = dict(zip(nodes, (index, onehot, mask, adj)))
    losses = [float(np.mean(ex.run("default", feed_dict=feed,
                                   convert_to_numpy_ret_vals=True)[0]))
              for _ in range(3)]
    end = {k: np.array(ex.state["params"][id(n)])
           for k, n in zip(ex._param_file_names(), ex.param_nodes)}
    return start, np.array(losses), end


def test_sparse_model_matches_the_jax_one():
    ref = _reference_gnn_model()
    feeds = _sparse_feeds(ref)
    start, want, want_end = _sparse_run(jt, ref, jt.cpu(0), feeds)
    assert sorted(start) == ["gcn1_bias", "gcn1_weight", "gcn2_bias",
                             "gcn2_weight", "gnn_embedding"]
    _, got, got_end = _sparse_run(pt, gnn_model, pt.cpu(0), feeds,
                                  init=start)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k in want_end:
        np.testing.assert_allclose(got_end[k], want_end[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the table learned: the rows the ids name moved, the others did not
    used = np.unique(feeds[3].astype(np.int64))
    moved = np.any(got_end["gnn_embedding"] != start["gnn_embedding"], 1)
    assert moved[used].all() and not moved[np.setdiff1d(
        np.arange(SPARSE["embedding_idx_max"]), used)].any()
