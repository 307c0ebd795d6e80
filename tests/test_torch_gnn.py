"""The GCN slice as a whole: ``examples/gnn/run_single.py``'s full-batch
training through hetu_tpu_torch against hetu_tpu, epoch for epoch, on the
CPU.

``run_single``'s defaults: the 256-node ``synthetic_graph`` (16 features,
4 classes), hidden 32, SGD at lr 0.5, 30 epochs, for GCN and SageConv.
Both packages build ``dense_model`` (the reference's from
``examples/gnn/gnn_model``, the port's copy in
``hetu_tpu_torch.examples.gnn_model``); the JAX executor's initial state
is written with its ``Executor.save`` and read into the port with
``Executor.load``. Per-epoch losses agree within rtol 1e-5 and the final
parameters within rtol 1e-4 / atol 1e-5: the sparse products sum in
another order (CSR order against ``segment_sum``) and so do the dense
ones (ATen against Eigen), and the difference compounds over 30 updates.
"""
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu_torch.examples import gnn_main, gnn_model
from hetu_tpu_torch.kernels import registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
EPOCHS, NODES, HIDDEN, CLASSES, LR = 30, 256, 32, 4, 0.5


def _reference_gnn_model():
    """``examples/gnn/gnn_model`` as a package of its own name, so that no
    other ``gnn_model`` on ``sys.path`` is shadowed."""
    path = os.path.join(REPO, "examples", "gnn", "gnn_model")
    name = "reference_gnn_model"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(path, "__init__.py"),
            submodule_search_locations=[path])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _run_single_inputs():
    """``run_single.py``'s graph, labels and mask."""
    ref = _reference_gnn_model()
    rows, cols, feats, labels = ref.synthetic_graph(NODES, CLASSES)
    vals = ref.normalize_adj(rows, cols, NODES)
    onehot = ref.convert_to_one_hot(labels, CLASSES)
    mask = (np.random.RandomState(1).rand(NODES) < 0.7).astype(np.float32)
    return rows, cols, vals, feats, onehot, mask


def _build(ht, models, arch, ctx):
    layer = getattr(models, arch)
    [loss, y, train_op], [feat_, y__, mask_, adj_] = models.dense_model(
        16, HIDDEN, CLASSES, LR, arch=layer)
    ex = ht.Executor([loss, y, train_op], ctx=ctx, seed=0)
    return ex, (feat_, y__, mask_, adj_)


def _train(ht, ex, nodes, inputs, ctx):
    rows, cols, vals, feats, onehot, mask = inputs
    feat_, y__, mask_, adj_ = nodes
    adj = ht.sparse_array(vals, (rows, cols), (NODES, NODES), ctx=ctx)
    losses = []
    for _ in range(EPOCHS):
        lv, yv, _ = ex.run("default", feed_dict={
            feat_: feats, y__: onehot, mask_: mask, adj_: adj},
            convert_to_numpy_ret_vals=True)
        losses.append(float(np.mean(lv)))
    return np.array(losses), yv


def _params(ex, to_np):
    return {name: to_np(ex.state["params"][id(n)])
            for name, n in zip(ex._param_file_names(), ex.param_nodes)}


@pytest.mark.parametrize("arch", ["GCN", "SageConv"])
def test_run_single_matches_reference(arch, tmp_path):
    inputs = _run_single_inputs()
    jex, jnodes = _build(jt, _reference_gnn_model(), arch, jt.cpu(0))
    pex, pnodes = _build(pt, gnn_model, arch, pt.cpu(0))
    jex.save(str(tmp_path))          # state before epoch 1
    pex.load(str(tmp_path))
    treg.reset_stats()
    treg.reset_launch_counts()
    want, want_y = _train(jt, jex, jnodes, inputs, jt.cpu(0))
    got, got_y = _train(pt, pex, pnodes, inputs, pt.cpu(0))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[-1] < 0.5 * got[0]
    jp = _params(jex, np.asarray)
    pp = _params(pex, lambda t: t.detach().cpu().numpy())
    assert list(pp) == list(jp) == ["gcn1_weight", "gcn1_bias",
                                    "gcn2_weight", "gcn2_bias"]
    for name in jp:
        np.testing.assert_allclose(pp[name], jp[name], **STATE_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got_y, np.asarray(want_y), **STATE_TOL)
    assert pex.state["step"] == jex.state["step"] == EPOCHS
    # on the CPU every sparse product took the plain version: GCN runs the
    # spmm twice forward and once backward an epoch, SageConv likewise; the
    # four parameters are applied as one group an epoch
    assert treg.launch_counts() == dict.fromkeys(treg.launch_counts(), 0)
    assert treg.dispatch_stats() == {("csr_spmm", "plain"): 3 * EPOCHS,
                                     ("fused_sgd", "plain"): EPOCHS}


def test_the_ports_graph_builders_are_the_reference():
    ref = _reference_gnn_model()
    for got, want in zip(gnn_model.synthetic_graph(NODES, CLASSES),
                         ref.synthetic_graph(NODES, CLASSES)):
        np.testing.assert_array_equal(got, want)
    rows, cols, _, labels = ref.synthetic_graph(NODES, CLASSES)
    np.testing.assert_array_equal(gnn_model.normalize_adj(rows, cols, NODES),
                                  ref.normalize_adj(rows, cols, NODES))
    np.testing.assert_array_equal(gnn_model.convert_to_one_hot(labels),
                                  ref.convert_to_one_hot(labels))


def test_arxiv_graph_at_a_small_size():
    """The arxiv-sized generator, cut to 2,000 nodes: symmetric, self
    loops, the entry count, mostly same-class edges, seeded."""
    rows, cols, feats, labels = gnn_model.arxiv_graph(
        n_nodes=2000, n_edges=14000, n_classes=40, feat_dim=128, seed=3)
    assert rows.size == cols.size == 2 * 14000 + 2000
    assert feats.shape == (2000, 128) and feats.dtype == np.float32
    assert labels.min() >= 0 and labels.max() < 40
    np.testing.assert_array_equal(rows[14000:28000], cols[:14000])
    np.testing.assert_array_equal(rows[-2000:], np.arange(2000))
    assert rows.max() < 2000 and cols.max() < 2000
    assert 0.6 < (labels[rows[:14000]] == labels[cols[:14000]]).mean() < 0.8
    again = gnn_model.arxiv_graph(n_nodes=2000, n_edges=14000, seed=3)
    np.testing.assert_array_equal(again[0], rows)
    assert gnn_model.ARXIV == dict(n_nodes=169_343, n_edges=1_166_243,
                                   n_classes=40, feat_dim=128)


def test_gnn_main_trains_on_the_cpu_and_launches_nothing():
    rows = list(gnn_main.run("cpu", "gcn", "small", epochs=6))
    epochs, summary = rows[:-1], rows[-1]
    assert [r["epoch"] for r in epochs] == list(range(6))
    assert epochs[-1]["train_loss"] < epochs[0]["train_loss"]
    assert all(r["launches"] == {} for r in epochs)
    assert summary["nodes"] == NODES and summary["hidden"] == HIDDEN
    assert summary["launches_same_every_epoch"]
    tr = gnn_main.Trainer("cpu", "sage", "small")
    loss, grads = tr.gradients()
    assert sorted(grads) == ["gcn1_bias", "gcn1_weight", "gcn2_bias",
                             "gcn2_weight"]
    assert all(np.isfinite(g.numpy()).all() for g in grads.values())
    assert tr.ex.state["step"] == 0              # no update


def test_a_cpu_gcn_epoch_loads_neither_jax_nor_hetu_tpu():
    script = textwrap.dedent("""
        import sys
        from hetu_tpu_torch.examples import gnn_main
        rows = list(gnn_main.run("cpu", "gcn", "small", epochs=2))
        assert rows[1]["train_loss"] < rows[0]["train_loss"], rows
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


def parity_report():
    """The measured distances behind the tolerances above:
    ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_gnn.py``
    prints, per architecture, the max relative per-epoch loss difference
    and the max absolute difference of the final parameters."""
    import tempfile
    for arch in ("GCN", "SageConv"):
        inputs = _run_single_inputs()
        jex, jnodes = _build(jt, _reference_gnn_model(), arch, jt.cpu(0))
        pex, pnodes = _build(pt, gnn_model, arch, pt.cpu(0))
        with tempfile.TemporaryDirectory() as d:
            jex.save(d)
            pex.load(d)
        want, _ = _train(jt, jex, jnodes, inputs, jt.cpu(0))
        got, _ = _train(pt, pex, pnodes, inputs, pt.cpu(0))
        jp = _params(jex, np.asarray)
        pp = _params(pex, lambda t: t.detach().cpu().numpy())
        param = max(float(np.max(np.abs(pp[k] - jp[k]))) for k in jp)
        print(f"{arch:9s} loss {want[0]:.4f} -> {want[-1]:.4f}, loss max rel "
              f"{np.max(np.abs(got - want) / want):.2e}, params max abs "
              f"{param:.2e}")


if __name__ == "__main__":
    parity_report()
