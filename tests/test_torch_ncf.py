"""hetu_tpu_torch's NCF (``examples/ncf.py``) against the JAX package's
``examples/rec``, on the CPU.

- ``getdata`` returns the reference's arrays, bit for bit, at the
  defaults and at ``tests/test_ctr_models.py``'s small size.
- ``neural_mf`` 10 local SGD steps (``test_ncf_trains``' data, batch 256,
  lr 0.3 and embedding stddev 0.3, so that the tables move) from the JAX
  executor's initial state (its ``Executor.save``, the port's ``load``):
  losses within rel 1e-5, parameters within atol 1e-6. The table
  gradients sum each id's rows in sorted order (the JAX side scatter-adds
  them in XLA's order), and the dense products sum in another order.
- One Hybrid run against a local cluster of one server (the tables on
  the server, prefetch off) against local mode from the same initial
  values: the losses and the tables' rows within rel 1e-5.
- ``ncf.main`` in local mode on the CPU.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import hetu_tpu as jt
from hetu_tpu_torch.examples import ncf
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_users=100, num_items=200, n_pos=2000)
MODEL = dict(learning_rate=0.3, embed_stddev=0.3)
BATCH, STEPS = 256, 10


def _reference(name):
    """``examples/rec/<name>.py`` as a module of its own name."""
    key = "reference_rec_" + name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REPO, "examples", "rec", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


@pytest.mark.parametrize("kw", [{}, SMALL], ids=["defaults", "small"])
def test_getdata_is_the_references(kw):
    got, want = ncf.getdata(**kw), _reference("movielens").getdata(**kw)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_executor(data):
    users, items, labels, nu, ni = data
    loaders = [jt.dataloader_op([jt.Dataloader(x, BATCH, "train")])
               for x in (users, items, labels)]
    loss, _, train_op = _reference("hetu_ncf").neural_mf(*loaders, nu, ni,
                                                         **MODEL)
    return jt.Executor({"train": [loss, train_op]}, ctx=jt.cpu(0), seed=42)


def _state(ex):
    return {k: np.array(ex.state["params"][id(n)], copy=True)
            for k, n in zip(ex._param_file_names(), ex.param_nodes)}


def test_ten_local_steps_match_the_jax_neural_mf(tmp_path):
    data = ncf.getdata(**SMALL)
    jex = _jax_executor(data)
    jex.save(str(tmp_path))            # the state before step 1
    want = [float(np.mean(jex.run("train", convert_to_numpy_ret_vals=True)[0]))
            for _ in range(STEPS)]
    tr = ncf.Trainer("cpu", data, BATCH, **MODEL)
    tr.ex.load(str(tmp_path))
    start = _state(tr.ex)
    got = [float(tr.step()[0].mean()) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_state, got_state = _state(jex), _state(tr.ex)
    assert sorted(got_state) == sorted(want_state) == [
        "W1", "W2", "W3", "W_out", "item_embed", "user_embed"]
    for k in want_state:
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert not np.array_equal(got_state[k], start[k]), k   # it trained


def test_hybrid_matches_local_mode():
    from hetu_tpu_torch.ps.local_cluster import local_cluster
    data = ncf.getdata(**SMALL)
    users, items = (data[0][:STEPS * BATCH].astype(np.int64),
                    data[1][:STEPS * BATCH].astype(np.int64))
    with local_cluster(n_servers=1):
        hyb = ncf.Trainer("cpu", data, BATCH, comm_mode="Hybrid",
                          ps_options=dict(prefetch=False), **MODEL)
        rt = hyb.ex.ps_runtime
        tables = {q.node.name: q for q in rt.params.values() if q.sparse}
        assert sorted(tables) == ["item_embed", "user_embed"]
        on_device = sorted(n.name for n in hyb.ex.param_nodes)
        assert on_device == ["W1", "W2", "W3", "W_out"]
        t0 = {k: rt.pull_sparse_rows(q, np.arange(q.node.shape[0]))
              for k, q in tables.items()}
        d0 = {n.name: hyb.param(n).clone() for n in hyb.ex.param_nodes}
        losses = [float(hyb.step()[0].mean()) for _ in range(STEPS)]
        rt.drain()
        t1 = {k: rt.pull_sparse_rows(q, np.arange(q.node.shape[0]))
              for k, q in tables.items()}
        hyb.ex.close()
    loc = ncf.Trainer("cpu", data, BATCH, **MODEL)
    by_name = {n.name: n for n in loc.ex.param_nodes}
    with torch.no_grad():
        for k, v in t0.items():
            loc.param(by_name[k]).copy_(torch.from_numpy(v))
        for k, v in d0.items():
            loc.param(by_name[k]).copy_(v)
    local = [float(loc.step()[0].mean()) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, local, rtol=1e-5)
    for k, ids in (("user_embed", users), ("item_embed", items)):
        rows = np.unique(ids)
        mine = loc.param(by_name[k]).detach().numpy()
        np.testing.assert_allclose(t1[k][rows], mine[rows], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        # the update itself, on its own scale
        delta, local_delta = t1[k][rows] - t0[k][rows], \
            mine[rows] - t0[k][rows]
        assert np.linalg.norm(delta - local_delta) \
            <= 1e-4 * np.linalg.norm(local_delta), k


def test_main_trains_in_local_mode_on_the_cpu(capsys):
    # one whole epoch of the default data: 100,000 samples, 12 whole batches
    ncf.main(["--gpu", "-1", "--batch-size", "8192"])
    (res,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert res["steps"] == 12 and len(res["losses"]) == 12
    assert np.isfinite(res["losses"]).all()
    assert res["launches_per_step"] == {}           # the CPU: no kernel
