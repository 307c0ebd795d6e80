"""The CTR slice as a whole: the five models of ``examples/ctr`` trained
through hetu_tpu_torch against hetu_tpu, step for step, on the CPU.

The sizes are ``tests/test_ctr_models.py``'s: vocabulary 500, embedding
16, batch 32, the seeded synthetic data; WDL-Criteo with the stddev and
learning rate that test gives it. The JAX model functions come from
``examples/ctr/models`` through ``conftest.import_example_models``, the
port's from ``hetu_tpu_torch.examples.ctr_models``. The JAX executor's
initial state is written with its ``Executor.save`` and read into the
port with ``Executor.load``. Per-step losses agree within rtol 1e-5 and
the final parameters within rtol 1e-4 / atol 1e-5: the embedding
gradient sums an id's rows in sorted order (the JAX side scatter-adds
them in XLA's order) and the dense products sum in another order too
(ATen against Eigen), and the difference compounds over 20 updates.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import hetu_tpu as jt
from hetu_tpu import metrics as jmetrics
from hetu_tpu_torch import metrics as tmetrics
from hetu_tpu_torch.examples import ctr_main, ctr_models
from hetu_tpu_torch.kernels import registry as treg
from conftest import import_example_models
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
DIM, EMB, BATCH, STEPS = 500, 16, 32, 20
# as tests/test_ctr_models.py trains WDL-Criteo
KWARGS = {"wdl_criteo": dict(stddev=0.06, learning_rate=0.05)}
# embedding tables and SGD applies per step
TABLES = {"wdl_criteo": 1, "dfm_criteo": 2, "dcn_criteo": 1, "dc_criteo": 1,
          "wdl_adult": 8}


def _data(model, steps):
    if model == "wdl_adult":
        return ctr_models.load_adult_data(n_train=steps * BATCH, n_test=64)
    return ctr_models.load_criteo_data(feature_dimension=DIM,
                                       n_train=steps * BATCH, n_test=64)


def _reference(model, data, **ex_kw):
    """The JAX model on ``test_ctr_models.py``'s loaders (train only)."""
    models = import_example_models("ctr")
    (train, _) = data

    def loader(x):
        return jt.dataloader_op([jt.Dataloader(x, BATCH, "train")])

    if model == "wdl_adult":
        loss, _, _, train_op = models.wdl_adult(
            [loader(x) for x in train[0]], loader(train[1]),
            loader(train[2]))
    else:
        loss, _, _, train_op = getattr(models, model)(
            *(loader(x) for x in train), feature_dimension=DIM,
            embedding_size=EMB, **KWARGS.get(model, {}))
    return jt.Executor({"train": [loss, train_op]}, ctx=jt.cpu(0), seed=42,
                       **ex_kw)


def _port(model, data):
    kw = {} if model == "wdl_adult" else dict(embedding_size=EMB,
                                               **KWARGS.get(model, {}))
    return ctr_main.Trainer("cpu", model, batch_size=BATCH, dim=DIM,
                            seed=1, data=data, **kw)


def _params(ex, to_np):
    return {name: to_np(ex.state["params"][id(n)])
            for name, n in zip(ex._param_file_names(), ex.param_nodes)}


@pytest.mark.parametrize("model", ctr_main.MODELS)
def test_model_matches_reference(model, tmp_path):
    data = _data(model, STEPS)
    jex = _reference(model, data)
    tr = _port(model, data)
    jex.save(str(tmp_path))          # state before step 1
    tr.ex.load(str(tmp_path))
    treg.reset_stats()
    treg.reset_launch_counts()
    want = np.array([float(np.mean(jex.run(
        "train", convert_to_numpy_ret_vals=True)[0])) for _ in range(STEPS)])
    got = np.array([float(tr.step()[0]) for _ in range(STEPS)])
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    # tests/test_ctr_models.py asserts that each model learns: the mean of
    # the last 5 losses below that of the first 5
    assert got[-5:].mean() < got[:5].mean(), got
    jp = _params(jex, np.asarray)
    pp = _params(tr.ex, lambda t: t.detach().cpu().numpy())
    assert sorted(pp) == sorted(jp)
    for name in jp:
        np.testing.assert_allclose(pp[name], jp[name], **STATE_TOL,
                                   err_msg=name)
    # on the CPU every table gradient took the plain segment sum, every
    # update the plain SGD, all parameters as one group a step
    assert treg.launch_counts() == dict.fromkeys(treg.launch_counts(), 0)
    assert treg.dispatch_stats() == {
        ("fused_embed_grad", "plain"): TABLES[model] * STEPS,
        ("fused_sgd", "plain"): STEPS}


def test_the_ports_data_is_the_reference():
    models = import_example_models("ctr")
    for got, want in zip(
            ctr_models.load_criteo_data(feature_dimension=DIM, n_train=64,
                                        n_test=32),
            models.load_data.load_criteo_data(feature_dimension=DIM,
                                              n_train=64, n_test=32)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = ctr_models.load_adult_data(n_train=64, n_test=32)
    want = models.load_data.load_adult_data(n_train=64, n_test=32)
    for g, w in zip(got[0][0] + list(got[0][1:]),
                    want[0][0] + list(want[0][1:])):
        np.testing.assert_array_equal(g, w)


def test_auc_matches_the_reference():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, 500).astype(np.float32)
    preds = np.clip(labels * 0.3 + rng.rand(500) * 0.7, 0, 1)
    assert tmetrics.auc(labels, preds) == jmetrics.auc(labels, preds)
    assert tmetrics.auc(labels, preds, curve="PR") == jmetrics.auc(
        labels, preds, curve="PR")
    with pytest.warns(UserWarning):
        assert np.isnan(tmetrics.auc(np.ones(4), np.ones(4) * 0.5))


def test_ctr_main_trains_on_the_cpu_and_launches_nothing(monkeypatch):
    rows = list(ctr_main.run("cpu", "wdl_criteo", batch_size=32, dim=DIM,
                             nepoch=2, steps=6, val=True))
    epochs, summary = rows[:-1], rows[-1]
    assert [r["epoch"] for r in epochs] == [0, 1]
    for r in epochs:
        assert r["steps"] == 6 and len(r["losses"]) == 6
        assert np.isfinite(r["losses"]).all()
        assert 0.0 <= r["train_acc"] <= 1.0 and 0.0 <= r["train_auc"] <= 1.0
        assert r["launches"] == {} and r["launches_same_every_step"]
        assert {"val_loss", "val_acc", "val_auc"} <= set(r)
    assert summary["vocab"] == [(DIM, 128)]
    assert summary["batch_size"] == 32 and summary["launches_per_step"] == {}
    # the PS modes train against a cluster (tests/test_torch_ps_cluster.py
    # runs them under the runner); without one they say how to start it
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    for mode in ("Hybrid", "PS"):
        with pytest.raises(SystemExit, match="servers:"):
            ctr_main.main(["--comm", mode, "--gpu", "-1"])


def test_gradients_probe_sees_the_first_batch_under_either_mode():
    """``Trainer.gradients`` evaluates the first training batch each time,
    under the mode asked for, and leaves the executor's mode as it was."""
    tr = _port("wdl_criteo", _data("wdl_criteo", 4))
    loss_a, g_a = tr.gradients()
    loss_b, g_b = tr.gradients(kernels="off")
    assert tr.ex.config.kernels == treg.resolve_mode(None)
    assert float(loss_a) == float(loss_b)
    assert sorted(g_a) == sorted(p.name for p in tr.params)
    for k in g_a:
        assert np.array_equal(g_a[k].numpy(), g_b[k].numpy()), k
    assert tr.ex.state["step"] == 0
    assert float(tr.step()[0]) == float(loss_a)


def test_a_cpu_ctr_step_loads_neither_jax_nor_hetu_tpu():
    script = textwrap.dedent("""
        import sys
        from hetu_tpu_torch.examples import ctr_main
        rows = list(ctr_main.run("cpu", "dfm_criteo", batch_size=32,
                                 dim=500, steps=2))
        assert len(rows) == 2, rows
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hetu_tpu",
                                            "models"))
        print("LOADED", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert "LOADED []" in p.stdout, p.stdout


# --comm AllReduce: two gloo ranks of the port's Trainer (port imports
# only, a file store in tmp_path), each from the JAX executor's saved
# initial state, against the JAX executor's AllReduce run on its 8-device
# mesh; the first of each model's batches is cut into two shares.
DP_MODELS, DP_STEPS = ("wdl_criteo", "dfm_criteo", "wdl_adult"), 6
DP_WORKER = r'''
import json
import sys
import numpy as np
import hetu_tpu_torch as ht
from hetu_tpu_torch.examples import ctr_main, ctr_models
from hetu_tpu_torch.parallel import multihost

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 2, rank, device="cpu")
out = {}
for model in spec["models"]:
    if model == "wdl_adult":
        data = ctr_models.load_adult_data(n_train=spec["n"], n_test=64)
        kw = {}
    else:
        data = ctr_models.load_criteo_data(feature_dimension=spec["dim"],
                                           n_train=spec["n"], n_test=64)
        kw = dict(embedding_size=spec["emb"], **spec["kwargs"].get(model, {}))
    tr = ctr_main.Trainer("cpu", model, batch_size=spec["batch"],
                          dim=spec["dim"], seed=1, data=data,
                          comm_mode="AllReduce", **kw)
    tr.ex.load(spec["init"] + "/" + model)
    out[model + "/losses"] = np.array(
        [float(tr.step()[0]) for _ in range(spec["steps"])])
    for name, n in zip(tr.ex._param_file_names(), tr.ex.param_nodes):
        out[model + "/p/" + name] = tr.ex.state["params"][id(n)].numpy()
multihost.shutdown()
np.savez(sys.argv[4], **out)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "hetu_tpu")]
'''


def test_ctr_allreduce_two_ranks_match_jax_on_eight_devices(tmp_path):
    import jax
    from test_torch_quant_comm import run_ranks
    assert jax.device_count() == 8
    want = {}
    for model in DP_MODELS:
        data = _data(model, DP_STEPS)
        jex = _reference(model, data, comm_mode="AllReduce")
        jex.save(str(tmp_path / "init" / model))
        losses = np.array([float(np.mean(jex.run(
            "train", convert_to_numpy_ret_vals=True)[0]))
            for _ in range(DP_STEPS)])
        want[model] = (losses, _params(jex, np.asarray))
    spec = dict(models=DP_MODELS, n=DP_STEPS * BATCH, dim=DIM, emb=EMB,
                batch=BATCH, steps=DP_STEPS, kwargs=KWARGS,
                init=str(tmp_path / "init"))
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    ranks = [dict(np.load(o)) for o in run_ranks(tmp_path, DP_WORKER,
                                                 tmp_path / "spec.json")]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for model, (losses, params) in want.items():
        got = ranks[0]
        np.testing.assert_allclose(got[model + "/losses"], losses,
                                   **LOSS_TOL, err_msg=model)
        assert sorted(k.split("/p/")[1] for k in got
                      if k.startswith(model + "/p/")) == sorted(params)
        for name, v in params.items():
            np.testing.assert_allclose(got[f"{model}/p/{name}"], v,
                                       **STATE_TOL, err_msg=name)


def test_ctr_main_allreduce_under_the_runner():
    """``ctr_main --comm AllReduce`` on two gloo ranks through the port's
    runner, end to end: rank 0 prints the epoch and the summary."""
    from test_torch_quant_comm import port_env
    p = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-w", "2",
         sys.executable, "-m", "hetu_tpu_torch.examples.ctr_main", "--comm",
         "AllReduce", "--gpu", "-1", "--dim", str(DIM), "--steps", "2",
         "--batch-size", str(BATCH)], capture_output=True, text=True,
        timeout=300, env=port_env(), cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]
    assert [r.get("epoch") for r in rows] == [0, None]
    assert rows[0]["steps"] == 2 and np.isfinite(rows[0]["losses"]).all()
    assert rows[1]["summary"] == "ctr_main"


def parity_report():
    """The measured distances behind the tolerances above:
    ``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_ctr.py``
    prints, per model, the max relative per-step loss difference over 20
    steps and the max absolute difference of the parameters after them."""
    import tempfile
    for model in ctr_main.MODELS:
        data = _data(model, STEPS)
        jex, tr = _reference(model, data), _port(model, data)
        with tempfile.TemporaryDirectory() as d:
            jex.save(d)
            tr.ex.load(d)
        want = np.array([float(np.mean(jex.run(
            "train", convert_to_numpy_ret_vals=True)[0]))
            for _ in range(STEPS)])
        got = np.array([float(tr.step()[0]) for _ in range(STEPS)])
        jp = _params(jex, np.asarray)
        pp = _params(tr.ex, lambda t: t.detach().cpu().numpy())
        param = max(float(np.max(np.abs(pp[k] - jp[k]))) for k in jp)
        print(f"{model:10s} loss {want[0]:.4f} -> {want[-1]:.4f}, loss max "
              f"rel {np.max(np.abs(got - want) / want):.2e}, params max abs "
              f"{param:.2e}")


if __name__ == "__main__":
    parity_report()
