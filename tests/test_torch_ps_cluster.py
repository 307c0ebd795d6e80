"""hetu_tpu_torch's parameter-server roles under its runner, on the CPU.

- Two port workers under ``python -m hetu_tpu_torch.runner -c`` with a
  cluster file of one server train a narrow WDL-Criteo under Hybrid (BSP,
  prefetch off, the dense all-reduce over gloo). Each worker records
  every row push it sends; the server's final rows equal its initial rows
  plus every push of both workers, within 1e-6. The same script under a
  cluster file of one worker, over the whole batch, is the one-process run
  that the two workers are held against: each rank pulls its share's
  rows and pushes their gradients divided by dp, so the two runs' losses,
  final rows, table updates and dense parameters agree.
- ``ctr_main --comm Hybrid`` and ``--comm PS`` train under the runner
  with a cluster file, as a user starts them.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _cluster_file(tmp_path, servers, workers):
    cfg = tmp_path / "cluster.yml"
    cfg.write_text(f"nodes:\n  - host: localhost\n    servers: {servers}\n"
                   f"    workers: {workers}\n    chief: true\n")
    return str(cfg)


WORKER = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.examples import ctr_models

    out = sys.argv[1]
    ht.worker_init()
    ht.mpi_nccl_init(init_nccl=False)
    rank = int(os.environ["WORKER_ID"])
    dense, sparse, y = ctr_models.load_criteo_data(
        feature_dimension=200, n_train=4 * 16, n_test=16)[0]
    loaders = [ht.dataloader_op([ht.Dataloader(x, 16, "train")])
               for x in (dense, sparse, y)]
    loss, _, _, train_op = ctr_models.wdl_criteo(
        *loaders, feature_dimension=200, embedding_size=8, stddev=0.05,
        learning_rate=0.05)
    ex = ht.Executor({"train": [loss, train_op]}, ctx=ht.cpu(0), seed=3,
                     comm_mode="Hybrid", bsp=True, prefetch=False)
    rt = ex.ps_runtime
    (p,) = [q for q in rt.params.values() if q.sparse]
    pushes = []
    push = rt.comm.SparsePush

    def record(node, idx, vals):
        pushes.append((np.array(idx, np.int64), np.array(vals, np.float32)))
        return push(node, idx, vals)

    rt.comm.SparsePush = record
    rows = np.arange(200, dtype=np.int64)
    initial = rt.pull_sparse_rows(p, rows)
    rt.comm.BarrierWorker()          # both have read the initial rows
    losses = [float(ex.run("train", convert_to_numpy_ret_vals=True)[0][0])
              for _ in range(4)]
    ex.close()
    rt.comm.BarrierWorker()          # both have pushed every step
    final = rt.pull_sparse_rows(p, rows)
    dense = {"p/" + name: ex.state["params"][id(n)].numpy()
             for name, n in zip(ex._param_file_names(), ex.param_nodes)
             if id(n) in ex.state["params"]}
    np.savez(out + f".{rank}.npz", initial=initial, final=final,
             losses=np.array(losses), dp=ex.config.dp_size,
             idx=np.concatenate([i for i, _ in pushes]),
             vals=np.concatenate([v for _, v in pushes]), **dense)
    ht.worker_finish()
    ht.mpi_nccl_finish()
""")


def _run_workers(tmp_path, workers):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / "res")
    p = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-c",
         _cluster_file(tmp_path, 1, workers), sys.executable, str(script),
         out],
        cwd=REPO, env=port_env(), capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    res = [dict(np.load(f"{out}.{r}.npz")) for r in range(workers)]
    assert all(int(r["dp"]) == workers for r in res)  # the dense all-reduce
    return res


@pytest.fixture(scope="module")
def two_workers(tmp_path_factory):
    return _run_workers(tmp_path_factory.mktemp("two"), 2)


def test_two_workers_push_every_row_gradient(two_workers):
    res = two_workers
    assert np.array_equal(res[0]["initial"], res[1]["initial"])
    assert np.array_equal(res[0]["final"], res[1]["final"])
    for r in res:
        assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 4
    want = res[0]["initial"].astype(np.float64)
    for r in res:
        np.add.at(want, r["idx"], r["vals"].astype(np.float64))
    np.testing.assert_allclose(res[0]["final"], want, rtol=0, atol=1e-6)
    assert not np.array_equal(res[0]["final"], res[0]["initial"])


def test_two_workers_match_one_worker_over_the_whole_batch(
        two_workers, tmp_path):
    (one,) = _run_workers(tmp_path, 1)
    two = two_workers[0]
    assert np.array_equal(one["initial"], two["initial"])
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(two["final"], one["final"], rtol=1e-4,
                               atol=1e-5)
    # the update is small beside the rows: hold it on its own scale, so a
    # push off by a factor (a missing or doubled /dp) cannot pass
    upd1, upd2 = one["final"] - one["initial"], two["final"] - two["initial"]
    assert np.abs(upd1).max() > 0
    assert np.abs(upd2 - upd1).max() <= 1e-3 * np.abs(upd1).max()
    names = sorted(k for k in one if k.startswith("p/"))
    assert names and names == sorted(k for k in two if k.startswith("p/"))
    for k in names:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-4, atol=1e-5)


def _ctr_main(tmp_path, *args):
    p = subprocess.run(
        [sys.executable, "-m", "hetu_tpu_torch.runner", "-c",
         _cluster_file(tmp_path, 1, 1), sys.executable, "-m",
         "hetu_tpu_torch.examples.ctr_main", "--dim", "500", "--steps", "6",
         "--batch-size", "32", "--gpu", "-1", *args],
        cwd=REPO, env=port_env(), capture_output=True, text=True,
        timeout=240)
    assert p.returncode == 0, p.stderr[-4000:]
    return [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]


def test_ctr_main_trains_hybrid_and_ps_under_the_runner(tmp_path):
    epoch, summary = _ctr_main(tmp_path, "--comm", "Hybrid", "--bsp")
    assert epoch["steps"] == 6 and np.isfinite(epoch["losses"]).all()
    assert summary["vocab"] == [[500, 128]]
    ps = summary["ps"]
    assert ps["async_pushes"] == 6 and ps["prefetch_hits"] == 5
    epoch, summary = _ctr_main(tmp_path, "--comm", "PS", "--cache", "LFUOpt")
    assert epoch["steps"] == 6 and np.isfinite(epoch["losses"]).all()
    # under PS a step pushes the table and WDL's four dense weights
    assert summary["ps"]["async_pushes"] == 6 * 5
    assert summary["ps"]["prefetch_hits"] == 5


def _fake_server(code):
    def spawn(idx, base_env, stopfile, port="0"):
        return subprocess.Popen([sys.executable, "-c", code])
    return spawn


def test_a_cluster_that_does_not_come_up_raises_naming_the_role(
        monkeypatch):
    """A server that exits before the worker registers, and one that never
    registers: ``local_cluster`` raises within its deadline, names the
    role, and reaps every process."""
    from hetu_tpu_torch import ps
    from hetu_tpu_torch.ps import local_cluster as lc
    spawned = []
    real_role = lc.spawn_light_role

    def role(*a, **k):
        spawned.append(real_role(*a, **k))
        return spawned[-1]

    monkeypatch.setattr(lc, "spawn_light_role", role)
    for code, startup_s, match in (
            ("raise SystemExit(3)", 60.0, "server 0 exited with code 3"),
            ("import time; time.sleep(600)", 2.0, "within 2 s")):
        monkeypatch.setattr(lc, "spawn_light_server", _fake_server(code))
        env = {k: os.environ.get(k) for k in ("DMLC_PS_ROOT_URI",
                                              "DMLC_PS_ROOT_PORT")}
        with pytest.raises(RuntimeError, match=match):
            with lc.local_cluster(n_servers=1, startup_s=startup_s):
                pass
        assert ps._worker is None
        assert all(p.poll() is not None for p in spawned)
        assert {k: os.environ.get(k) for k in env} == env   # restored
